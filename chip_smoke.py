#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit, and the kernel build time (every
     CUDA source of the port is compiled here, in parallel);
  2. each hand-written kernel against its plain PyTorch version on the
     card, at the MLP's shapes (configs/mlp.yml, N = 8192) at every level
     0-5, the transforms also batched over two polys as rescale_poly
     gives them, ks_finish with full-chain and trimmed keys, Shoup and
     lean: all must be bit-exact (torch.equal); ms per call for both;
  3. the full-width MLP 784-128-128-10 on configs/mlp.yml through the
     user entry points on `cuda`: MAE vs cleartext < 0.005, every kernel
     launched during the encrypted forward, first and steady latency; the
     same flow with device="cpu" (plain path) must give equal output
     ciphertexts;
  4. one JSON line describing each kernel, then the result line.

Imports only torch, numpy, yaml and orion_tpu_torch.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "mlp.yml"
MEM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# 32-bit integer multiplies (IMAD, IMAD.HI) per second: 64 per clock per SM
# on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput) x 132 SMs x 1.98 GHz boost; a quarter of the data
# sheet's 67 TFLOP/s float32, which counts 128 lanes and 2 flops per FMA
OP_RATE = 64 * 132 * 1.98e9


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters):
    """Mean device ms per call over `iters` calls after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ #
#  Work of one kernel call, for its bound                            #
# ------------------------------------------------------------------ #
# bytes: each input (residues, keys, twiddle tables) read once and each
# output written once, int64; ops: 32-bit integer multiplies (3 per Shoup
# product, 4 per Montgomery product), against the card's IMAD rate.

def ntt_work(rows, table_rows, n):
    """`rows` transformed rows over `table_rows` rows of twiddles."""
    logn = n.bit_length() - 1
    nbytes = 8 * rows * n * 2 + 8 * table_rows * n * 2   # data + tw, tw_sh
    ops = 3 * rows * (n // 2) * logn + 3 * rows * n
    return nbytes, ops


def decompose_work(nl, n_t, dnum, alpha, n):
    logn = n.bit_length() - 1
    nbytes = 8 * n * (nl + dnum * n_t + 2 * nl + 2 * n_t)
    ops = (3 * nl * (n // 2) * logn + 3 * nl * n
           + dnum * n_t * n * (6 * alpha + 3)
           + 3 * dnum * n_t * (n // 2) * logn)
    return nbytes, ops


def finish_work(nl, n_t, dnum, n, lean):
    logn = n.bit_length() - 1
    n_sp = n_t - nl
    key_words = dnum * 2 * n_t * n * (1 if lean else 2)
    nbytes = 8 * (dnum * n_t * n + key_words + 2 * nl * n
                  + 2 * n_sp * n + 2 * nl * n)
    ops = (2 * dnum * n_t * n * (7 if lean else 3)
           + 2 * n_sp * (3 * (n // 2) * logn + 3 * n)
           + 2 * nl * n * (6 * n_sp + 3)
           + 2 * nl * (3 * (n // 2) * logn + 3 * n))
    return nbytes, ops


def bound(work):
    nbytes, ops = work
    t_mem, t_op = nbytes / MEM_RATE * 1e3, ops / OP_RATE * 1e3
    return (t_mem, "bytes") if t_mem >= t_op else (t_op, "operations")


# ------------------------------------------------------------------ #
#  Phase 2: kernels against their plain versions                     #
# ------------------------------------------------------------------ #

def check_kernels(cfg):
    from orion_tpu_torch.crypto import CKKSContext, KeyChest
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import keyswitch as kks
    from orion_tpu_torch.kernels import ntt as kntt
    from orion_tpu_torch.runtime.config import parse_config

    p = parse_config(cfg)
    ctx = CKKSContext(logn=p.logn, logq=p.split_logq, logp=p.logp,
                      logscale=p.logscale, h=p.h, seed=p.seed,
                      device="cuda")
    keys = KeyChest(ctx)
    rk = keys.relin_key
    rng = np.random.default_rng(7)
    n = ctx.n
    stats = {}   # kernel -> list of per-case records

    def residues(shape, rr_p):
        hi = rr_p.cpu().numpy()[:, None]
        x = rng.integers(0, 1 << 62, size=shape, dtype=np.int64)
        return torch.as_tensor(x % hi, device="cuda")

    def case(name, level, label, kernel_fn, plain_fn, work, iters=50):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        ok = torch.equal(got, want)
        ms = cuda_ms(kernel_fn, iters)
        plain_ms = cuda_ms(plain_fn, 3)
        b, by = bound(work)
        print(f"  {name:13s} level {level} {label:36s} bit-exact={ok} "
              f"ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={b:.5f} ({by})",
              flush=True)
        stats.setdefault(name, []).append(dict(
            level=level, label=f"level {level} {label}", ok=ok, err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by))
        if not ok:
            fail(f"{name} {label} differs from its plain version "
                 f"(max abs err {err})")

    print("phase 2: kernels vs plain PyTorch on the card "
          f"(N={n}, levels 0-{ctx.max_level})", flush=True)
    for level in range(ctx.max_level + 1):
        dl = dev_level(ctx, level)
        nl = level + 1
        n_t = dl.t.p.shape[0]
        dnum = len(dl.digits)
        # the transforms at the shapes the MLP gives them: the fused
        # drop's inverse NTT over [specials, q_l] and forward NTT over
        # q_0..q_{l-1}; at level 0 (no drop) the level's Q rows
        if dl.dropdown is not None:
            inv_rr = dl.kernel_tables["drop_rows"]
            fwd_rr = dl.q.rows(0, level)
        else:
            inv_rr = fwd_rr = dl.q
        # ... and batched over a ciphertext's two polys, as rescale_poly
        # gives them: the inverse over the last Q row, the forward over the
        # rows below it (level 0 never rescales: its single Q row)
        if level >= 1:
            inv_b, fwd_b = dl.q.rows(level, level + 1), dl.q.rows(0, level)
        else:
            inv_b = fwd_b = dl.q
        for kname, plain, rr, batch in (
                ("ntt_fwd", kntt.ntt_fwd_plain, fwd_rr, ()),
                ("ntt_inv", kntt.ntt_inv_plain, inv_rr, ()),
                ("ntt_fwd", kntt.ntt_fwd_plain, fwd_b, (2,)),
                ("ntt_inv", kntt.ntt_inv_plain, inv_b, (2,))):
            rows = rr.p.shape[0]
            a = residues(batch + (rows, n), rr.p)
            kern = getattr(kntt, kname)
            case(kname, level, str(batch + (rows, n)),
                 lambda: kern(a, rr), lambda: plain(a, rr),
                 ntt_work(a.numel() // n, rows, n))
        c = residues((nl, n), dl.q.p)
        alpha = max(dg.src_hi - dg.src_lo for dg in dl.digits)
        case("ks_decompose", level, f"({nl}, {n})",
             lambda: kks.ks_decompose(c, dl),
             lambda: kks.ks_decompose_plain(c, dl),
             decompose_work(nl, n_t, dnum, alpha, n))
        ext = kks.ks_decompose(c, dl)
        rows = dl.ksk_rows_idx
        trim = rk.data[:dnum][:, :, rows].contiguous()
        trim_sh = rk.shoup[:dnum][:, :, rows].contiguous()
        for label, kd, ks, trimmed in (
                ("full-chain Shoup", rk.data, rk.shoup, False),
                ("full-chain lean", rk.data, None, False),
                ("trimmed Shoup", trim, trim_sh, True),
                ("trimmed lean", trim, None, True)):
            case("ks_finish", level, label,
                 lambda: kks.ks_finish(ext, dl, kd, ks, trimmed),
                 lambda: kks.ks_finish_plain(ext, dl, kd, ks, trimmed),
                 finish_work(nl, n_t, dnum, n, ks is None))
    return stats


# ------------------------------------------------------------------ #
#  Phase 3: the MLP through the user entry points                    #
# ------------------------------------------------------------------ #

OUR_KERNELS = ("ntt_fwd_rows", "ntt_inv_rows", "fbc_ntt_digits",
               "ks_inner_intt", "moddown_rows")


def profile_forward(net, ct):
    """Device time of one steady forward by kernel (torch.profiler), the
    share spent in the port's kernels, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        net(ct)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += 1
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    dev_ms = sum(by_name.values())
    ours = sum(v for k, v in by_name.items()
               if any(o in k for o in OUR_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, device_ms=dev_ms, our_kernels_ms=ours,
                device_ops=n_kernels,
                busy_share=dev_ms / wall_ms if wall_ms else None,
                top=[(k[:60], v) for k, v in top])


def run_mlp(cfg, device, params=None, steady=0):
    import orion_tpu_torch as orion
    from orion_tpu_torch import kernels, models
    from orion_tpu_torch.utils import get_mnist_datasets, mae

    orion.init_scheme(cfg, device=device)
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    net = models.MLP()
    if params is not None:
        models.load_jax_params(net, params)
    inp, _ = next(iter(testloader))
    net.eval()
    out_clear = net(inp).numpy().reshape(-1)
    orion.fit(net, trainloader)
    input_level = orion.compile(net)
    ct = orion.encrypt(orion.encode(inp, input_level))
    net.he()

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net(ct)
    sync()
    first_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    steady_s = []
    for _ in range(steady):
        t0 = time.perf_counter()
        net(ct)
        sync()
        steady_s.append(time.perf_counter() - t0)
    prof = profile_forward(net, ct) if device == "cuda" else None
    out_fhe = out.decrypt().decode().reshape(-1)[: out_clear.size]
    err = mae(out_clear, out_fhe)
    state = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    return dict(out=out, mae=err, first_s=first_s, steady_s=steady_s,
                counts=counts, params=state, level=input_level, prof=prof)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from orion_tpu_torch import kernels
    from orion_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"phase 1: device {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)})", flush=True)

    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    stats = check_kernels(cfg)

    print("phase 3: MLP 784-128-128-10 on configs/mlp.yml, device cuda",
          flush=True)
    gpu = run_mlp(cfg, "cuda", steady=3)
    steady_ms = [s * 1e3 for s in gpu["steady_s"]]
    print(f"  input level {gpu['level']}; MAE vs cleartext {gpu['mae']:.3e}; "
          f"first forward {gpu['first_s'] * 1e3:.1f} ms; steady forward "
          f"{', '.join(f'{s:.1f}' for s in steady_ms)} ms", flush=True)
    print(f"  launches in one forward: {gpu['counts']}", flush=True)
    pr = gpu["prof"]
    if not pr["device_ops"]:
        print("  profiled forward: the profiler saw no device time "
              "(device breakdown not measured)", flush=True)
    print(f"  profiled forward: wall {pr['wall_ms']:.1f} ms, device "
          f"{pr['device_ms']:.2f} ms in {pr['device_ops']} device ops "
          f"(busy share {pr['busy_share']:.3f}), port kernels "
          f"{pr['our_kernels_ms']:.2f} ms; top: "
          + "; ".join(f"{k} {v:.2f} ms" for k, v in pr["top"]), flush=True)
    if not gpu["mae"] < 0.005:
        fail(f"MAE {gpu['mae']} >= 0.005")
    idle = [k for k, v in gpu["counts"].items() if v == 0]
    if idle:
        fail(f"kernels not launched by the MLP forward: {idle}")

    print("phase 3: the same flow on device cpu (plain PyTorch path)",
          flush=True)
    t0 = time.perf_counter()
    cpu = run_mlp(cfg, "cpu", params=gpu["params"])
    print(f"  cpu flow {time.perf_counter() - t0:.1f} s; forward "
          f"{cpu['first_s']:.1f} s; MAE {cpu['mae']:.3e}", flush=True)
    if len(cpu["out"].cts) != len(gpu["out"].cts):
        fail("output ciphertext counts differ between cuda and cpu")
    for a, b in zip(gpu["out"].cts, cpu["out"].cts):
        if not (a.level == b.level and a.scale == b.scale
                and torch.equal(a.data.cpu(), b.data)):
            fail("cuda and cpu output ciphertexts differ")
    print("  cuda and cpu output ciphertexts are equal", flush=True)

    line = []
    for k in kernels.KERNELS:
        recs = stats[k.name]
        # the first case at the top level: the 2-D transforms, full-chain
        # Shoup keys for ks_finish
        top = next(r for r in recs if r["level"] == recs[-1]["level"])
        line.append({
            "name": k.name, "route": "cuda",
            "source": f"orion_tpu_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": gpu["counts"][k.name],
            "max_abs_err": max(r["err"] for r in recs),
            "bit_exact": all(r["ok"] for r in recs),
            "shape": top["label"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"mlp": {
        "first_ms": gpu["first_s"] * 1e3, "steady_ms": steady_ms,
        "mae": gpu["mae"], "launches": gpu["counts"],
        "profile": gpu["prof"]}}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
