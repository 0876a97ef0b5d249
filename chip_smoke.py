#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. the card's name and power limit, and the kernel build time (every
     CUDA source of the port is compiled here, in parallel);
  2. each hand-written kernel against its plain PyTorch version on the
     card (N = 8192) at every level of configs/mlp.yml (0-5) and of
     configs/lenet.yml (0-7, 4 digits at levels 6-7), the transforms also
     batched over two polys as rescale_poly gives them, ks_finish with
     full-chain and trimmed keys, Shoup and lean, and the PallasNTT
     counterpart (crypto/ntt_pallas.py) over chosen limb rows: all must be
     bit-exact (torch.equal); ms per call for both;
  3. the full-width MLP 784-128-128-10 on configs/mlp.yml through the
     user entry points on `cuda`: MAE vs cleartext < 0.005, every kernel
     launched during the encrypted forward, first and steady latency; the
     same flow with device="cpu" (plain path) must give equal output
     ciphertexts;
  4. the full-width LeNet on configs/lenet.yml the same way, with the
     host seconds of fit and compile, the rotation keys made and the peak
     device memory;
  5. one JSON line per path, one JSON line describing each kernel, the
     card's line, then the result line.

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
CONFIGS = {"mlp": ROOT / "configs" / "mlp.yml",
           "lenet": ROOT / "configs" / "lenet.yml"}
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

def check_kernels(cfg, tag, stats):
    """Every kernel at every level of one config; records go to `stats`
    (kernel -> list of per-case records)."""
    from orion_tpu_torch.crypto import CKKSContext, KeyChest
    from orion_tpu_torch.crypto.keyswitch import RingRows, dev_level
    from orion_tpu_torch.crypto.ntt_pallas import PallasNTT
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
        print(f"  {tag:5s} {name:12s} level {level} {label:34s} "
              f"bit-exact={ok} ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"bound_ms={b:.5f} ({by})", flush=True)
        stats.setdefault(name, []).append(dict(
            config=tag, level=level, label=f"{tag} level {level} {label}",
            ok=ok, err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
            bound_by=by))
        if not ok:
            fail(f"{name} {label} differs from its plain version "
                 f"(max abs err {err})")

    print(f"phase 2: kernels vs plain PyTorch on the card, configs/{tag}.yml "
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

    # the PallasNTT counterpart (crypto/ntt_pallas.py), over the limb rows
    # tests/crypto/test_ntt_pallas.py uses and over the whole chain batched
    # as tests/crypto/test_ks_pallas.py runs pallas_ntt4
    pn = PallasNTT(ctx)
    top = ctx.max_level
    for rows, batch in (([0, 1], ()), (list(range(ctx.n_all)), (2,))):
        rr = RingRows.from_ctx(ctx, rows)
        a = residues(batch + (len(rows), n), rr.p)
        label = f"PallasNTT rows {rows[0]}-{rows[-1]} {batch + (len(rows), n)}"
        case("ntt_fwd", top, label, lambda: pn.ntt(a, rows),
             lambda: kntt.ntt_fwd_plain(a, rr),
             ntt_work(a.numel() // n, len(rows), n))
        case("ntt_inv", top, label, lambda: pn.intt(a, rows),
             lambda: kntt.ntt_inv_plain(a, rr),
             ntt_work(a.numel() // n, len(rows), n))


# ------------------------------------------------------------------ #
#  Phases 3-4: a network through the user entry points              #
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


def run_model(cfg, model, device, params=None, steady=0):
    """init_scheme -> fit -> compile -> encode -> encrypt -> he forward ->
    decrypt of `models.<model>` on one device; launch counts of the first
    forward (counts set to 0 just before it)."""
    import orion_tpu_torch as orion
    from orion_tpu_torch import kernels, models
    from orion_tpu_torch.utils import get_mnist_datasets, mae

    scheme = orion.init_scheme(cfg, device=device)
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    net = getattr(models, model)()
    if params is not None:
        models.load_jax_params(net, params)
    inp, _ = next(iter(testloader))
    net.eval()
    out_clear = net(inp).numpy().reshape(-1)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    orion.fit(net, trainloader)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    input_level = orion.compile(net)
    sync()
    compile_s = time.perf_counter() - t0
    ct = orion.encrypt(orion.encode(inp, input_level))
    net.he()

    dev_mib = None
    if cuda:
        dev_mib = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net(ct)
    sync()
    first_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_level = kernels.launch_counts_by_level()
    steady_s = []
    for _ in range(steady):
        t0 = time.perf_counter()
        net(ct)
        sync()
        steady_s.append(time.perf_counter() - t0)
    prof = profile_forward(net, ct) if cuda else None
    out_fhe = out.decrypt().decode().reshape(-1)[: out_clear.size]
    err = mae(out_clear, out_fhe)
    state = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    return dict(
        out=out, mae=err, first_s=first_s, steady_s=steady_s, counts=counts,
        by_level=by_level,
        params=state, level=input_level, prof=prof, fit_s=fit_s,
        compile_s=compile_s, in_cts=len(ct.cts),
        rotations=len(scheme.lt_evaluator.generated_rotations),
        key_packs=len(scheme.evaluator._key_packs),
        peak_mib=(torch.cuda.max_memory_allocated() / 2 ** 20 if cuda
                  else None),
        dev_mib=dev_mib)


def check_model(cfg, model, title):
    """One path on cuda, then on cpu with the same weights: MAE, launches,
    equal output ciphertexts.  Returns the path's JSON record."""
    print(f"{title}, device cuda", flush=True)
    gpu = run_model(cfg, model, "cuda", steady=3)
    steady_ms = [s * 1e3 for s in gpu["steady_s"]]
    print(f"  input level {gpu['level']} ({gpu['in_cts']} ciphertext(s)); "
          f"MAE vs cleartext {gpu['mae']:.3e}; first forward "
          f"{gpu['first_s'] * 1e3:.1f} ms; steady forward "
          f"{', '.join(f'{s:.1f}' for s in steady_ms)} ms", flush=True)
    print(f"  host: fit {gpu['fit_s']:.2f} s, compile {gpu['compile_s']:.2f} "
          f"s; rotation keys {gpu['rotations']}, key packs "
          f"{gpu['key_packs']}; device memory after compile "
          f"{gpu['dev_mib']:.0f} MiB, peak over the forwards "
          f"{gpu['peak_mib']:.0f} MiB", flush=True)
    print(f"  launches in one forward: {gpu['counts']}; key-switch kernels "
          f"by level: {gpu['by_level']}", flush=True)
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
        fail(f"{model}: MAE {gpu['mae']} >= 0.005")
    idle = [k for k, v in gpu["counts"].items() if v == 0]
    if idle:
        fail(f"kernels not launched by the {model} forward: {idle}")

    print(f"{title}, the same flow on device cpu (plain PyTorch path)",
          flush=True)
    t0 = time.perf_counter()
    cpu = run_model(cfg, model, "cpu", params=gpu["params"])
    print(f"  cpu flow {time.perf_counter() - t0:.1f} s; fit "
          f"{cpu['fit_s']:.2f} s, compile {cpu['compile_s']:.2f} s, forward "
          f"{cpu['first_s']:.1f} s; MAE {cpu['mae']:.3e}", flush=True)
    if len(cpu["out"].cts) != len(gpu["out"].cts):
        fail(f"{model}: output ciphertext counts differ between cuda and cpu")
    for a, b in zip(gpu["out"].cts, cpu["out"].cts):
        if not (a.level == b.level and a.scale == b.scale
                and torch.equal(a.data.cpu(), b.data)):
            fail(f"{model}: cuda and cpu output ciphertexts differ")
    print("  cuda and cpu output ciphertexts are equal", flush=True)
    return {"first_ms": gpu["first_s"] * 1e3, "steady_ms": steady_ms,
            "mae": gpu["mae"], "launches": gpu["counts"],
            "launches_by_level": gpu["by_level"], "fit_s": gpu["fit_s"], "compile_s": gpu["compile_s"],
            "rotation_keys": gpu["rotations"], "key_packs": gpu["key_packs"],
            "peak_device_mib": gpu["peak_mib"],
            "cpu_forward_s": cpu["first_s"], "profile": gpu["prof"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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

    cfgs = {}
    for tag, path in CONFIGS.items():
        with open(path) as f:
            cfgs[tag] = yaml.safe_load(f)
    stats = {}
    for tag, cfg in cfgs.items():
        check_kernels(cfg, tag, stats)

    paths = {
        "mlp": check_model(cfgs["mlp"], "MLP",
                           "phase 3: MLP 784-128-128-10 on configs/mlp.yml"),
        "lenet": check_model(cfgs["lenet"], "LeNet",
                             "phase 4: LeNet on configs/lenet.yml"),
    }

    line = []
    for k in kernels.KERNELS:
        recs = stats[k.name]
        # the first case at the top level of this slice's config: the 2-D
        # transforms, full-chain Shoup keys for ks_finish
        top = next(r for r in recs if r["config"] == "lenet"
                   and r["level"] == 7)
        by_path = {p: rec["launches"][k.name] for p, rec in paths.items()}
        line.append({
            "name": k.name, "route": "cuda",
            "source": f"orion_tpu_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["err"] for r in recs),
            "bit_exact": all(r["ok"] for r in recs),
            "cases": len(recs),
            "shape": top["label"],
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
        })
    for p, rec in paths.items():
        print(json.dumps({p: rec}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
