#!/usr/bin/env python3
"""The ConjugateInvariant key-switch kernels before and after their
redesign, on one GPU.

    python3 tools/ci_keyswitch_ab.py --unpack [--parent REV]   (needs git)
    python3 tools/ci_keyswitch_ab.py                           (on the GPU)

`ks_decompose_ci` and `ks_finish_ci` (orion_tpu_torch/kernels/csrc/
ks_decompose.cu, ks_finish.cu) ran one block per row of the 2n lift and
converted every coefficient twice (once for itself, once for its mirror);
they now split each row over a thread-block cluster and convert each
coefficient once (csrc/cluster_ntt.cuh `ntt_fwd_lift`).  `--unpack`
writes `git archive REV` (default 553bf51, the last tree with the
single-block CI forms) to build/ci_ab/parent/; the run on the GPU then
compares four trees:

  parent      build/ci_ab/parent/;
  change      this checkout;
  split_only  a copy of this checkout whose lift converts each mirror
              coefficient again instead of negating the one conversion:
              the cluster split alone;
  once_only   a copy of this checkout with one CTA per row at LogN 13 and
              14 (`Split` and `split_logc` patched, as
              tools/cluster_size_ab.py does): convert-once alone, the lift
              built in the single-block core's shared memory.

Each tree runs in its own process, in the order parent change split_only
once_only once_only split_only change parent, and prints one line
`AB {...}` beside the card's name and power limit: the kernels' CI forms
bit-exact against their plain versions at the top level of a CI ring of
every lift size 2^8 .. 2^14; device ms per call (chip_smoke.py
`device_ms`: calls queued behind a sleep kernel) of ks_decompose_ci and
ks_finish_ci (full-chain Shoup and trimmed lean keys) at every level of
configs/lola.yml and tests/configs/mlp.yml, each held bit for bit against
its plain version; phase 7's LoLA-CI batches at lola level 1 (B = 56 polys
for ks_decompose_ci, 120 items over 15 keys for ks_finish_ci, shared,
paired and grouped by 8 queries).  The parent and change runs also run
LoLA on configs/lola.yml through the user entry points at B = 1 and, via
make_batched_forward, B = 8: the steady wall (median of 5 forwards), the
device time, busy share and key-switch kernels' device ms of one profiled
forward; each batched output must equal its serial forward, and every
output ciphertext must equal the parent's.  Each run also profiles one
call of each kernel at lola level 5 and of the two batches and gives its
device ms by device kernel.  The last lines give each case's mean device
ms per tree.  chip_smoke.py does not call this script.
"""

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ci_ab"
ORDER = ("parent", "change", "split_only", "once_only", "once_only",
         "split_only", "change", "parent")
FULL = ("parent", "change")       # the trees that also run LoLA
# the key-switch kernels' device kernels, both designs
KS_GRIDS = ("ntt_inv_rows", "ntt_inv_cluster", "fbc_ntt_digits",
            "ks_inner_intt", "moddown_rows")
# (file, text, replacement) of each variant; each text must occur once
PATCHES = {
    "split_only": (
        ("kernels/csrc/cluster_ntt.cuh",
         "                if (g == 0) continue;  // input 0 has no mirror\n",
         "                continue;  // no mirror: converted again below\n"),
        ("kernels/csrc/cluster_ntt.cuh",
         "                              ? 0u : mir[(k - H) * W + lc];\n",
         "                              ? 0u : neg_mod(conv(N - (c * W + lc)"
         " - k * M), p);\n")),
    "once_only": (
        ("kernels/csrc/cluster_ntt.cuh", "(LOGN >= 13 ? 3 : LOGN - 10)",
         "(LOGN >= 13 ? 0 : LOGN - 10)"),
        ("kernels/ntt.py", "return 0 if logn <= 10 else min(logn - 10, 3)",
         "return 0 if logn <= 10 or logn >= 13 else logn - 10")),
}
STEADY = 5


def unpack(rev):
    dest = OUT / "parent"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    archive = subprocess.run(["git", "archive", rev], cwd=ROOT,
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", str(dest)], input=archive,
                   check=True)
    print(f"unpacked {rev} to {dest}", flush=True)


def make_variant(name):
    dest = OUT / name
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(ROOT / "orion_tpu_torch", dest / "orion_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text, new in PATCHES[name]:
        path = dest / "orion_tpu_torch" / rel
        body = path.read_text()
        if body.count(text) != 1:
            raise SystemExit(f"{name}: {rel} no longer holds {text!r}")
        path.write_text(body.replace(text, new))
    return dest


def chip_smoke():
    """This checkout's chip_smoke.py (the trees' package is imported from
    the tree the process runs in)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_lifts(cs, cfg):
    """ks_decompose_ci and ks_finish_ci bit-exact against their plain
    versions at the top level of a CI ring of each lift size (the secret's
    Hamming weight cut to 64, which the smallest ring can hold)."""
    import torch

    from orion_tpu_torch.crypto import KeyChest
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import keyswitch as kks

    cfg = {**cfg, "ckks_params": {**cfg["ckks_params"], "H": 64}}
    for logn in range(7, 14):
        ctx = cs.make_context(cfg, logn)
        dl = dev_level(ctx, ctx.max_level)
        rk = KeyChest(ctx).relin_key
        gen = torch.Generator(device="cuda").manual_seed(logn)
        c = torch.randint(0, 1 << 62, (3, dl.level + 1, ctx.n),
                          generator=gen, device="cuda") % dl.q.p[:, None]
        ext = kks.ks_decompose(c, dl)
        ok = torch.equal(ext, kks.ks_decompose_plain(c, dl))
        for kd, ksh in ((rk.data, rk.shoup), (rk.data, None)):
            ok &= torch.equal(kks.ks_finish(ext[0], dl, kd, ksh),
                              kks.ks_finish_plain(ext[0], dl, kd, ksh))
        if not ok:
            cs.fail(f"a CI key-switch kernel differs from its plain "
                    f"version at a lift of 2^{logn + 1}")
        del ctx, dl, rk
    return list(range(8, 15))


def per_call(cs, cfg, tag, stats):
    """Phase 2b's key-switch cases of one CI config at every level."""
    from orion_tpu_torch.crypto import KeyChest
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import keyswitch as kks

    ctx = cs.make_context(cfg)
    rk = KeyChest(ctx).relin_key
    cases = cs.Cases(ctx, tag, stats, iters=50, plain_iters=0)
    n, lift = ctx.n, ctx.lift_n
    for level in range(ctx.max_level + 1):
        dl = dev_level(ctx, level)
        nl, n_t, dnum = level + 1, dl.t.p.shape[0], len(dl.digits)
        alpha = max(dg.src_hi - dg.src_lo for dg in dl.digits)
        c = cases.residues((nl, n), dl.q.p)
        cases.case("ks_decompose_ci", level, f"({nl}, {n})",
                   lambda: kks.ks_decompose(c, dl),
                   lambda: kks.ks_decompose_plain(c, dl),
                   cs.decompose_work(nl, n_t, dnum, alpha, n, lift))
        ext = kks.ks_decompose(c, dl)
        rows = dl.ksk_rows_idx
        trim = rk.data[:dnum][:, :, rows].contiguous()
        for label, kd, ksh, trimmed in (
                ("full-chain Shoup", rk.data, rk.shoup, False),
                ("trimmed lean", trim, None, True)):
            cases.case("ks_finish_ci", level, label,
                       lambda: kks.ks_finish(ext, dl, kd, ksh, trimmed),
                       lambda: kks.ks_finish_plain(ext, dl, kd, ksh,
                                                   trimmed),
                       cs.finish_work(nl, n_t, dnum, n, ksh is None,
                                      lift=lift))
    return ctx


def lola(cs, cfg, label):
    """LoLA-CI at B = 1 and B = 8: steady walls, one profiled forward
    each; outputs saved for the comparison across trees."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    import orion_tpu_torch as orion
    from orion_tpu_torch import kernels, models
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.runtime.jit import make_batched_forward
    from orion_tpu_torch.utils import get_mnist_datasets

    scheme = orion.init_scheme(cfg, device="cuda")
    linear._WEIGHT_RNG = np.random.default_rng(2024)
    net = models.LoLA()
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    inputs = [x for _, (x, _) in zip(range(8), testloader)]
    net.eval()
    orion.fit(net, trainloader)
    level = orion.compile(net)
    cts = [orion.encrypt(orion.encode(x, level)) for x in inputs]
    net.he()
    serial = [net(ct) for ct in cts]
    run = make_batched_forward(net, scheme)
    out, saved = {}, []
    for b, fn in ((1, lambda: net(cts[0])), (8, lambda: run(cts))):
        kernels.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        batches = kernels.batch_sizes()
        got = [res] if b == 1 else res
        for i, o in enumerate(got):
            if not cs._same_cts(o, serial[i]):
                cs.fail(f"{label}: LoLA-CI B={b} query {i} differs from "
                        f"its serial forward")
            saved.append([ct.data.cpu() for ct in o.cts])
        steady = []
        for _ in range(STEADY):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            steady.append((time.perf_counter() - t0) * 1e3)
        prof, wall_ms, _ = cs.profiled(fn, [ProfilerActivity.CUDA])
        got = cs.call_records(cs.records(prof))
        if got is None:
            cs.fail(f"{label}: the profile of LoLA-CI B={b} lost its "
                    f"markers")
        kept = got[0]
        dev = sum(e.end - e.start for e in kept) / 1e6
        ks = {g: sum(e.end - e.start for e in kept if g in e.name) / 1e6
              for g in KS_GRIDS}
        out[f"b{b}"] = {
            "steady_ms": steady, "steady_median_ms": sorted(steady)[2],
            "inferences_per_s": b / sorted(steady)[2] * 1e3,
            "profiled_wall_ms": wall_ms, "device_ms": dev,
            "busy_share": dev / wall_ms, "device_ops": len(kept),
            "ks_kernels_ms": ks, "ks_kernels_total_ms": sum(ks.values()),
            "batches": {k: v for k, v in batches.items()
                        if k.startswith("ks_")}}
    torch.save(saved, OUT / f"lola_{label}.pt")
    orion.delete_scheme()
    return out


def kernel_split(cs, ctx):
    """Device ms by kernel of one profiled call of each key-switch kernel
    at lola level 5 (one poly, a full-chain Shoup key) and of phase 7's
    LoLA-CI batches at level 1 (B = 56; K = 120 items over 15 trimmed
    Shoup keys, grouped by 8 queries)."""
    import torch
    from torch.profiler import ProfilerActivity

    from orion_tpu_torch.crypto import KeyChest
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import keyswitch as kks

    gen = torch.Generator(device="cuda").manual_seed(5)

    def residues(shape, p):
        x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")
        return x % p[:, None]

    rk = KeyChest(ctx).relin_key
    d5, d1 = dev_level(ctx, 5), dev_level(ctx, 1)
    c5 = residues((6, ctx.n), d5.q.p)
    e5 = kks.ks_decompose(c5, d5)
    c56 = residues((56, 2, ctx.n), d1.q.p)
    dnum, n_t = len(d1.digits), d1.t.p.shape[0]
    pack = residues((15, dnum, 2, n_t, ctx.n), d1.t.p)
    pack_sh = (pack << 32) // d1.t.p[:, None]
    ext = residues((8, dnum, n_t, ctx.n), d1.t.p)
    idx = torch.arange(15, device="cuda").repeat_interleave(8)
    calls = {
        "ks_decompose_ci lola level 5": lambda: kks.ks_decompose(c5, d5),
        "ks_finish_ci lola level 5": lambda: kks.ks_finish(
            e5, d5, rk.data, rk.shoup),
        "ks_decompose_ci B=56 lola level 1": lambda: kks.ks_decompose(
            c56, d1),
        "ks_finish_ci K=120 grouped E=8 lola level 1": lambda:
            kks.ks_finish(ext, d1, pack, pack_sh, True, idx)}
    out = {}
    for what, fn in calls.items():
        prof, _, _ = cs.profiled(fn, [ProfilerActivity.CUDA])
        got = cs.call_records(cs.records(prof))
        if got is None:
            cs.fail(f"the profile of {what} lost its markers")
        by = {}
        for e in got[0]:
            name = e.name.split("(")[0].removeprefix("void ")
            by[name] = by.get(name, 0.0) + (e.end - e.start) / 1e6
        out[what] = by
    return out


def measure(label):
    """One tree, from its own directory (the working directory)."""
    import torch
    import yaml

    tree = Path.cwd().resolve()
    sys.path.insert(0, str(tree))
    import orion_tpu_torch
    from orion_tpu_torch.kernels import _build

    if Path(orion_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"orion_tpu_torch imported from "
                         f"{orion_tpu_torch.__file__}, not from {tree}")
    cs = chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    rec = {"tree": label, "device": smi,
           "build_s": time.perf_counter() - t0}
    cfgs = {}
    for tag in ("lola", "mlp_ci"):
        with open(cs.CONFIGS[tag]) as f:
            cfgs[tag] = yaml.safe_load(f)
    rec["lifts_bit_exact"] = check_lifts(cs, cfgs["lola"])
    stats = {}
    per_call(cs, cfgs["mlp_ci"], "mlp_ci", stats)
    ctx = per_call(cs, cfgs["lola"], "lola", stats)
    rec["kernel_ms"] = kernel_split(cs, ctx)
    # phase 7's LoLA-CI batches at B = 8 queries, lola level 1
    cs.check_batched(ctx, "lola_b8", stats,
                     {"ks_decompose_ci": {1: {56: 1}},
                      "ks_finish_ci": {1: {120: 1}}},
                     levels=[1], queries=8)
    del ctx
    rec["cases"] = {r["label"] + f" [{name}]": {
        "device_ms": r["device_ms"], "ms": r["ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "items": r["items"], "bit_exact": r["ok"]}
        for name, recs in stats.items() for r in recs}
    if label in FULL:
        rec["lola_ci"] = lola(cs, cfgs["lola"], label)
        b8 = rec["lola_ci"]["b8"]["batches"]
        if (max(b8["ks_decompose_ci"][1]) != 56
                or max(b8["ks_finish_ci"][1]) != 120):
            cs.fail(f"LoLA-CI at B = 8 batches {b8}, not the B = 56 and "
                    f"K = 120 timed above")
    torch.cuda.synchronize()
    print("AB " + json.dumps(rec), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unpack", action="store_true",
                    help="unpack the parent tree (needs git) and stop")
    ap.add_argument("--parent", default="553bf51")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.unpack:
        unpack(args.parent)
        return 0
    if args.measure:
        return measure(args.measure)
    import torch

    if not torch.cuda.is_available():
        print("ci_keyswitch_ab: no CUDA device", file=sys.stderr)
        return 1
    if not (OUT / "parent" / "orion_tpu_torch").is_dir():
        print(f"ci_keyswitch_ab: no parent tree in {OUT / 'parent'}: run "
              f"with --unpack where git is first", file=sys.stderr)
        return 1
    dirs = {"parent": OUT / "parent", "change": ROOT}
    for name in PATCHES:
        dirs[name] = make_variant(name)
    runs = []
    for label in ORDER:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             label], cwd=dirs[label], stdout=subprocess.PIPE, text=True)
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith("AB "):
                runs.append(json.loads(line[3:]))
        if proc.wait() != 0:
            print(f"ci_keyswitch_ab: the {label} run failed",
                  file=sys.stderr)
            return 1
    want = torch.load(OUT / "lola_parent.pt")
    same = torch.load(OUT / "lola_change.pt")
    if len(want) != len(same) or not all(
            len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
            for a, b in zip(want, same)):
        print("ci_keyswitch_ab: LoLA-CI's outputs differ between the "
              "parent and the change", file=sys.stderr)
        return 1
    print("LoLA-CI outputs (B = 1 and the 8 of B = 8) equal in both trees",
          flush=True)
    summary = {}
    for r in runs:
        for case, v in r["cases"].items():
            summary.setdefault(case, {}).setdefault(r["tree"], []).append(
                v["device_ms"])
        for call, by in r["kernel_ms"].items():
            for kernel, ms in by.items():
                summary.setdefault(f"{call}: {kernel}", {}).setdefault(
                    r["tree"], []).append(ms)
        for b, v in r.get("lola_ci", {}).items():
            for key in ("device_ms", "ks_kernels_total_ms",
                        "steady_median_ms"):
                summary.setdefault(f"LoLA-CI {b} {key}", {}).setdefault(
                    r["tree"], []).append(v[key])
    for case, by in summary.items():
        print("SUMMARY " + json.dumps(
            {"case": case, "device": runs[0]["device"],
             **{t: sum(v) / len(v) for t, v in by.items()}}), flush=True)
    print(runs[0]["device"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
