#!/usr/bin/env python3
"""The standard ring's key-switch kernels before and after the hoisted
conversion, on one GPU.

    python3 tools/ks_keyswitch_ab.py --unpack          (needs git)
    python3 tools/ks_keyswitch_ab.py [--order T,T,...] [--no-resnet]
                                                       (on the GPU)

`ks_decompose` and `ks_finish` (orion_tpu_torch/kernels/csrc/
ks_decompose.cu, ks_finish.cu) computed each source coefficient's zq =
z * qhat_inv and the float32 quotient zq / q of the fast basis
conversion again for every target row; they now compute both once per
coefficient (csrc/hoist.cuh), and the target loops read them.  Three
trees are compared:
  - parent (d81e59b): the last tree before the hoist, two grids per
    kernel;
  - quot (068eeab): the hoist with each coefficient's float32 quotient
    stored beside its zq and a digit's quotients summed in the target
    loops (two grids per kernel);
  - change: this checkout, a pass between the grids that sums each
    digit's quotients into v, stored as one byte (three grids per
    kernel).
`--unpack` writes `git archive REV` of each tree but this one to
build/ks_ab/<tree>/; the run on the GPU measures each tree in its own
process in the order given (default parent quot change change quot
parent).  Each run prints one line `AB {...}` beside the card's name and
power limit: ptxas' registers and spills of the key-switch kernels at
LogN 13; device ms per call (chip_smoke.py `device_ms`: calls queued
behind a sleep kernel), each call held bit for bit against its plain
version, of
  - ks_decompose at configs/lenet.yml level 7 and configs/resnet.yml
    levels 1, 7, 17 and 43 (one poly), at resnet level 3 over B = 63 and
    B = 126 polys (ResNet-20's largest batches at B = 1 and 2 queries);
  - ks_finish with a full-chain Shoup key at lenet level 7, a trimmed
    lean key at resnet level 43, the 63-key lean pack at resnet level 3
    (shared ext), its 126 items grouped by 2 queries (ResNet-20 at B = 2)
    and 120 items over 15 Shoup keys grouped by 8 queries at
    configs/mlp.yml level 1 (the MLP at B = 8);
the device ms by device kernel of one profiled call of each, and the
host's ms to enqueue each call (`enqueue_ms`: 50 calls queued back to back,
timed on the host clock before the device is waited for); and (without
--no-resnet) ResNet-20 on configs/resnet.yml through the user entry
points (chip_smoke.py `check_resnet`): MAE, first and four steady walls,
the profiled forward's device time by kernel and its busy share, and a
digest of the output ciphertexts, which must be equal in every tree.  The
last lines give each case's device ms per run and tree.  chip_smoke.py
does not call this script.
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
OUT = ROOT / "build" / "ks_ab"
# the key-switch kernels' device kernels, every design
KS_GRIDS = ("ntt_inv_rows", "ntt_inv_zq", "fbc_ntt_digits",
            "ks_inner_intt", "moddown_rows", "hoist_digits", "hoist_zq")
TREES = {"parent": "d81e59b", "quot": "068eeab"}
ORDER = "parent,quot,change,change,quot,parent"
ENQUEUE_ITERS = 50


def unpack():
    for tree, rev in TREES.items():
        dest = OUT / tree
        shutil.rmtree(dest, ignore_errors=True)
        dest.mkdir(parents=True)
        archive = subprocess.run(["git", "archive", rev], cwd=ROOT,
                                 capture_output=True, check=True).stdout
        subprocess.run(["tar", "-x", "-C", str(dest)], input=archive,
                       check=True)
        print(f"unpacked {rev} to {dest}", flush=True)


def chip_smoke():
    """This checkout's chip_smoke.py (the trees' package is imported from
    the tree the process runs in)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(libs):
    """ptxas' registers and spills of the key-switch kernels at LogN 13."""
    import re

    out = {}
    for src in ("ks_decompose.cu", "ks_finish.cu"):
        name = None
        for line in libs[src].with_suffix(".log").read_text().splitlines():
            m = re.search(r"entry function '_Z(?:N5orion)?(\d+)", line)
            if m:
                base = line[m.end():m.end() + int(m.group(1))]
                rest = line[m.end() + int(m.group(1)):]
                name = (base if base in KS_GRIDS
                        and (rest.startswith("ILi13E")
                             or not rest.startswith("I")) else None)
            elif name and "spill stores" in line:
                spill = int(re.search(r"(\d+) bytes spill stores",
                                      line).group(1))
            elif name and "Used" in line:
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
                out[name] = {"registers": regs, "spilled": spill}
                name = None
    return out


def cases(cs, cfgs, stats):
    """The per-call and batched cases; returns {label: call} for the
    kernel split."""
    import torch

    from orion_tpu_torch.crypto import KeyChest
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import keyswitch as kks

    calls = {}

    def single(tag, levels, finish):
        """ks_decompose at each level; ks_finish with key form
        finish[level] where given."""
        ctx = cs.make_context(cfgs[tag])
        rk = KeyChest(ctx).relin_key
        cases_ = cs.Cases(ctx, tag, stats, iters=50, plain_iters=0)
        n = ctx.n
        for level in levels:
            dl = dev_level(ctx, level)
            nl, n_t, dnum = level + 1, dl.t.p.shape[0], len(dl.digits)
            alpha = max(dg.src_hi - dg.src_lo for dg in dl.digits)
            c = cases_.residues((nl, n), dl.q.p)
            label = f"{tag} level {level} ({nl}, {n})"
            cases_.case("ks_decompose", level, f"({nl}, {n})",
                        lambda: kks.ks_decompose(c, dl),
                        lambda: kks.ks_decompose_plain(c, dl),
                        cs.decompose_work(nl, n_t, dnum, alpha, n))
            calls[f"ks_decompose {label}"] = (
                lambda c=c, dl=dl: kks.ks_decompose(c, dl))
            if level not in finish:
                continue
            form = finish[level]
            ext = kks.ks_decompose(c, dl)
            if form == "full-chain Shoup":
                kd, ksh, trimmed = rk.data, rk.shoup, False
            else:
                kd = rk.data[:dnum][:, :, dl.ksk_rows_idx].contiguous()
                ksh, trimmed = None, True
            cases_.case("ks_finish", level, form,
                        lambda: kks.ks_finish(ext, dl, kd, ksh, trimmed),
                        lambda: kks.ks_finish_plain(ext, dl, kd, ksh,
                                                    trimmed),
                        cs.finish_work(nl, n_t, dnum, n, ksh is None))
            calls[f"ks_finish {tag} level {level} {form}"] = (
                lambda ext=ext, dl=dl, kd=kd, ksh=ksh, trimmed=trimmed:
                kks.ks_finish(ext, dl, kd, ksh, trimmed))
        return ctx

    single("lenet", [7], {7: "full-chain Shoup"})
    ctx = single("resnet", [1, 7, 17, 43], {43: "trimmed lean"})
    # ResNet-20's batches at resnet level 3: B = 63 and 126 polys, the
    # 63-key lean pack shared and grouped by 2 queries (126 items)
    cs.check_batched(ctx, "resnet", stats,
                     {"ks_decompose": {3: {63: 1}},
                      "ks_finish": {3: {63: 1}}}, levels=[3], lean=True)
    cs.check_batched(ctx, "resnet_b2", stats,
                     {"ks_decompose": {3: {126: 1}},
                      "ks_finish": {3: {126: 1}}}, levels=[3], lean=True,
                     queries=2)
    mlp = cs.make_context(cfgs["mlp"])
    cs.check_batched(mlp, "mlp_b8", stats,
                     {"ks_decompose": {1: {8: 1}},
                      "ks_finish": {1: {120: 1}}}, levels=[1], queries=8)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def residues(shape, p):
        x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")
        return x % p[:, None]

    d3 = dev_level(ctx, 3)
    dnum, n_t, n = len(d3.digits), d3.t.p.shape[0], ctx.n
    for b in (63, 126):
        c = residues((b, 4, n), d3.q.p)
        calls[f"ks_decompose B={b} resnet level 3"] = (
            lambda c=c: kks.ks_decompose(c, d3))
    pack = residues((63, dnum, 2, n_t, n), d3.t.p)
    ext1 = residues((dnum, n_t, n), d3.t.p)
    ext2 = residues((2, dnum, n_t, n), d3.t.p)
    idx = torch.arange(63, device="cuda")
    idx2 = idx.repeat_interleave(2)
    calls["ks_finish K=63 lean shared resnet level 3"] = (
        lambda: kks.ks_finish(ext1, d3, pack, None, True, idx))
    calls["ks_finish K=126 lean grouped E=2 resnet level 3"] = (
        lambda: kks.ks_finish(ext2, d3, pack, None, True, idx2))
    d1 = dev_level(mlp, 1)
    dnum1, nt1 = len(d1.digits), d1.t.p.shape[0]
    pk = residues((15, dnum1, 2, nt1, n), d1.t.p)
    pk_sh = (pk << 32) // d1.t.p[:, None]
    e8 = residues((8, dnum1, nt1, n), d1.t.p)
    idx8 = torch.arange(15, device="cuda").repeat_interleave(8)
    calls["ks_finish K=120 Shoup grouped E=8 mlp level 1"] = (
        lambda: kks.ks_finish(e8, d1, pk, pk_sh, True, idx8))
    return calls


def enqueue_ms(calls):
    """Host ms to enqueue one call of each: ENQUEUE_ITERS calls queued
    back to back after a warm-up, on the host clock, before the device is
    waited for (their few hundred launches stay within the launch
    queue)."""
    import torch

    out = {}
    for what, fn in calls.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ENQUEUE_ITERS):
            fn()
        out[what] = (time.perf_counter() - t0) * 1e3 / ENQUEUE_ITERS
        torch.cuda.synchronize()
    return out


def kernel_split(cs, calls):
    """Device ms by device kernel of one profiled call of each."""
    from torch.profiler import ProfilerActivity

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


def resnet(cs, cfg):
    """ResNet-20 through the user entry points; its profile by kernel."""
    rec = cs.check_resnet(cfg, more_steady=3)
    pr = rec["profile"]
    return {"mae": rec["mae"], "first_s": rec["first_s"],
            "steady_s": [rec["steady_s"]] + rec["more_steady_s"],
            "compile_s": rec["compile_s"],
            "profiled_wall_ms": pr["wall_ms"], "device_ms": pr["device_ms"],
            "busy_share": pr["busy_share"], "device_ops": pr["device_ops"],
            "port_kernels_ms": pr["our_kernels_ms"],
            "by_kernel": {k: v for k, v in pr["our_kernels_by_name"].items()
                          if v}, "top": pr["top"],
            "launches": {k: v for k, v in rec["launches"].items()
                         if k.startswith("ks_")},
            "out_sha256": rec["out_sha256"]}


def measure(label, with_resnet):
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
    csrc = tree / "orion_tpu_torch" / "kernels" / "csrc"
    grids = cs.launched_grids

    def two_grid_moddown():
        """moddown_rows launches where each ks_finish with ModDown runs
        two grids, and the sharded entry's."""
        from orion_tpu_torch import kernels as k

        return (k.KS_FINISH.grids - k.KS_FINISH.launches
                + k.KS_FINISH_CI.grids - k.KS_FINISH_CI.launches
                + k.KS_MODDOWN_ROWS.launches)

    if "ntt_inv_zq" not in (csrc / "ks_decompose.cu").read_text():
        # a tree before the hoist: ks_decompose's first grid is
        # ntt_inv_rows; two grids per kernel, no pass
        cs.OUR_KERNELS = tuple("ntt_inv_rows" if k == "ntt_inv_zq"
                               else k for k in cs.OUR_KERNELS)

        def launched_grids():
            g = grids()
            g["ntt_inv_rows"] = g.pop("ntt_inv_zq")
            g["moddown_rows"] = two_grid_moddown()
            g["hoist_digits"] = 0
            return g
        cs.launched_grids = launched_grids
    elif "hoist_zq" in (csrc / "hoist.cuh").read_text():
        # the stored quotients: two grids per kernel, hoist_zq before the
        # sharded entries' grid only
        cs.OUR_KERNELS = tuple("hoist_zq" if k == "hoist_digits"
                               else k for k in cs.OUR_KERNELS)

        def launched_grids():
            from orion_tpu_torch import kernels as k

            g = grids()
            g["moddown_rows"] = two_grid_moddown()
            g.pop("hoist_digits")
            g["hoist_zq"] = (k.KS_CONVERT_ROWS.launches
                             + k.KS_MODDOWN_ROWS.launches)
            return g
        cs.launched_grids = launched_grids
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build_all()
    rec = {"tree": label, "device": smi,
           "build_s": time.perf_counter() - t0,
           "registers": registers(libs)}
    cfgs = {}
    for tag in ("mlp", "lenet", "resnet"):
        with open(cs.CONFIGS[tag]) as f:
            cfgs[tag] = yaml.safe_load(f)
    stats = {}
    calls = cases(cs, cfgs, stats)
    rec["kernel_ms"] = kernel_split(cs, calls)
    rec["enqueue_ms"] = enqueue_ms(calls)
    rec["cases"] = {r["label"] + f" [{name}]": {
        "device_ms": r["device_ms"], "ms": r["ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "items": r["items"], "bit_exact": r["ok"]}
        for name, recs in stats.items() for r in recs}
    del calls
    torch.cuda.empty_cache()
    if with_resnet:
        rec["resnet"] = resnet(cs, cfgs["resnet"])
    torch.cuda.synchronize()
    print("AB " + json.dumps(rec), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unpack", action="store_true",
                    help="unpack the other trees (needs git) and stop")
    ap.add_argument("--order", default=ORDER,
                    help="the runs, by tree (parent, quot, change)")
    ap.add_argument("--no-resnet", action="store_true",
                    help="leave out ResNet-20's forward")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.unpack:
        unpack()
        return 0
    if args.measure:
        return measure(args.measure, not args.no_resnet)
    import torch

    if not torch.cuda.is_available():
        print("ks_keyswitch_ab: no CUDA device", file=sys.stderr)
        return 1
    order = args.order.split(",")
    dirs = {t: OUT / t for t in TREES}
    dirs["change"] = ROOT
    for t in order:
        if t not in dirs or not (dirs[t] / "orion_tpu_torch").is_dir():
            print(f"ks_keyswitch_ab: no {t} tree in {dirs.get(t)}: run with "
                  f"--unpack where git is first", file=sys.stderr)
            return 1
    runs = []
    for label in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
               label] + (["--no-resnet"] if args.no_resnet else [])
        proc = subprocess.Popen(cmd, cwd=dirs[label], stdout=subprocess.PIPE,
                                text=True)
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith("AB "):
                runs.append(json.loads(line[3:]))
        if proc.wait() != 0:
            print(f"ks_keyswitch_ab: the {label} run failed",
                  file=sys.stderr)
            return 1
    if not all(v["bit_exact"] for r in runs for v in r["cases"].values()):
        print("ks_keyswitch_ab: a case differs from its plain version",
              file=sys.stderr)
        return 1
    digests = {r["resnet"]["out_sha256"] for r in runs if "resnet" in r}
    if len(digests) > 1:
        print(f"ks_keyswitch_ab: ResNet-20's outputs differ between the "
              f"runs: {digests}", file=sys.stderr)
        return 1
    if digests:
        print("ResNet-20's output ciphertexts equal in every run", flush=True)
    summary = {}

    def add(key, tree, value):
        summary.setdefault(key, {}).setdefault(tree, []).append(value)

    for r in runs:
        for case, v in r["cases"].items():
            add(case, r["tree"], v["device_ms"])
        for call, by in r["kernel_ms"].items():
            for kernel, ms in by.items():
                add(f"{call}: {kernel}", r["tree"], ms)
        for call, ms in r["enqueue_ms"].items():
            add(f"{call}: enqueue_ms", r["tree"], ms)
        res = r.get("resnet")
        if res:
            for key in ("device_ms", "port_kernels_ms", "profiled_wall_ms",
                        "first_s", "busy_share"):
                add(f"ResNet-20 {key}", r["tree"], res[key])
            for t in res["steady_s"]:
                add("ResNet-20 steady_s", r["tree"], t)
            for kernel, ms in res["by_kernel"].items():
                add(f"ResNet-20 {kernel} ms", r["tree"], ms)
    for case, by in summary.items():
        print("SUMMARY " + json.dumps(
            {"case": case, "device": runs[0]["device"], "runs": by,
             "mean": {t: sum(v) / len(v) for t, v in by.items()}}),
            flush=True)
    for r in runs:
        print(f"registers {r['tree']}: {json.dumps(r['registers'])}",
              flush=True)
    print(runs[0]["device"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
