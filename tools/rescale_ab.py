#!/usr/bin/env python3
"""The rescale epilogue's kernels before and after their redesign, on one
GPU.

    python3 tools/rescale_ab.py --unpack [--parent REV]     (needs git)
    python3 tools/rescale_ab.py [--order T,T,...] [--no-resnet]
                                                         (on the GPU)

`rescale_poly`'s two launches (orion_tpu_torch/kernels/csrc/ntt.cu
`drop_intt_rows`, then `rescale_lift_ntt`) were redesigned: launch B
fetches the values of c its stores need into registers before anything
that reads launch A's output; it reduces the centered lift with a Shoup
product by one in place of `%`; it is launched as a programmatic
dependent of launch A, which lets it start after its last store of z;
its CI form enters the transform through `ntt_fwd_lift` (the kept half
only, each value lifted once).  `--unpack` writes `git archive
REV` (default 371c1e7, the tree before the redesign) to
build/rescale_ab/parent/.  The run on the GPU measures each tree in its
own process, in the order given (default: parent change change parent;
each element on its own: parent,change,no_prefetch,mod,no_seam,change,
parent):

  parent       build/rescale_ab/parent/;
  change       this checkout;
  no_prefetch  a copy of this checkout whose launch B reads c in its
               store, after the transform (as the parent did);
  mod          a copy whose centered lift reduces with `%`;
  no_seam      a copy whose launch B is an ordinary launch (it still
               fetches c first; its wait then returns at once);
  tw_prefetch  a copy whose launch B also asks for its twiddles in L1
               before it waits (a design step that lost, PERF.md).

Each run prints one line `AB {...}` beside the card's name and power
limit: ptxas' registers and spills of both kernels at LogN 13 and 14 (and
their CI forms); device ms per call (chip_smoke.py `device_ms`: calls
queued behind a sleep kernel), each call held bit for bit against its
plain version, of launch A, launch B alone (behind the call before it,
which does not write c) and the pair (`rescale_poly`) over
  - one ciphertext at configs/lenet.yml level 7 and configs/resnet.yml
    levels 1, 7, 17 and 43, and a single poly at lenet 7 and resnet 43;
  - stacks of 4, 8 and 16 polys at resnet levels 7, 17 and 43, and
    (with the forward) the three largest stacks ResNet-20's forward
    rescales and the three it rescales most often (its launch records);
  - mod_drop_rescale at resnet level 43 (its launch B, row 1a, is not
    changed) and LoLA-CI's pair at configs/lola.yml level 5;
the device ms of A, of B and of the whole pair (the union of their
intervals) from one profiled pair at lenet 7 and resnet 43; and (without
--no-resnet) ResNet-20 on configs/resnet.yml through the user entry
points (chip_smoke.py `check_resnet`): MAE, first and two steady walls,
the profiled forward's device time (union of intervals) by kernel and its
busy share, the rescale launches by (level, polys), and a digest of the
output ciphertexts, which must be equal in every run.  The last lines give
each case's device ms per run and tree.  chip_smoke.py does not call this
script.
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
OUT = ROOT / "build" / "rescale_ab"
PARENT = "371c1e7"
ORDER = "parent,change,change,parent"
KERNELS = ("drop_intt_rows", "rescale_lift_ntt", "drop_lift_ntt")
NTT_CU = "orion_tpu_torch/kernels/csrc/ntt.cu"
# (file, text, replacement) of each patched copy; each text occurs once
PATCHES = {
    "no_prefetch": (
        (NTT_CU, "    if (cr < KEEP) {", "    if (false) {"),
        (NTT_CU, "CI ? pos[slot] : o;", "CI ? (int)ci_pos[o] : o;"),
        (NTT_CU, "sub_mod(pre[slot], v, pj)",
         "sub_mod((uint32_t)a[k], v, pj)")),
    "mod": ((NTT_CU, "shoup_mul(x, 1u, osh, pj)", "x % pj"),),
    "no_seam": (
        (NTT_CU, "launch_split_grid<LOGN, true>(",
         "launch_split_grid<LOGN, false>("),),
    "tw_prefetch": (
        (NTT_CU, "    const int64_t* tw = twc + (int64_t)j * N;\n",
         "    const int64_t* tw = twc + (int64_t)j * N;\n"
         "    for (int i = (int)threadIdx.x * 16; i < SP::M;"
         " i += SP::T * 16)\n"
         "        asm volatile(\"prefetch.global.L1 [%0];\" ::\"l\"("
         "tw + cr * SP::M + i));\n"),),
}


def unpack(parent):
    dest = OUT / "parent"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    archive = subprocess.run(["git", "archive", parent], cwd=ROOT,
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", str(dest)], input=archive, check=True)
    print(f"unpacked {parent} to {dest}", flush=True)


def patched(tree):
    """A copy of this checkout's package with the tree's patches, under
    build/rescale_ab/<tree>/ (chip_smoke.py and configs/ beside it)."""
    dest = OUT / tree
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    for part in ("orion_tpu_torch", "configs", "chip_smoke.py"):
        src = ROOT / part
        if src.is_dir():
            shutil.copytree(src, dest / part,
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy(src, dest / part)
    for file, text, new in PATCHES[tree]:
        path = dest / file
        body = path.read_text()
        if body.count(text) != 1:
            raise SystemExit(f"rescale_ab: {tree}: {text!r} occurs "
                             f"{body.count(text)} times in {file}")
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


def registers(libs):
    """ptxas' registers and spills of the kernels at LogN 13 and 14."""
    import re

    out = {}
    name = None
    for line in libs["ntt.cu"].with_suffix(".log").read_text().splitlines():
        m = re.search(r"entry function '_Z(?:N5orion)?(\d+)", line)
        if m:
            base = line[m.end():m.end() + int(m.group(1))]
            t = re.match(r"ILi(\d+)E(Lb([01])E)?",
                         line[m.end() + int(m.group(1)):])
            keep = base in KERNELS and t and t.group(1) in ("13", "14")
            ci = ", CI" if keep and t.group(3) == "1" else ""
            name = f"{base}<{t.group(1)}{ci}>" if keep else None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores",
                                  line).group(1))
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name] = {"registers": regs, "spilled": spill}
            name = None
    return out


def rescale_cases(cs, cases, dl, x, label, what="rescale"):
    """Launch A, launch B and the pair over x, each against its plain
    version (chip_smoke.py `check_epilogues` for one shape)."""
    from orion_tpu_torch.kernels import rescale as krs

    n, level = dl.ring_n, dl.level
    groups = x.numel() // (x.shape[-2] * n)
    drop = what == "drop"
    lift = cases.ctx.lift_n
    n_div = dl.kernel_tables["drop_rows"].p.shape[0] if drop else 1
    b_fn, b_plain, pair, pair_plain = (
        (krs.drop_lift_ntt, krs.drop_lift_ntt_plain, krs.mod_drop_rescale,
         krs.mod_drop_rescale_plain) if drop else
        (krs.rescale_lift_ntt, krs.rescale_lift_ntt_plain, krs.rescale_poly,
         krs.rescale_poly_plain))
    cases.case("A", level, label, lambda: krs.divisor_intt(x, dl, drop),
               lambda: krs.divisor_intt_plain(x, dl, drop),
               cs.divisor_intt_work(groups, n_div, n, lift), plain_iters=0)
    z = krs.divisor_intt(x, dl, drop)
    cases.case("B", level, label, lambda: b_fn(x, z, dl),
               lambda: b_plain(x, z, dl),
               cs.lift_ntt_work(groups, n_div, level, n, drop, lift),
               plain_iters=0)
    cases.case("pair", level, label, lambda: pair(x, dl),
               lambda: pair_plain(x, dl),
               cs.drop_work(groups, n_div, level, n, drop, lift),
               plain_iters=0)
    return lambda: pair(x, dl)


def cases(cs, cfgs, stats, stacks):
    """Every case; returns {label: pair call} for the profiled split."""
    import torch

    from orion_tpu_torch.crypto.keyswitch import dev_level

    calls = {}
    gen = torch.Generator(device="cuda").manual_seed(5)

    def residues(shape, p):
        x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")
        return x % p[:, None]

    deep = sorted({1, 7, 17, 43} | {lv for lv, _ in stacks})
    for tag, levels in (("lenet", (7,)), ("resnet", deep)):
        ctx = cs.make_context(cfgs[tag])
        cases_ = cs.Cases(ctx, tag, stats, iters=50, plain_iters=0)
        for level in levels:
            dl = dev_level(ctx, level)
            shapes = [(2,)] + ([()] if level in (7, 43) else [])
            if tag == "resnet" and level in (7, 17, 43):
                shapes += [(g,) for g in (4, 8, 16)]
            shapes += [(g,) for lv, g in stacks if lv == level
                       and tag == "resnet" and (g,) not in shapes]
            for batch in shapes:
                x = residues(batch + (level + 1, ctx.n), dl.q.p)
                label = f"rescale {batch + (level + 1, ctx.n)}"
                pair = rescale_cases(cs, cases_, dl, x, label)
                if batch == (2,) and level in (7, 43):
                    calls[f"{tag} level {level} {label}"] = pair
            if tag == "resnet" and level == 43:
                x = residues((2, dl.t.p.shape[0], ctx.n), dl.t.p)
                rescale_cases(cs, cases_, dl, x,
                              f"drop {(2, dl.t.p.shape[0], ctx.n)}", "drop")
    ctx = cs.make_context(cfgs["lola"])
    dl = dev_level(ctx, 5)
    x = residues((2, 6, ctx.n), dl.q.p)
    rescale_cases(cs, cs.Cases(ctx, "lola", stats, iters=50, plain_iters=0),
                  dl, x, f"rescale CI {(2, 6, ctx.n)}")
    return calls


def pair_split(cs, calls):
    """Device ms of each kernel and of the pair (the union of the
    intervals) from one profiled pair of each (a profile that lost its
    markers is taken again, at most three times, then left out)."""
    from torch.profiler import ProfilerActivity

    out = {}
    for what, fn in calls.items():
        for _ in range(3):
            prof, _, _ = cs.profiled(fn, [ProfilerActivity.CUDA])
            got = cs.call_records(cs.records(prof))
            if got is not None:
                break
            print(f"  the profile of {what} lost its markers", flush=True)
        else:
            continue
        by = {}
        for e in got[0]:
            name = e.name.split("(")[0].removeprefix("void ")
            by[name] = by.get(name, 0.0) + (e.end - e.start) / 1e6
        by["union"] = cs.busy_ms(got[0])
        out[what] = by
    return out


def resnet(cs, cfg):
    """ResNet-20 through the user entry points; its profile by kernel and
    the rescale launches by (level, polys)."""
    rec = cs.check_resnet(cfg, more_steady=1)
    pr = rec["profile"]
    b = rec["batches"].get("rescale_ntt", {})
    sizes = {f"{lv} x {items // lv}": n for lv, by in b.items()
             for items, n in by.items()}
    return {"mae": rec["mae"], "first_s": rec["first_s"],
            "steady_s": [rec["steady_s"]] + rec["more_steady_s"],
            "profiled_wall_ms": pr["wall_ms"], "device_ms": pr["device_ms"],
            "busy_share": pr["busy_share"], "device_ops": pr["device_ops"],
            "port_kernels_ms": pr["our_kernels_ms"],
            "by_kernel": {k: v for k, v in pr["our_kernels_by_name"].items()
                          if v}, "top": pr["top"],
            "rescale_launches": {k: v for k, v in rec["launches"].items()
                                 if k in ("drop_intt", "rescale_ntt",
                                          "drop_ntt")},
            "rescale_sizes": sizes, "out_sha256": rec["out_sha256"]}


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
    if not hasattr(cs, "busy_ms"):
        raise SystemExit("rescale_ab: run from a checkout with busy_ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build_all()
    rec = {"tree": label, "device": smi,
           "build_s": time.perf_counter() - t0,
           "registers": registers(libs)}
    cfgs = {}
    for tag in ("lenet", "resnet", "lola"):
        with open(cs.CONFIGS[tag]) as f:
            cfgs[tag] = yaml.safe_load(f)
    stacks = []
    if with_resnet:
        rec["resnet"] = resnet(cs, cfgs["resnet"])
        sizes = {tuple(map(int, k.split(" x "))): n
                 for k, n in rec["resnet"]["rescale_sizes"].items()}
        largest = sorted(sizes, key=lambda s: (-s[1], -s[0]))[:3]
        often = sorted(sizes, key=lambda s: -sizes[s])[:3]
        stacks = list(dict.fromkeys(largest + often))
        torch.cuda.empty_cache()
    stats = {}
    calls = cases(cs, cfgs, stats, stacks)
    rec["pair_split"] = pair_split(cs, calls)
    rec["cases"] = {f"{r['label']} [{name}]": {
        "device_ms": r["device_ms"], "ms": r["ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "bit_exact": r["ok"]}
        for name, recs in stats.items() for r in recs}
    torch.cuda.synchronize()
    print("AB " + json.dumps(rec), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--unpack", action="store_true",
                    help="unpack the parent tree (needs git) and stop")
    ap.add_argument("--parent", default=PARENT)
    ap.add_argument("--order", default=ORDER,
                    help="the runs, by tree (parent, change, "
                    + ", ".join(PATCHES) + ")")
    ap.add_argument("--no-resnet", action="store_true",
                    help="leave out ResNet-20's forward")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.unpack:
        unpack(args.parent)
        return 0
    if args.measure:
        return measure(args.measure, not args.no_resnet)
    import torch

    if not torch.cuda.is_available():
        print("rescale_ab: no CUDA device", file=sys.stderr)
        return 1
    order = args.order.split(",")
    dirs = {"parent": OUT / "parent", "change": ROOT}
    for t in set(order):
        if t in PATCHES:
            dirs[t] = patched(t)
        if t not in dirs or not (dirs[t] / "orion_tpu_torch").is_dir():
            print(f"rescale_ab: no {t} tree in {dirs.get(t)}: run with "
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
            print(f"rescale_ab: the {label} run failed", file=sys.stderr)
            return 1
    if not all(v["bit_exact"] for r in runs for v in r["cases"].values()):
        print("rescale_ab: a case differs from its plain version",
              file=sys.stderr)
        return 1
    digests = {r["resnet"]["out_sha256"] for r in runs if "resnet" in r}
    if len(digests) > 1:
        print(f"rescale_ab: ResNet-20's outputs differ between the runs: "
              f"{digests}", file=sys.stderr)
        return 1
    if digests:
        print("ResNet-20's output ciphertexts equal in every run", flush=True)
    summary = {}

    def add(key, tree, value):
        summary.setdefault(key, {}).setdefault(tree, []).append(value)

    for r in runs:
        for case, v in r["cases"].items():
            add(case, r["tree"], v["device_ms"])
        for call, by in r["pair_split"].items():
            for kernel, ms in by.items():
                add(f"{call}: {kernel}", r["tree"], ms)
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
