#!/usr/bin/env python3
"""The rescale epilogues' kernels before and after a redesign, on one GPU.

    python3 tools/rescale_ab.py --unpack [--parent REV]     (needs git)
    python3 tools/rescale_ab.py [--order T,T,...] [--no-resnet]
                                                         (on the GPU)

Unpack the parent where git is, then copy the checkout to the machine
with the card and run the tool there from its root, keeping the output
(the runs print long JSON lines; README.md gives the command).

Both epilogues run launch A (orion_tpu_torch/kernels/csrc/ntt.cu
`drop_intt_rows`) then launch B: `rescale_lift_ntt` for `rescale_poly`,
and for `mod_drop_rescale` the pass `hoist_digits` (csrc/hoist.cuh) and
`drop_lift_ntt`.  The drop's design converts each divisor coefficient
once: launch A stores each coefficient's zq = z * qhat_inv mod q (n^-1
and qhat_inv folded into one Shoup constant per row), the pass sums
each coefficient's float32 quotients into v (one byte), and launch B
runs only the conversion's target half (L Shoup products and one for
v * dmod) before its transform.  The pass and both launches B are
programmatic dependents of the grid ahead of them; each launch B fetches
what it reads of c or acc before it waits.  Launch A lets its dependent
start as it starts, and each of its CTAs arrives on its cluster barrier
as it starts and waits on it only before its first push into another CTA
(its loads and first passes run while the cluster starts).  `--unpack`
writes `git archive REV` (default 321124a, the tree before this
redesign) to build/rescale_ab/parent/.  The run on the GPU measures each
tree in its own process, in the order given (default: parent change
change parent; each element on its own: parent,change,no_hoist,v_in_b,
late_trigger,sync_first,change,parent):

  parent              build/rescale_ab/parent/;
  change              this checkout;
  no_hoist            a copy whose drop converts as the parent did: launch
                      A stores z, no pass, launch B runs the whole
                      conversion per target row (fbc_one; it keeps the
                      seam);
  v_in_b              a copy with no pass: launch B sums each
                      coefficient's v from the stored zq itself (L
                      divisions per target coefficient, one grid fewer);
  late_trigger        a copy whose launch A lets its dependent start only
                      after its last store (as the parent did);
  sync_first          a copy whose launch A syncs with its cluster before
                      its loads (as the parent did);
  plain_loads         a copy whose launch B reads zq and v with plain
                      loads, not cached in L2 only (__ldcg).

Each copy takes one element of the design out; the designs that lost
(twiddles loaded before each barrier, other trigger placements of the
pass) are written down with their numbers in PERF.md, Findings.

Each run prints one line `AB {...}` beside the card's name and power
limit: ptxas' registers and spills of the epilogues' kernels at LogN 13
and 14 (and the CI forms); device ms per call (chip_smoke.py
`device_ms`: calls queued behind a sleep kernel), each call held bit for
bit against its plain version, of launch A, launch B alone (the drop's
with its pass; behind the call before it, which does not write c or acc)
and the pair over
  - rescale_poly: one ciphertext at configs/lenet.yml level 7 and
    configs/resnet.yml levels 1, 7, 17 and 43, a single poly at lenet 7
    and resnet 43, stacks of 4, 8 and 16 polys at resnet levels 7, 17 and
    43, and (with the forward) the three largest stacks ResNet-20's
    forward rescales and the three it rescales most often; LoLA-CI's pair
    at configs/lola.yml level 5;
  - mod_drop_rescale: one ciphertext at lenet 7 and resnet 1, 17 and 43,
    and (with the forward) the largest deferred-ModDown stack ResNet-20's
    forward divides and the most frequent one;
the device ms of each kernel of the pair (launch A, the drop's pass,
launch B) and of the whole pair (the union of their intervals) from one
profiled pair of each epilogue at lenet 7 and resnet 43 and of the drop
at resnet 1 and 17 and its stacks; and (without --no-resnet) ResNet-20
on configs/resnet.yml through the user entry points (chip_smoke.py
`check_resnet`): MAE, first and two steady walls, the profiled forward's
device time (union of intervals) by kernel, the drop's pass apart from
the key-switch's (`drop_pass`), its busy share, the rescale launches
by (level, polys), and a digest of the output ciphertexts, which must be
equal in every run.  The last lines give each case's device ms per run
and tree.  chip_smoke.py does not call this script.
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
PARENT = "321124a"
ORDER = "parent,change,change,parent"
KERNELS = ("drop_intt_rows", "rescale_lift_ntt", "drop_lift_ntt",
           "hoist_digits")
NTT_CU = "orion_tpu_torch/kernels/csrc/ntt.cu"
HOIST = "orion_tpu_torch/kernels/csrc/hoist.cuh"
RESCALE_PY = "orion_tpu_torch/kernels/rescale.py"
# the drop's pass launch and its v argument, which no_hoist and v_in_b
# take out
_PASS = (
    "        cudaError_t e = launch_hoist(\n"
    "            z, vb, nullptr, 0, (int64_t)L * N, N, N, 1, groups, L, "
    "nullptr,\n"
    "            nullptr, qi, qi_sh, srcp, srcq, st, true);\n"
    "        if (e != cudaSuccess) return e;\n")
_B_LOAD = (
    "            return fbc_target<false>(zg + i, N, __ldcg(vg + i), L, cw, "
    "dm,\n"
    "                                     dm_sh, pj);\n")
_NO_PASS = (
    (NTT_CU, _PASS, ""),
    (NTT_CU, "    const uint8_t* vg = vb + g * N;\n", ""),
    (RESCALE_PY, "items=groups * lvl, grids=2)", "items=groups * lvl)"))
# (file, text, replacement) of each patched copy; each text occurs once
PATCHES = {
    "no_hoist": _NO_PASS + (
        (NTT_CU, "const uint32_t* z, const uint8_t* vb, int n_src,",
         "const uint32_t* z, const int64_t* qi,\n"
         "                            const int64_t* qi_sh, "
         "const int64_t* srcp,\n"
         "                            const float* srcq, int n_src,"),
        (NTT_CU, _B_LOAD,
         "            return fbc_one(zg + i, N, L, qi, qi_sh, srcp, srcq, "
         "conv + j,\n"
         "                           conv_sh + j, l, dm, dm_sh, pj);\n"),
        (NTT_CU, "(const uint8_t*)vb, n_src,",
         "qi, qi_sh, srcp, srcq, n_src,"),
        (RESCALE_PY, 'ninv, ninv_sh = dl.kernel_tables["drop_zs"]',
         "ninv, ninv_sh = rr.ninv, rr.ninv_shoup"),
        (RESCALE_PY, "    if drop:\n        dg = dl.dropdown\n"
         "        z = z * dg.qhat_inv % dg.src_p\n", ""),
        (RESCALE_PY, "lift = torch.stack([fbc_from_zq(",
         "lift = torch.stack([fbc(")),
    "v_in_b": _NO_PASS + (
        (NTT_CU, "const uint32_t* z, const uint8_t* vb, int n_src,",
         "const uint32_t* z, const float* srcq, int n_src,"),
        (NTT_CU, _B_LOAD,
         "            uint32_t zz[MAX_ALPHA];\n"
         "            float f = 0.0f;\n"
         "#pragma unroll\n"
         "            for (int m = 0; m < MAX_ALPHA; ++m)\n"
         "                zz[m] = m < L ? zg[i + (int64_t)m * N] : 0u;\n"
         "#pragma unroll\n"
         "            for (int m = 0; m < MAX_ALPHA; ++m)\n"
         "                if (m < L)\n"
         "                    f = __fadd_rn(f, fbc_quot(zz[m], "
         "__ldg(srcq + m)));\n"
         "            uint32_t t = 0;\n"
         "#pragma unroll\n"
         "            for (int m = 0; m < MAX_ALPHA; ++m)\n"
         "                if (m < L) t = add_mod(t, shoup_mul(zz[m], cw[m], "
         "pj), pj);\n"
         "            return sub_mod(t, shoup_mul(__float2uint_rn(f), dm, "
         "dm_sh, pj),\n"
         "                           pj);\n"),
        (NTT_CU, "(const uint8_t*)vb, n_src,", "srcq, n_src,")),
    "late_trigger": (
        (NTT_CU, "    constexpr int W = row_width<LOGN, CI>();\n"
         "    launch_dependents();\n",
         "    constexpr int W = row_width<LOGN, CI>();\n"),
        (NTT_CU, "            if (!CI || i < W) dst[i] = shoup_mul(v, nv, "
         "nv_sh, pd);\n        });\n}\n",
         "            if (!CI || i < W) dst[i] = shoup_mul(v, nv, nv_sh, "
         "pd);\n        });\n    launch_dependents();\n}\n")),
    "sync_first": (
        (NTT_CU, "ntt_inv_split<LOGN, true>(", "ntt_inv_split<LOGN, false>("),),
    "plain_loads": (
        (NTT_CU, "__ldcg(vg + i)", "vg[i]"),
        (HOIST, ": __ldcg(zq + m * zstride);", ": zq[m * zstride];")),
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
    """ptxas' registers and spills of the epilogues' kernels in ntt.cu at
    LogN 13 and 14 (the drop's pass, not templated on LogN, by its own
    template argument)."""
    import re

    out = {}
    name = None
    for line in libs["ntt.cu"].with_suffix(".log").read_text().splitlines():
        m = re.search(r"entry function '_Z(?:N5orion)?(\d+)", line)
        if m:
            base = line[m.end():m.end() + int(m.group(1))]
            rest = line[m.end() + int(m.group(1)):]
            t = re.match(r"ILi(\d+)E(Lb([01])E)?", rest)
            if base == "hoist_digits":
                name = base + ("<true>" if rest.startswith("ILb1E") else "")
            elif base in KERNELS and t and t.group(1) in ("13", "14"):
                ci = ", CI" if t.group(3) == "1" else ""
                name = f"{base}<{t.group(1)}{ci}>"
            else:
                name = None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores",
                                  line).group(1))
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name] = {"registers": regs, "spilled": spill}
            name = None
    return out


def epilogue_cases(cs, cases, dl, x, label, what="rescale"):
    """Launch A, launch B (the drop's with its pass) and the pair over x,
    each against its plain version (chip_smoke.py `check_epilogues` for
    one shape)."""
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


def cases(cs, cfgs, stats, stacks, drops):
    """Every case; returns {label: pair call} for the profiled split.
    stacks: ResNet-20's (level, polys) of rescale_poly to add; drops: its
    (level, polys) of mod_drop_rescale."""
    import torch

    from orion_tpu_torch.crypto.keyswitch import dev_level

    calls = {}
    gen = torch.Generator(device="cuda").manual_seed(5)

    def residues(shape, p):
        x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")
        return x % p[:, None]

    deep = sorted({1, 7, 17, 43} | {lv for lv, _ in stacks}
                  | {lv for lv, _ in drops})
    for tag, levels in (("lenet", (7,)), ("resnet", deep)):
        ctx = cs.make_context(cfgs[tag])
        cases_ = cs.Cases(ctx, tag, stats, iters=50, plain_iters=0)
        for level in levels:
            dl = dev_level(ctx, level)
            shapes = []
            if tag == "lenet" or level in (1, 7, 17, 43):
                shapes = [(2,)] + ([()] if level in (7, 43) else [])
            if tag == "resnet" and level in (7, 17, 43):
                shapes += [(g,) for g in (4, 8, 16)]
            shapes += [(g,) for lv, g in stacks if lv == level
                       and tag == "resnet" and (g,) not in shapes]
            for batch in shapes:
                x = residues(batch + (level + 1, ctx.n), dl.q.p)
                label = f"rescale {batch + (level + 1, ctx.n)}"
                pair = epilogue_cases(cs, cases_, dl, x, label)
                if batch == (2,) and level in (7, 43):
                    calls[f"{tag} level {level} {label}"] = pair
            n_t = dl.t.p.shape[0]
            dshapes = ([(2,)] if tag == "lenet" or level in (1, 17, 43)
                       else [])
            dshapes += [(g,) for lv, g in drops if lv == level
                        and tag == "resnet" and (g,) not in dshapes]
            for batch in dshapes:
                x = residues(batch + (n_t, ctx.n), dl.t.p)
                label = f"drop {batch + (n_t, ctx.n)}"
                pair = epilogue_cases(cs, cases_, dl, x, label, "drop")
                calls[f"{tag} level {level} {label}"] = pair
    ctx = cs.make_context(cfgs["lola"])
    dl = dev_level(ctx, 5)
    x = residues((2, 6, ctx.n), dl.q.p)
    epilogue_cases(cs, cs.Cases(ctx, "lola", stats, iters=50,
                                plain_iters=0),
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


def _sizes(batches, kernel):
    """{(level, polys): launches} of one kernel from a forward's batches
    ({kernel: {level: {items: launches}}}, items = polys * level)."""
    return {(lv, items // lv): n
            for lv, by in batches.get(kernel, {}).items()
            for items, n in by.items()}


def resnet(cs, cfg):
    """ResNet-20 through the user entry points; its profile by kernel and
    the rescale launches by (level, polys)."""
    rec = cs.check_resnet(cfg, more_steady=1)
    pr = rec["profile"]
    by = {k: v for k, v in pr["our_kernels_by_name"].items() if v}
    by["drop_lift_ntt + its pass"] = (by.get("drop_lift_ntt", 0.0)
                                      + by.get("drop_pass", 0.0))
    return {"mae": rec["mae"], "first_s": rec["first_s"],
            "steady_s": [rec["steady_s"]] + rec["more_steady_s"],
            "profiled_wall_ms": pr["wall_ms"], "device_ms": pr["device_ms"],
            "busy_share": pr["busy_share"], "device_ops": pr["device_ops"],
            "port_kernels_ms": pr["our_kernels_ms"],
            "by_kernel": by, "top": pr["top"],
            "rescale_launches": {k: v for k, v in rec["launches"].items()
                                 if k in ("drop_intt", "rescale_ntt",
                                          "drop_ntt")},
            "rescale_sizes": {f"{lv} x {g}": n for (lv, g), n in
                              _sizes(rec["batches"], "rescale_ntt").items()},
            "drop_sizes": {f"{lv} x {g}": n for (lv, g), n in
                           _sizes(rec["batches"], "drop_ntt").items()},
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
    stacks, drops = [], []
    if with_resnet:
        rec["resnet"] = resnet(cs, cfgs["resnet"])

        def sizes(key):
            return {tuple(map(int, k.split(" x "))): n
                    for k, n in rec["resnet"][key].items()}

        sz = sizes("rescale_sizes")
        largest = sorted(sz, key=lambda s: (-s[1], -s[0]))[:3]
        often = sorted(sz, key=lambda s: -sz[s])[:3]
        stacks = list(dict.fromkeys(largest + often))
        # the deferred ModDown's stacks: the largest, the most frequent
        dz = {k: n for k, n in sizes("drop_sizes").items() if k[1] > 2}
        drops = list(dict.fromkeys(
            sorted(dz, key=lambda s: (-s[1], -s[0]))[:1]
            + sorted(dz, key=lambda s: -dz[s])[:1]))
        torch.cuda.empty_cache()
    stats = {}
    calls = cases(cs, cfgs, stats, stacks, drops)
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
