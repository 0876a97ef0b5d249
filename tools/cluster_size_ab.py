#!/usr/bin/env python3
"""Measure the CTAs per row of the port's cluster transforms at LogN 13.

    python3 tools/cluster_size_ab.py

`Split<LOGN>` (orion_tpu_torch/kernels/csrc/cluster_ntt.cuh) fixes at
compile time how many CTAs of a thread-block cluster transform one row;
kernels/ntt.py `split_logc` packs the twiddles for the same split.  This
script copies the port into build/cluster_ab/c<C>/ once per C in 8, 4, 2, 1
at LogN 13 (every other ring size as shipped), patches both places, and
runs each copy in its own process on the GPU in the order 8 4 2 1 1 2 4 8.
Each run checks the transforms and the fused drop against their plain
versions on configs/lenet.yml's chain and prints one line
`AB {"C13": C, ...}` of device ms per call (calls queued behind a sleep
kernel, chip_smoke.py `device_ms`): ntt_fwd over the l target rows,
ntt_inv over the drop's divisor rows, and mod_drop_rescale over one
ciphertext and over two, at levels 7, 5 and 1.  C = 1 is the single-block
launch the split replaced.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "cluster_ab"
SPLIT_CUH = ("(LOGN >= 13 ? 3 : LOGN - 10)",
             "(LOGN == 13 ? {v} : LOGN >= 13 ? 3 : LOGN - 10)")
SPLIT_PY = ("return 0 if logn <= 10 else min(logn - 10, 3)",
            "return {v} if logn == 13 else 0 if logn <= 10 "
            "else min(logn - 10, 3)")


def patch(path, pair, v):
    text = path.read_text()
    if text.count(pair[0]) != 1:
        raise SystemExit(f"{path}: the split is no longer written as "
                         f"{pair[0]!r}")
    path.write_text(text.replace(pair[0], pair[1].format(v=v)))


def make_variant(logc):
    d = OUT / f"c{1 << logc}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shutil.copytree(ROOT / "orion_tpu_torch", d / "orion_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "configs", d / "configs")
    shutil.copy(ROOT / "chip_smoke.py", d)
    kern = d / "orion_tpu_torch" / "kernels"
    patch(kern / "csrc" / "cluster_ntt.cuh", SPLIT_CUH, logc)
    patch(kern / "ntt.py", SPLIT_PY, logc)
    return d


def measure():
    """One variant, run from its copy."""
    sys.path.insert(0, str(Path.cwd()))
    import torch
    import yaml

    import chip_smoke as cs
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import ntt as kntt
    from orion_tpu_torch.kernels import rescale as krs

    with open("configs/lenet.yml") as f:
        ctx = cs.make_context(yaml.safe_load(f))
    gen = torch.Generator(device="cuda").manual_seed(1)

    def residues(shape, p):
        x = torch.randint(0, 1 << 62, shape, generator=gen, device="cuda")
        return x % p[:, None]

    out = {"C13": kntt.cluster_size(13)}
    for level in (7, 5, 1):
        dl = dev_level(ctx, level)
        fwd, inv = dl.q.rows(0, level), dl.kernel_tables["drop_rows"]
        a = residues((level, ctx.n), fwd.p)
        b = residues((inv.p.shape[0], ctx.n), inv.p)
        if not (torch.equal(kntt.ntt_fwd(a, fwd), kntt.ntt_fwd_plain(a, fwd))
                and torch.equal(kntt.ntt_inv(b, inv),
                                kntt.ntt_inv_plain(b, inv))):
            raise SystemExit(f"C={out['C13']}: a transform differs")
        out[f"fwd{level}"] = cs.device_ms(lambda: kntt.ntt_fwd(a, fwd), 200)
        out[f"inv{level}"] = cs.device_ms(lambda: kntt.ntt_inv(b, inv), 200)
        for batch in ((2,), (2, 2)):
            acc = residues(batch + (dl.t.p.shape[0], ctx.n), dl.t.p)
            if not torch.equal(krs.mod_drop_rescale(acc, dl),
                               krs.mod_drop_rescale_plain(acc, dl)):
                raise SystemExit(f"C={out['C13']}: the drop differs")
            out[f"drop{level}_{len(batch)}"] = cs.device_ms(
                lambda: krs.mod_drop_rescale(acc, dl), 200)
    print("AB " + json.dumps(out), flush=True)


def main():
    if "--measure" in sys.argv:
        return measure()
    dirs = {logc: make_variant(logc) for logc in (3, 2, 1, 0)}
    for logc in (3, 2, 1, 0, 0, 1, 2, 3):
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--measure"], cwd=dirs[logc], check=True)


if __name__ == "__main__":
    main()
