"""What the example scripts share: the flags, the flow from init_scheme
to the decrypted output, and the report."""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import numpy as np
import torch

CONFIGS = Path(__file__).resolve().parent.parent.parent / "configs"


def parse(argv, config: str, fhe_flag: bool):
    """--config (default configs/<config>), --cpu and, for the deep nets
    whose compile alone is the default run, --fhe."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=str(CONFIGS / config))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the host")
    if fhe_flag:
        ap.add_argument("--fhe", action="store_true",
                        help="also run the encrypted forward")
    args = ap.parse_args(argv)
    if not fhe_flag:
        args.fhe = True
    return args


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run(args, build, datasets, steady_input="same"):
    """init_scheme -> fit -> compile [-> encrypt -> he forward, twice ->
    decrypt] of `build()` on one synthetic input of `datasets`.  Prints
    the compile seconds and, with --fhe, the first and the steady
    encrypted forward and the MAE against the cleartext net; returns the
    MAE (None without --fhe).  The steady forward runs on the same
    ciphertext (`same`, as orion_tpu's run_mlp.py) or on a second
    encryption of the input (`fresh`, as its run_resnet.py)."""
    import orion_tpu_torch as orion
    from orion_tpu_torch.runtime.jit import make_jitted_forward
    from orion_tpu_torch.utils import mae

    device = "cpu" if args.cpu else "cuda"
    scheme = orion.init_scheme(args.config, device=device)
    trainloader, testloader = datasets(batch_size=1)
    net = build()
    inp, _ = next(iter(testloader))
    net.eval()
    out_clear = np.asarray(net(inp)).reshape(-1)

    orion.fit(net, trainloader)
    t0 = time.perf_counter()
    input_level = orion.compile(net)
    _sync(device)
    print(f"compile done in {time.perf_counter() - t0:.1f}s; "
          f"input_level={input_level}", flush=True)
    if not args.fhe:
        return None

    ct = orion.encrypt(orion.encode(inp, input_level))
    net.he()
    forward = make_jitted_forward(net, scheme)
    print("\nStarting FHE inference", flush=True)
    t0 = time.perf_counter()
    out = forward(ct)
    _sync(device)
    first = time.perf_counter() - t0
    ct2 = (ct if steady_input == "same"
           else orion.encrypt(orion.encode(inp, input_level)))
    t0 = time.perf_counter()
    forward(ct2)
    _sync(device)
    steady = time.perf_counter() - t0

    out_fhe = np.asarray(out.decrypt().decode()).reshape(-1)
    print()
    print("clear:", out_clear)
    print("fhe:  ", out_fhe[: out_clear.size])
    dist = mae(out_clear, out_fhe[: out_clear.size])
    print(f"\nMAE: {dist:.6f}")
    print(f"Precision: {-math.log2(dist):.4f} bits")
    print(f"First encrypted forward: {first:.4f} s")
    print(f"Steady-state FHE forward: {steady:.4f} s", flush=True)
    return dist
