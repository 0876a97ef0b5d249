#!/usr/bin/env python3
"""Reckon the device memory of an encrypted net's compile, on the host.

    python tools/memory_reckon.py alexnet [vgg resnet ...]

Runs the port's own `init_scheme -> fit -> compile` with device="cpu" on
the net's config at full width (weights from the generator seed
`chip_smoke.py` uses, its synthetic CIFAR-10 images for fit), with two
things replaced so that the run fits in a host's memory and minutes: key
sampling and diagonal encoding.  Each key-switch key and each encoded
diagonal batch becomes a `meta` tensor of the shape and dtype the card
would hold (int64; a key's Shoup companion is int64 on the card too), so
every later step (key packs, trimming, the bootstrap circuits, freeing)
runs the port's code on shapes alone.  The keys are not real, so nothing
here is encrypted or evaluated.

The live bytes are summed at every key made, every key pack built (with
the pack's stacking temporaries) and every module compiled: the rotation
keys held, the key packs, the encoded diagonals and the other buffers.
The result is one JSON line per net: rotation keys made and freed, key
packs and their bytes, diagonals per module with its level, the live
bytes after compile and the largest live bytes during it, with the module
it was reached in.  The forward's own working set is not reckoned.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NETS = {"alexnet": ("alexnet.yml", "AlexNet"),
        "vgg": ("vgg.yml", "VGG11"),
        "resnet": ("resnet.yml", "ResNet20")}


def nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


class Ledger:
    """Live device bytes of one scheme's compile, read at each event."""

    def __init__(self, scheme):
        self.scheme = scheme
        self.diag_bytes = 0       # encoded diagonals (kept by their modules)
        self.other_bytes = 0      # plaintexts, index and permutation tables
        self.module = "init"
        self.peak = (0, None)
        self.keys_made = 0

    def keys(self):
        ks = self.scheme.keys
        return sum(nbytes(k.data) + nbytes(k.shoup)
                   for k in list(ks.galois_keys.values()) + [ks.relin_key])

    def packs(self):
        return sum(nbytes(p.ksk) + nbytes(p.ksk_shoup) + nbytes(p.perms)
                   for p in self.scheme.evaluator._key_packs.values())

    def live(self):
        return (self.keys() + self.packs() + self.diag_bytes
                + self.other_bytes)

    def mark(self, extra=0):
        total = self.live() + extra
        if total > self.peak[0]:
            self.peak = (total, self.module)


def reckon(tag):
    import orion_tpu_torch as orion
    from orion_tpu_torch import models
    from orion_tpu_torch.crypto import encoding, keys, lintrans_scan, placement
    from orion_tpu_torch.crypto import bootstrap as boot_mod
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.nn.operations import Bootstrap
    from orion_tpu_torch.utils import get_cifar_datasets

    cfg_name, model = NETS[tag]
    with open(ROOT / "configs" / cfg_name) as f:
        cfg = yaml.safe_load(f)
    sch = orion.init_scheme(cfg, device="cpu")
    ctx = sch.ctx
    led = Ledger(sch)
    real_buffer = placement.buffer

    def fake_ksk(self, s_prime_ntt):
        led.keys_made += 1
        dnum = -(-ctx.n_q // ctx.alpha)
        shape = (dnum, 2, ctx.n_all, ctx.n)
        key = keys.KeySwitchKey.__new__(keys.KeySwitchKey)
        key.data = torch.empty(shape, dtype=torch.int64, device="meta")
        key.shoup = torch.empty(shape, dtype=torch.int64, device="meta")
        return key

    def fake_encode_batch(self, vecs, level=None, scale=None,
                          with_shoup=False):
        level = ctx.max_level if level is None else level
        data = torch.empty((len(vecs), level + 1, ctx.n), dtype=torch.int64,
                           device="meta")
        led.diag_bytes += nbytes(data)
        return data, scale

    def buffer(x, device):
        if isinstance(x, torch.Tensor) and x.is_meta:
            return x
        out = real_buffer(x, device)
        led.other_bytes += nbytes(out)
        return out

    real_galois = keys.KeyChest.galois_key

    def galois_key(self, k):
        out = real_galois(self, k)
        led.mark()
        return out

    real_pack = lintrans_scan.build_key_pack

    def build_key_pack(ev, amounts, level=None):
        before = set(ev._key_packs)
        pack = real_pack(ev, amounts, level)
        if pack.cache_key not in before:
            # the permuted keys are listed, then stacked: both live at once
            led.mark(extra=nbytes(pack.ksk) + nbytes(pack.ksk_shoup))
        return pack

    patches = [(keys.KeyChest, "_gen_ksk", fake_ksk),
               (keys.KeyChest, "galois_key", galois_key),
               (encoding.Encoder, "encode_batch", fake_encode_batch),
               (placement, "buffer", buffer),
               # and where it was imported by name
               (lintrans_scan, "build_key_pack", build_key_pack),
               (boot_mod, "build_key_pack", build_key_pack)]
    per_module = []

    def wrap(real):
        def compile_module(self):
            led.module = getattr(self, "_reckon_name", type(self).__name__)
            d0, k0 = led.diag_bytes, led.keys_made
            p0 = len(sch.evaluator._key_packs)
            out = real(self)
            led.mark()
            n_diag = sum(len(d) for d in getattr(self, "diagonals",
                                                 {}).values())
            if n_diag or led.keys_made > k0:
                per_module.append(dict(
                    module=led.module, level=self.level, diagonals=n_diag,
                    blocks=len(getattr(self, "diagonals", {})),
                    diag_mib=(led.diag_bytes - d0) / 2 ** 20,
                    keys_made=led.keys_made - k0,
                    packs_built=len(sch.evaluator._key_packs) - p0,
                    live_gib=led.live() / 2 ** 30))
            return out
        return compile_module

    linear._WEIGHT_RNG = np.random.default_rng(2024)
    net = getattr(models, model)()
    # every class whose compile runs: the net's, and the Bootstrap modules
    # the placer attaches during compile
    classes = {type(m) for m in net.modules()} | {Bootstrap}
    patches += [(c, "compile", wrap(c.compile)) for c in classes]
    saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        # the relin key was made before the patches: replace it by its shape
        sch.keys.relin_key = fake_ksk(sch.keys, None)
        led.keys_made = 0
        for name, m in net.named_modules():
            m._reckon_name = name
        trainloader, _ = get_cifar_datasets(batch_size=1)
        net.eval()
        t0 = time.perf_counter()
        orion.fit(net, trainloader)
        fit_s = time.perf_counter() - t0
        led.module = "bootstrappers"
        t0 = time.perf_counter()
        input_level = orion.compile(net)
        compile_s = time.perf_counter() - t0
    finally:
        for obj, name, fn in reversed(saved):
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)

    placed = [n for n, m in net.named_modules()
              if getattr(m, "post_bootstrap", None) is not None]
    packs = sch.evaluator._key_packs.values()
    gib = 2 ** 30
    return {
        "net": model, "config": f"configs/{cfg_name}",
        "input_level": input_level, "fit_s": fit_s,
        "host_compile_s_without_keys_and_encoding": compile_s,
        "bootstraps_placed": len(placed), "placed": placed,
        "bootstrap_slot_counts": sorted(sch.bootstrapper._by_slots),
        "rotation_keys_made": led.keys_made,
        "key_gib_each": (nbytes(sch.keys.relin_key.data)
                         + nbytes(sch.keys.relin_key.shoup)) / gib,
        "keys_kept": len(sch.keys.galois_keys),
        "key_packs": len(sch.evaluator._key_packs),
        "key_pack_gib": sum(nbytes(p.ksk) + nbytes(p.ksk_shoup)
                            + nbytes(p.perms) for p in packs) / gib,
        "largest_pack_keys": max(len(p.amounts) for p in packs),
        "diagonals": sum(r["diagonals"] for r in per_module),
        "diagonal_gib": led.diag_bytes / gib,
        "other_gib": led.other_bytes / gib,
        "live_after_compile_gib": led.live() / gib,
        "compile_peak_gib": led.peak[0] / gib,
        "compile_peak_at": led.peak[1],
        "modules": per_module,
    }


def main(argv):
    tags = argv or ["alexnet", "vgg"]
    for tag in tags:
        if tag not in NETS:
            raise SystemExit(f"unknown net {tag}; one of {sorted(NETS)}")
    for tag in tags:
        print(json.dumps({tag: reckon(tag)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
