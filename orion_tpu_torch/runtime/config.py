"""Configuration parsing.

Counterpart of `orion_tpu/runtime/config.py`: the same YAML schema
(`ckks_params` / `boot_params` / `orion` sections) and the same files in
`configs/`, accepted unchanged (`backend: tpu` included: there is one
backend per package).  Moduli wider than 30 bits are split into several
<=30-bit primes; the extra limbs of a split q_0 become a `base_level` floor
below which ciphertexts never rescale.  `boot_params` and the
ConjugateInvariant ring are refused until their slices are ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def split_modulus(bits: int) -> list[int]:
    """Split a modulus wider than 30 bits into near-equal <=30-bit parts."""
    if bits <= 30:
        return [bits]
    parts = math.ceil(bits / 30)
    base = bits // parts
    rem = bits - base * parts
    return [base + (1 if i < rem else 0) for i in range(parts)]


@dataclass
class Params:
    # ckks params
    logn: int = 13
    logq: list = field(default_factory=lambda: [29, 26, 26, 26, 26, 26])
    logp: list = field(default_factory=lambda: [29, 29])
    logscale: int = 26
    h: int = 8192
    ring_type: str = "standard"
    # orion params
    margin: float = 2.0
    embedding_method: str = "hybrid"
    backend: str = "tpu"
    fuse_modules: bool = True
    debug: bool = False
    io_mode: str = "none"
    seed: int = 0

    # derived
    split_logq: list = field(default_factory=list)
    base_level: int = 0

    @property
    def n(self):
        return 1 << self.logn

    @property
    def slots(self):
        return self.n // 2   # standard ring: N/2 complex slots

    @property
    def l_eff(self):
        return len(self.logq) - 1

    @property
    def max_level(self):
        return len(self.split_logq) - 1


def parse_config(config: dict) -> Params:
    ckks = config.get("ckks_params", {})
    orion_cfg = config.get("orion", {})
    boot = config.get("boot_params", {})

    p = Params()
    p.logn = int(ckks.get("LogN", p.logn))
    p.logq = list(ckks.get("LogQ", p.logq))
    p.logp = list(ckks.get("LogP", p.logp))
    p.logscale = int(ckks.get("LogScale", p.logscale))
    p.h = int(ckks.get("H", p.h))
    ring = str(ckks.get("RingType", "Standard")).lower().replace("_", "")
    if ring == "conjugateinvariant":
        raise NotImplementedError(
            "RingType ConjugateInvariant is not ported yet; use Standard")
    if ring != "standard":
        raise ValueError(f"unknown RingType {ring!r}")
    if boot:
        raise NotImplementedError(
            "boot_params: bootstrapping is not ported yet")

    p.margin = float(orion_cfg.get("margin", p.margin))
    p.embedding_method = str(
        orion_cfg.get("embedding_method", p.embedding_method))
    p.backend = str(orion_cfg.get("backend", "tpu"))
    p.fuse_modules = bool(orion_cfg.get("fuse_modules", True))
    p.debug = bool(orion_cfg.get("debug", False))
    p.io_mode = str(orion_cfg.get("io_mode", "none"))
    if p.io_mode != "none":
        raise NotImplementedError(
            f"io_mode {p.io_mode!r}: key/diagonal I/O is not ported yet")
    p.seed = int(orion_cfg.get("seed", 0))

    # split wide moduli for the kernels' 32-bit arithmetic; q_0's extra
    # limbs set base_level
    q0_parts = split_modulus(p.logq[0])
    rest = []
    for b in p.logq[1:]:
        parts = split_modulus(b)
        if len(parts) > 1:
            raise ValueError(
                f"LogQ entry {b} > 30 beyond q0 is not supported with 32-bit "
                "residues; use more <=30-bit primes instead")
        rest.extend(parts)
    p.split_logq = q0_parts + rest
    p.base_level = len(q0_parts) - 1

    split_logp = []
    for b in p.logp:
        split_logp.extend(split_modulus(b))
    p.logp = split_logp
    return p
