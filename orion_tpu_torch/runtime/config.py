"""Configuration parsing.

Counterpart of `orion_tpu/runtime/config.py`: the same YAML schema
(`ckks_params` / `boot_params` / `orion` sections) and the same files in
`configs/`, accepted unchanged (`backend: tpu` included: there is one
backend per package).  Moduli wider than 30 bits are split into several
<=30-bit primes; the extra limbs of a split q_0 become a `base_level` floor
below which ciphertexts never rescale.  `boot_params` appends the
bootstrap circuit's primes above the user chain and its `LogP` joins the
special primes, as orion_tpu does.

`io_mode`: `none`, `stream`, `save` and `load`.  `stream` spills each
module's compiled buffers to pinned host memory after it compiles and
brings them back around its forward under a residency budget
(`runtime/buffers.py`), as orion_tpu's stream mode does.  `save` and
`load` write and read the keys (`keys_path`) and the packed diagonals
(`diags_path`) as numpy archives (`runtime/io.py`).  `RingType:
ConjugateInvariant` gives N real slots; bootstrapping on it is refused,
as orion_tpu refuses it.
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
    # boot params
    boot_logp: list = field(default_factory=list)
    boot: dict = field(default_factory=dict)  # circuit knobs (or {} = none)
    # orion params
    margin: float = 2.0
    embedding_method: str = "hybrid"
    backend: str = "tpu"
    fuse_modules: bool = True
    debug: bool = False
    io_mode: str = "none"
    diags_path: str = ""
    keys_path: str = ""
    seed: int = 0

    # derived
    split_logq: list = field(default_factory=list)
    base_level: int = 0

    @property
    def n(self):
        return 1 << self.logn

    @property
    def slots(self):
        # ConjugateInvariant: all-real slots = N; standard: N/2 complex
        if self.ring_type == "conjugate_invariant":
            return self.n
        return self.n // 2

    @property
    def l_eff(self):
        return len(self.logq) - 1

    @property
    def max_level(self):
        return len(self.split_logq) - 1

    @property
    def default_scale(self):
        return float(1 << self.logscale)


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
        p.ring_type = "conjugate_invariant"
    elif ring == "standard":
        p.ring_type = "standard"
    else:
        raise ValueError(f"unknown RingType {ring!r}")
    p.boot_logp = list(boot.get("LogP", []))
    if boot:
        from ..crypto.polyeval import hi_scale_depth
        mod_degree = int(boot.get("ModDegree", 255))
        # circuit primes are full-width 30-bit by default: EvalMod runs at
        # W = 2^60, which keeps the key-switch noise amplified by the
        # beta-folded coefficients (crypto/bootstrap.py) below the noise
        # floor even for a wide (split) q0
        circuit_logq = min(30, int(boot.get("CircuitLogQ", 30)))
        # StC sheds the W -> Delta boost through its stage pt scales; cap
        # the per-stage shed at ~9 bits (one more circuit prime each)
        shed_bits = 2 * circuit_logq - p.logscale
        min_stc = max(1, math.ceil(shed_bits / 9))
        p.boot = {
            "CtSLevels": int(boot.get("CtSLevels", 3)),
            "StCLevels": max(int(boot.get("StCLevels", 3)), min_stc),
            "ModDegree": mod_degree,
            "K": int(boot.get("K", 16)),
            "MsgRatio": int(boot.get("MsgRatio", 256)),
            "ModDepth": hi_scale_depth(mod_degree),
            "CircuitLogQ": circuit_logq,
        }

    if p.boot and p.ring_type == "conjugate_invariant":
        raise NotImplementedError(
            "bootstrapping on the ConjugateInvariant ring is not "
            "implemented; use the standard ring for bootstrapped networks")

    p.margin = float(orion_cfg.get("margin", p.margin))
    p.embedding_method = str(
        orion_cfg.get("embedding_method", p.embedding_method))
    p.backend = str(orion_cfg.get("backend", "tpu"))
    p.fuse_modules = bool(orion_cfg.get("fuse_modules", True))
    p.debug = bool(orion_cfg.get("debug", False))
    p.io_mode = str(orion_cfg.get("io_mode", "none"))
    p.diags_path = str(orion_cfg.get("diags_path", "") or "")
    p.keys_path = str(orion_cfg.get("keys_path", "") or "")
    if p.io_mode in ("save", "load") and p.keys_path \
            and p.keys_path == p.diags_path:
        raise ValueError(
            "keys_path and diags_path name one file: the port writes the "
            "keys and the diagonals to one numpy archive each")
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

    # bootstrap circuit primes live ABOVE the user chain so a bootstrap
    # refreshes back to the top of LogQ
    if p.boot:
        n_circuit = (p.boot["CtSLevels"] + p.boot["StCLevels"]
                     + p.boot["ModDepth"] + 2)
        p.split_logq = p.split_logq + [p.boot["CircuitLogQ"]] * n_circuit

    # `boot_params: LogP` extends the special primes (the hybrid
    # key-switch basis), as in orion_tpu
    split_logp = []
    for b in p.logp + p.boot_logp:
        split_logp.extend(split_modulus(b))
    p.logp = split_logp
    return p
