"""Modular arithmetic on int64 residue tensors (plain PyTorch).

Counterpart of `orion_tpu/crypto/modops.py`.  Residues are `torch.int64`
in [0, p) with every prime p < 2^31, so the product of two residues is
below 2^62 and a plain `(a * b) % p` is exact.  Shoup and Montgomery
products return the exact residue, so computing them this way gives the
same bits as the 32-bit formulations the CUDA kernels use
(`kernels/csrc/modarith.cuh`); the companion arguments are kept in the
signatures so call sites read like the kernels' arithmetic.

torch's CPU uint32 has no add, shift or compare, which is why the plain
path works in int64 on both devices.
"""

from __future__ import annotations

import torch


def add_mod(a, b, p):
    s = a + b
    return torch.where(s >= p, s - p, s)


def sub_mod(a, b, p):
    d = a - b
    return torch.where(d < 0, d + p, d)


def neg_mod(a, p):
    return torch.where(a == 0, a, p - a)


def shoup_mul(a, c, c_shoup, p):
    """a * c mod p for a constant c with Shoup companion c_shoup
    (floor(c * 2^32 / p)); the exact residue, so c_shoup is not read."""
    return a * c % p


def mont_mul(a, b, p, pinv):
    """Montgomery product a * b * 2^-32 mod p (pinv = -p^-1 mod 2^32).

    Computed as a * b * [2^-32]_p, the residue the kernels' 32-bit REDC
    returns.  Since p * pinv = -1 mod 2^32, (1 + pinv * p) / 2^32 is an
    integer below p congruent to 2^-32 (and pinv * p < 2^63 fits int64)."""
    rinv = (1 + pinv * p) >> 32
    return (a * b % p) * rinv % p


def to_mont(a, r_mod, r_shoup, p):
    """Lift a to the Montgomery domain: a * 2^32 mod p."""
    return shoup_mul(a, r_mod, r_shoup, p)


def mul_mod(a, b, p, pinv=None, r_mod=None, r_shoup=None):
    """a * b mod p for two variable operands (both in the normal domain):
    the kernels' Montgomery lift followed by a Montgomery product."""
    return a * b % p


def shoup_precompute(c: int, p: int) -> int:
    """Host-side Shoup companion for constant c mod p."""
    return (int(c) << 32) // int(p)
