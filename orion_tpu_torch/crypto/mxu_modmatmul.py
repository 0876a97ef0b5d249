"""Modular matrix multiply through int8 digit planes.

Counterpart of `orion_tpu/crypto/mxu_modmatmul.py`, the candidate
matrix-unit form of the four-step NTT.  Both operands are decomposed into
balanced radix-256 digits,

    W = sum_d 2^(8d) W_d,  X = sum_e 2^(8e) X_e,   W_d, X_e in [-128,127]
    W @ X = sum_k 2^(8k) P_k,   P_k = sum_{d+e=k} W_d @ X_e,

the 16 digit-pair products are ONE int8 matrix product of the stacked
digit planes, (4m, m) @ (m, 4n) -> (4m, 4n) int32, and the k-plane
recombination sum_k (P_k + off) * (2^(8k) mod p) - off * sum_k c_k runs
as 7 Shoup multiplies per element on the int64 residues.

orion_tpu computes the digit product with `jax.lax.dot_general` outside
any Pallas kernel; on the card the port uses PyTorch's int8 tensor-core
product (`torch._int_mm`, which wants more than 16 rows and a multiple of
8 for the inner and column sizes: the planes are zero-padded to them),
and on the CPU a plain int32 matrix product, which gives the same exact
sums.  orion_tpu measured the recombination to cost more than the
butterflies it would replace for 26-29-bit primes, so no transform uses
it; it is kept, bit-exact, as the primitive (ROADMAP, tensor-core NTTs).
"""

from __future__ import annotations

import numpy as np
import torch

from . import placement
from .modops import add_mod, shoup_mul, sub_mod


def _balanced_digits_np(x: np.ndarray, ndig: int = 4) -> np.ndarray:
    """Residues -> (ndig, ...) int8 balanced radix-256 digits (numpy,
    for constant matrices)."""
    x = np.asarray(x).astype(np.int64)
    digs = []
    for _ in range(ndig):
        d = x & 0xFF
        d = np.where(d > 127, d - 256, d)
        x = (x - d) >> 8
        digs.append(d.astype(np.int8))
    if not np.all(x == 0):
        raise ValueError("values need more digits")
    return np.stack(digs)


def balanced_digits(x: torch.Tensor, ndig: int = 4) -> torch.Tensor:
    """Residues (int64 tensor, values < 2^31) -> (ndig, ...) int8 balanced
    radix-256 digits."""
    digs = []
    for _ in range(ndig):
        d = x & 0xFF
        d = torch.where(d > 127, d - 256, d)
        x = (x - d) >> 8
        digs.append(d.to(torch.int8))
    return torch.stack(digs)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 (M, K) and (K, N) matrices."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a, b)[:m, :n]


class ModMatmulPlan:
    """Precomputed per-prime tables for Y = W @ X mod p."""

    def __init__(self, W: np.ndarray, p: int, ndig: int = 4, device=None):
        dev = placement.resolve_device(device)
        W = np.asarray(W, dtype=np.uint64) % p
        self.p = int(p)
        self.m = W.shape[0]
        self.ndig = ndig
        self.nk = 2 * ndig - 1
        # stacked digit planes: (ndig*m, m) int8
        Wd = _balanced_digits_np(W.astype(np.int64), ndig)
        self.Wd = torch.as_tensor(Wd.reshape(ndig * self.m, self.m),
                                  device=dev)
        # per-k recombination constants 2^(8k) mod p with Shoup companions
        ck = [pow(256, k, p) for k in range(self.nk)]
        self.ck = ck
        self.ck_shoup = [(c << 32) // p for c in ck]
        # offset making P_k non-negative before the Shoup multiply:
        # |P_k| <= m * 128^2 * min(k+1, nk-k) <= m * 128^2 * ndig
        bound = self.m * 128 * 128 * ndig
        off = ((bound + p - 1) // p) * p
        if off + bound >= 1 << 31:
            raise ValueError("digit-product bound exceeds int32")
        self.off = off
        # correction: off * sum_k c_k mod p, subtracted once at the end
        self.corr = (off % p) * (sum(ck) % p) % p

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        """X: (m, n) int64 residues mod p, on the plan's device ->
        W @ X mod p, (m, n) int64."""
        m, n = X.shape
        ndig, nk = self.ndig, self.nk
        Xd = balanced_digits(X, ndig)                    # (ndig, m, n)
        Xs = torch.cat(list(Xd), dim=1)                  # (m, ndig*n)
        # ONE int8 product -> every digit-pair product, int32 sums
        P = _int8_matmul(self.Wd, Xs).reshape(ndig, m, ndig, n)
        out = None
        for k in range(nk):
            sk = None
            for d in range(ndig):
                e = k - d
                if 0 <= e < ndig:
                    blk = P[d, :, e, :].to(torch.int64)
                    sk = blk if sk is None else sk + blk
            term = shoup_mul(sk + self.off, self.ck[k], self.ck_shoup[k],
                             self.p)
            out = term if out is None else add_mod(out, term, self.p)
        return sub_mod(out, self.corr, self.p)
