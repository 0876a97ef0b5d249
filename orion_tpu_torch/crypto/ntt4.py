"""Four-step negacyclic NTT as plain PyTorch ops (int64 residues).

Counterpart of `orion_tpu/crypto/ntt4.py`: the same factorisation of the
merged-psi Cooley-Tukey transform, with the length-N poly viewed as an
(R, 128) tile, R = N/128:

  forward (standard order -> bit-reversed):
    1. logR row stages (butterflies pair rows; per-row twiddles),
    2. a pointwise twist T[r, c] = psi^(2 br_R(r) c),
    3. transpose, 7 lane stages with per-lane twiddles, transpose back.
  inverse: lane stages (Gentleman-Sande), inverse twist, row stages, n^-1.

Modular arithmetic is exact, so the output equals the radix-2 loop's
(`crypto/ref.py`) and the CUDA kernels' (`kernels/csrc/modarith.cuh`) bit for
bit.  This module is the plain version of the `ntt_fwd` / `ntt_inv`
kernels (`kernels/ntt.py`); on a CUDA tensor it still runs as torch ops,
which is how the kernels are checked on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .modops import add_mod, sub_mod

_LANE = 128


def _pow_table(psi: int, p: int, count: int) -> np.ndarray:
    """psi^0..psi^(count-1) mod p via vectorised doubling (u64-safe)."""
    pw = np.ones(1, np.uint64)
    psi = int(psi) % p
    while pw.size < count:
        mult = pow(psi, int(pw.size), p)
        pw = np.concatenate([pw, pw * np.uint64(mult) % np.uint64(p)])
    return pw[:count].astype(np.uint32)


def _brev(x: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x = x >> 1
    return out


def build_t4_tables(tw: np.ndarray, itw: np.ndarray, psis, primes,
                    logn: int) -> dict[str, np.ndarray]:
    """Host-side four-step tables for all limbs.

    tw/itw: (n_all, N) merged-psi twiddles (tw[i, j] = psi_i^bitrev(j)),
    N >= 256 (the transpose split needs at least 2 rows of 128 lanes).
    Returns dict of (n_all, ...) uint32 arrays.  The plain version
    multiplies with `%`, so no Shoup companions are built.
    """
    n = 1 << logn
    R = n // _LANE
    logR = logn - 7
    L = tw.shape[0]

    r_idx = np.arange(R)
    c_idx = np.arange(_LANE)
    br_r = _brev(r_idx, logR)

    rowtw = np.zeros((L, logR, R), np.uint32)
    lanetw = np.zeros((L, 7, _LANE), np.uint32)
    twist = np.zeros((L, R, _LANE), np.uint32)
    i_lanetw = np.zeros((L, 7, _LANE), np.uint32)
    i_twist = np.zeros((L, R, _LANE), np.uint32)
    i_rowtw = np.zeros((L, logR, R), np.uint32)

    texp = (2 * br_r[:, None] * c_idx[None, :]) % (2 * n)

    for li in range(L):
        p = int(primes[li])
        pw = _pow_table(psis[li], p, 2 * n)
        for s in range(logR):
            rowtw[li, s] = tw[li, (1 << s) + (r_idx >> (logR - s))]
            m = R >> (s + 1)
            i_rowtw[li, s] = itw[li, m + (r_idx >> (s + 1))]
        for k in range(7):
            s = logR + k
            lanetw[li, k] = tw[li, (1 << s) + (c_idx >> (7 - k))]
            m = n >> (k + 1)
            i_lanetw[li, k] = itw[li, m + (c_idx >> (k + 1))]
        twist[li] = pw[texp]
        i_twist[li] = pw[(2 * n - texp) % (2 * n)]

    return {"rowtw": rowtw, "lanetw": lanetw, "twist": twist,
            "i_lanetw": i_lanetw, "i_twist": i_twist, "i_rowtw": i_rowtw}


def ntt4(a, t4: dict, p):
    """Forward negacyclic NTT over the last axis of (..., L, N)."""
    *batch, L, N = a.shape
    R = N // _LANE
    logR = R.bit_length() - 1
    a = a.reshape(*batch, L, R, _LANE)
    p2 = p.reshape(L, 1, 1)
    p4 = p.reshape(L, 1, 1, 1)

    for s in range(logR):
        m = 1 << s
        tr = R >> (s + 1)
        v = a.reshape(*batch, L, m, 2, tr, _LANE)
        w = t4["rowtw"][:, s].reshape(L, m, 2, tr, 1)[:, :, 1]
        even = v[..., 0, :, :]
        odd = v[..., 1, :, :] * w % p4
        a = torch.stack([add_mod(even, odd, p4), sub_mod(even, odd, p4)],
                        dim=-3).reshape(*batch, L, R, _LANE)

    a = a * t4["twist"] % p2
    a = a.transpose(-1, -2)  # (..., L, LANE, R)

    for k in range(7):
        t = _LANE >> (k + 1)
        gc = 1 << k
        v = a.reshape(*batch, L, gc, 2, t, R)
        w = t4["lanetw"][:, k].reshape(L, gc, 2, t, 1)[:, :, 1]
        even = v[..., 0, :, :]
        odd = v[..., 1, :, :] * w % p4
        a = torch.stack([add_mod(even, odd, p4), sub_mod(even, odd, p4)],
                        dim=-3).reshape(*batch, L, _LANE, R)

    return a.transpose(-1, -2).reshape(*batch, L, N)


def intt4(a, t4: dict, ninv, p):
    """Inverse negacyclic NTT over the last axis of (..., L, N)."""
    *batch, L, N = a.shape
    R = N // _LANE
    logR = R.bit_length() - 1
    p2 = p.reshape(L, 1, 1)
    p4 = p.reshape(L, 1, 1, 1)
    a = a.reshape(*batch, L, R, _LANE).transpose(-1, -2)  # (..., L, LANE, R)

    for k in range(7):
        t = 1 << k
        gc = _LANE >> (k + 1)
        v = a.reshape(*batch, L, gc, 2, t, R)
        w = t4["i_lanetw"][:, k].reshape(L, gc, 2, t, 1)[:, :, 1]
        u = v[..., 0, :, :]
        x = v[..., 1, :, :]
        a = torch.stack([add_mod(u, x, p4), sub_mod(u, x, p4) * w % p4],
                        dim=-3).reshape(*batch, L, _LANE, R)

    a = a.transpose(-1, -2)  # (..., L, R, LANE)
    a = a * t4["i_twist"] % p2

    for k in range(logR):
        rk = 1 << k
        m = R >> (k + 1)
        v = a.reshape(*batch, L, m, 2, rk, _LANE)
        w = t4["i_rowtw"][:, k].reshape(L, m, 2, rk, 1)[:, :, 1]
        u = v[..., 0, :, :]
        x = v[..., 1, :, :]
        a = torch.stack([add_mod(u, x, p4), sub_mod(u, x, p4) * w % p4],
                        dim=-3).reshape(*batch, L, R, _LANE)

    return a.reshape(*batch, L, N) * ninv.reshape(L, 1) % p.reshape(L, 1)
