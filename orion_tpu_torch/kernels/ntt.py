"""Wrappers of the `ntt_fwd` / `ntt_inv` kernels (`csrc/ntt.cu`).

`ntt_fwd(a, rr)` / `ntt_inv(a, rr)` transform the last axis of
(..., L, N) int64 residues whose limb axis matches the L rows of the
table set `rr` (a `crypto.keyswitch.RingRows`).  On a CUDA tensor they
launch the kernel or raise; on a CPU tensor they run the plain version
below, the four-step torch transform of `crypto/ntt4.py`.

The kernels read the twiddles packed (`pack_twiddles`): each with its
Shoup companion in one 64-bit word, in the order the transform core of
`csrc/modarith.cuh` reads them.  `packed_twiddles(rr)` builds them once per
table set from its `tw`/`tw_shoup`/`itw`/`itw_shoup` and caches them in
`rr.kernel_tables`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..crypto.ntt4 import intt4, ntt4
from ._launch import Kernel, check_residues

NTT_FWD = Kernel(
    "ntt_fwd", "ntt.cu", "orion_ntt_fwd", "ppiiipp",
    "orion_tpu/crypto/ks_pallas.py:351 pallas_ntt4 (_kntt :82); "
    "orion_tpu/crypto/ntt_pallas.py:247 PallasNTT.ntt (_fwd_kernel :90)")
NTT_INV = Kernel(
    "ntt_inv", "ntt.cu", "orion_ntt_inv", "ppiiipppp",
    "orion_tpu/crypto/ks_pallas.py:387 pallas_intt4 (_kintt :106); "
    "orion_tpu/crypto/ntt_pallas.py:251 PallasNTT.intt (_inv_kernel :126)")


def _passes(logn: int) -> list[tuple[int, int]]:
    """(first stage, stage count) of each pass of the core (modarith.cuh
    `Ring`): at most log2(R) stages per pass, the short pass first."""
    logr = 4 if logn >= 14 else 3
    count = -(-logn // logr)
    first = logn - logr * (count - 1)
    out, a = [], 0
    for s in [first] + [logr] * (count - 1):
        out.append((a, s))
        a += s
    return out


@lru_cache(maxsize=None)
def _pack_order(logn: int) -> np.ndarray:
    """order[k] = the merged-table index the core reads at packed slot k:
    for the pass over stages [a, a+s) and the group `hi`, stage a+u's
    twiddles tw[2^(a+u) + hi*2^u + m] sit contiguous at 2^a + hi*(2^s-1)
    + 2^u - 1 + m.  Slot 0 is unused (index 0)."""
    order = np.zeros(1 << logn, np.int64)
    for a, s in _passes(logn):
        hi = np.arange(1 << a)[:, None]
        for u in range(s):
            m = np.arange(1 << u)[None, :]
            slot = (1 << a) + hi * ((1 << s) - 1) + (1 << u) - 1 + m
            order[slot.ravel()] = ((1 << (a + u)) + hi * (1 << u) + m).ravel()
    return order


def pack_twiddles(tw, tw_sh) -> torch.Tensor:
    """(L, N) twiddles and Shoup companions -> (L, N) int64 words
    w | w_sh << 32, in the core's read order."""
    n = tw.shape[-1]
    order = _pack_order(n.bit_length() - 1)
    w = tw.cpu().numpy().astype(np.uint64)[:, order]
    w_sh = tw_sh.cpu().numpy().astype(np.uint64)[:, order]
    packed = np.ascontiguousarray((w | (w_sh << np.uint64(32))).view(np.int64))
    return torch.as_tensor(packed, device=tw.device)


def packed_twiddles(rr) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, inverse) packed tables of the table set `rr`, cached."""
    kt = rr.kernel_tables
    if "twp" not in kt:
        kt["twp"] = pack_twiddles(rr.tw, rr.tw_shoup)
        kt["itwp"] = pack_twiddles(rr.itw, rr.itw_shoup)
    return kt["twp"], kt["itwp"]


def ntt_fwd_plain(a, rr):
    return ntt4(a, rr.t4, rr.p)


def ntt_inv_plain(a, rr):
    return intt4(a, rr.t4, rr.ninv, rr.p)




def _rows(name, a, rr):
    L, n = rr.tw.shape
    if a.dim() < 2 or a.shape[-2] != L or a.shape[-1] != n:
        raise ValueError(f"{name}: input {tuple(a.shape)} does not end in "
                         f"the table's ({L}, {n})")
    check_residues(name, a, a.shape)
    return a.numel() // n, L, n.bit_length() - 1


def ntt_fwd(a, rr):
    """Forward negacyclic NTT (standard -> bit-reversed order)."""
    if a.device.type == "cpu":
        return ntt_fwd_plain(a, rr)
    rows, L, logn = _rows(NTT_FWD.name, a, rr)
    out = torch.empty_like(a)
    NTT_FWD.launch(a.device, out, a, rows, L, logn,
                   rr.p, packed_twiddles(rr)[0], items=rows)
    return out


def ntt_inv(a, rr):
    """Inverse negacyclic NTT (bit-reversed -> standard order, times n^-1)."""
    if a.device.type == "cpu":
        return ntt_inv_plain(a, rr)
    rows, L, logn = _rows(NTT_INV.name, a, rr)
    out = torch.empty_like(a)
    NTT_INV.launch(a.device, out, a, rows, L, logn,
                   rr.p, packed_twiddles(rr)[1], rr.ninv, rr.ninv_shoup,
                   items=rows)
    return out
