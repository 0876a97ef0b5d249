"""Wrappers of the `ntt_fwd` / `ntt_inv` kernels (`csrc/ntt.cu`).

`ntt_fwd(a, rr)` / `ntt_inv(a, rr)` transform the last axis of
(..., L, N) int64 residues whose limb axis matches the L rows of the
table set `rr` (a `crypto.keyswitch.RingRows`).  On a CUDA tensor they
launch the kernel, one thread-block cluster of `cluster_size(logn)` CTAs
per row (`csrc/cluster_ntt.cuh`), or raise; on a CPU tensor they run the
plain version below, the four-step torch transform of `crypto/ntt4.py`.

On the ConjugateInvariant ring (`rr.ci`) rows hold n residues and the
tables are the 2n lift's.  The same C entry points then get the CI map
(a null map pointer selects the standard form) and are counted apart as
`ntt_fwd_ci` / `ntt_inv_ci`: the forward's load forms the antisymmetric
2n lift of the n stored residues and its store keeps the n orbit
positions (`ci.pos`); the inverse's load gathers the 2n positions through
`ci.src` and its store keeps the first n coefficients.  The plain
versions are `crypto/ntt.py`'s `ci_ntt` / `ci_intt`.  No forward on the
CI ring calls these two standalone: its transforms run inside the
rescale epilogues and the key-switch kernels, and `ring_ntt` /
`ring_intt` reach them only from bootstrapping, which the CI ring
refuses.

The kernels read the twiddles packed (`pack_twiddles`): each with its
Shoup companion in one 64-bit word, in the order a transform reads them:
the single-block core of `csrc/modarith.cuh` (the standard ring's
key-switch kernels) or the cluster split of `csrc/cluster_ntt.cuh` (this
module's kernels, the rescale epilogues of `rescale.py` and the CI forms
of the key-switch kernels).  `packed_twiddles(rr)` and
`cluster_twiddles(rr)` build both once per table set from its
`tw`/`tw_shoup`/`itw`/`itw_shoup` and cache them in `rr.kernel_tables`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..crypto.ntt import ci_intt, ci_ntt
from ..crypto.ntt4 import intt4, ntt4
from ._launch import Kernel, check_residues

NTT_FWD = Kernel(
    "ntt_fwd", "ntt.cu", "orion_ntt_fwd", "ppiiippp",
    "orion_tpu/crypto/ks_pallas.py:351 pallas_ntt4 (_kntt :82); "
    "orion_tpu/crypto/ntt_pallas.py:247 PallasNTT.ntt (_fwd_kernel :90)")
NTT_INV = Kernel(
    "ntt_inv", "ntt.cu", "orion_ntt_inv", "ppiiippppp",
    "orion_tpu/crypto/ks_pallas.py:387 pallas_intt4 (_kintt :106); "
    "orion_tpu/crypto/ntt_pallas.py:251 PallasNTT.intt (_inv_kernel :126)")
NTT_FWD_CI = Kernel(
    "ntt_fwd_ci", "ntt.cu", "orion_ntt_fwd", "ppiiippp",
    "orion_tpu/crypto/ks_pallas.py:351 pallas_ntt4 (_kntt :82) with the "
    "CI lift and keep of orion_tpu/crypto/keyswitch.py:235 ring_ntt")
NTT_INV_CI = Kernel(
    "ntt_inv_ci", "ntt.cu", "orion_ntt_inv", "ppiiippppp",
    "orion_tpu/crypto/ks_pallas.py:387 pallas_intt4 (_kintt :106) with the "
    "CI gather and projection of orion_tpu/crypto/keyswitch.py:254 "
    "ring_intt")


def split_logc(logn: int) -> int:
    """log2 of the CTAs per row of the cluster transforms: `Split<LOGN>`
    of csrc/cluster_ntt.cuh (1 CTA up to LogN 10, then sub-rows of 1024
    residues, at most 8 CTAs)."""
    return 0 if logn <= 10 else min(logn - 10, 3)


def cluster_size(logn: int) -> int:
    """CTAs per row that the built cluster kernels launch at a transform of
    2^logn points: `ntt.cu`'s, and the CI key-switch forms', which split
    their rows by the same `Split<LOGN>` of csrc/cluster_ntt.cuh (its
    compiled `C`)."""
    from . import _build

    return int(_build.load(NTT_FWD.source).orion_ntt_cluster_size(logn))


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


@lru_cache(maxsize=None)
def _split_order(logn: int, logc: int) -> np.ndarray:
    """The read order of a row split over 2^logc CTAs: segment k of M =
    N / 2^logc slots is sub-row k's local merged table twk[t] =
    tw[2^(logc+u) + k*2^u + h] (t = 2^u + h) in the core's order at size
    M, and its slot 0 holds the cross-stage twiddle tw[k]."""
    if logc == 0:
        return _pack_order(logn)
    logm = logn - logc
    loc = _pack_order(logm)
    u = np.zeros_like(loc)
    u[1:] = np.frexp(loc[1:])[1] - 1        # floor(log2 t), exact
    k = np.arange(1 << logc)[:, None]
    order = loc[None, :] + ((1 << logc) + k - 1) * (1 << u)[None, :]
    order[:, 0] = k[:, 0]
    return order.ravel()


def pack_twiddles(tw, tw_sh, logc: int = 0) -> torch.Tensor:
    """(L, N) twiddles and Shoup companions -> (L, N) int64 words
    w | w_sh << 32, in the read order of a row split over 2^logc CTAs
    (0: the single-block core)."""
    n = tw.shape[-1]
    order = _split_order(n.bit_length() - 1, logc)
    w = tw.cpu().numpy().astype(np.uint64)[:, order]
    w_sh = tw_sh.cpu().numpy().astype(np.uint64)[:, order]
    packed = np.ascontiguousarray((w | (w_sh << np.uint64(32))).view(np.int64))
    return torch.as_tensor(packed, device=tw.device)


def packed_twiddles(rr) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, inverse) packed tables of the table set `rr` in the
    single-block core's order (the standard ring's key-switch kernels),
    cached."""
    kt = rr.kernel_tables
    if "twp" not in kt:
        kt["twp"] = pack_twiddles(rr.tw, rr.tw_shoup)
        kt["itwp"] = pack_twiddles(rr.itw, rr.itw_shoup)
    return kt["twp"], kt["itwp"]


def cluster_twiddles(rr) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, inverse) packed tables of `rr` in the cluster split's
    order (this module's kernels, the rescale epilogues and the CI forms of
    the key-switch kernels), cached; the core's tables where a row is one
    CTA."""
    kt = rr.kernel_tables
    if "twc" not in kt:
        logc = split_logc(rr.tw.shape[-1].bit_length() - 1)
        if logc == 0:
            kt["twc"], kt["itwc"] = packed_twiddles(rr)
        else:
            kt["twc"] = pack_twiddles(rr.tw, rr.tw_shoup, logc)
            kt["itwc"] = pack_twiddles(rr.itw, rr.itw_shoup, logc)
    return kt["twc"], kt["itwc"]


def ntt_fwd_plain(a, rr):
    if rr.ci is not None:
        return ci_ntt(a, rr.t4, rr.p, rr.ci)
    return ntt4(a, rr.t4, rr.p)


def ntt_inv_plain(a, rr):
    if rr.ci is not None:
        return ci_intt(a, rr.t4, rr.ninv, rr.p, rr.ci)
    return intt4(a, rr.t4, rr.ninv, rr.p)


def _rows(name, a, rr):
    L, n = rr.p.shape[0], rr.width
    if a.dim() < 2 or a.shape[-2] != L or a.shape[-1] != n:
        raise ValueError(f"{name}: input {tuple(a.shape)} does not end in "
                         f"the table's ({L}, {n})")
    check_residues(name, a, a.shape)
    return a.numel() // n, L, rr.logn


def ntt_fwd(a, rr):
    """Forward negacyclic NTT (standard -> bit-reversed order); on the CI
    ring through the 2n lift (the kernel's CI map)."""
    if a.device.type == "cpu":
        return ntt_fwd_plain(a, rr)
    k = NTT_FWD if rr.ci is None else NTT_FWD_CI
    rows, L, logn = _rows(k.name, a, rr)
    out = torch.empty_like(a)
    k.launch(a.device, out, a, rows, L, logn, rr.p, cluster_twiddles(rr)[0],
             None if rr.ci is None else rr.ci.pos, items=rows)
    return out


def ntt_inv(a, rr):
    """Inverse negacyclic NTT (bit-reversed -> standard order, times n^-1);
    on the CI ring through the 2n lift (the kernel's CI map)."""
    if a.device.type == "cpu":
        return ntt_inv_plain(a, rr)
    k = NTT_INV if rr.ci is None else NTT_INV_CI
    rows, L, logn = _rows(k.name, a, rr)
    out = torch.empty_like(a)
    k.launch(a.device, out, a, rows, L, logn, rr.p, cluster_twiddles(rr)[1],
             rr.ninv, rr.ninv_shoup, None if rr.ci is None else rr.ci.src,
             items=rows)
    return out
