"""Wrappers of the `ntt_fwd` / `ntt_inv` kernels (`csrc/ntt.cu`).

`ntt_fwd(a, rr)` / `ntt_inv(a, rr)` transform the last axis of
(..., L, N) int64 residues whose limb axis matches the L rows of the
table set `rr` (a `crypto.keyswitch.RingRows`).  On a CUDA tensor they
launch the kernel or raise; on a CPU tensor they run the plain version
below, the four-step torch transform of `crypto/ntt4.py`.
"""

from __future__ import annotations

import torch

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
    NTT_FWD.launch(a.device, out, a, rows, L, logn, rr.p, rr.tw,
                   rr.tw_shoup)
    return out


def ntt_inv(a, rr):
    """Inverse negacyclic NTT (bit-reversed -> standard order, times n^-1)."""
    if a.device.type == "cpu":
        return ntt_inv_plain(a, rr)
    rows, L, logn = _rows(NTT_INV.name, a, rr)
    out = torch.empty_like(a)
    NTT_INV.launch(a.device, out, a, rows, L, logn, rr.p, rr.itw,
                   rr.itw_shoup, rr.ninv, rr.ninv_shoup)
    return out
