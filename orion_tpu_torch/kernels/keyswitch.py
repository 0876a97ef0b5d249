"""Wrappers of the `ks_decompose` and `ks_finish` kernels, with their plain
PyTorch versions.

`ks_decompose(c, dl)`: c (nl, N) NTT domain -> ext (dnum, n_t, N), every
digit converted to the level's n_t = nl + n_sp primes (`csrc/ks_decompose.cu`).
`ks_finish(ext, dl, ksk, ksk_shoup, trimmed)`: key inner product + ModDown
-> (2, nl, N) (`csrc/ks_finish.cu`); full-chain or level-trimmed keys,
Shoup companions or lean (Montgomery) keys.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version in this module, which is the port of
orion_tpu's jnp key-switch (`orion_tpu/crypto/keyswitch.py`).  The plain
versions call the four-step torch transforms directly, so on the card they
stay pure torch ops and can be held against the kernels.
"""

from __future__ import annotations

import torch

from ..crypto.modops import add_mod, sub_mod
from ..crypto.ntt4 import intt4, ntt4
from ._launch import Kernel, check_residues

KS_DECOMPOSE = Kernel(
    "ks_decompose", "ks_decompose.cu", "orion_ks_decompose",
    "ppp" + "iiiii" + "p" * 17,
    "orion_tpu/crypto/ks_pallas.py:717 ks_decompose_pallas "
    "(_decompose_k :201, _fbc_k :174)")
KS_FINISH = Kernel(
    "ks_finish", "ks_finish.cu", "orion_ks_finish",
    "pppppp" + "iiiii" + "p" * 20,
    "orion_tpu/crypto/ks_pallas.py:740 ks_finish_pallas (_finish_k :217), "
    ":592 ks_finish_pallas_grid")


# ------------------------------------------------------------------ #
#  Plain versions                                                    #
# ------------------------------------------------------------------ #

def fbc(z, dg, tgt_p):
    """Convert coeff-domain residues z (alpha, N) in the digit's base to
    the target base (n_t, N).  Approximate HPS with a float32 v-correction
    summed in source order, as orion_tpu's `fbc` and the kernels do."""
    zq = z * dg.qhat_inv % dg.src_p
    zf = zq.to(torch.float32) / dg.src_q_f32
    frac = zf[0]
    for m in range(1, zf.shape[0]):
        frac = frac + zf[m]
    v = torch.round(frac).to(torch.int64)
    acc = None
    for m in range(zq.shape[0]):
        term = zq[m][None] * dg.conv[m] % tgt_p
        acc = term if acc is None else add_mod(acc, term, tgt_p)
    return sub_mod(acc, v[None] * dg.d_mod_t % tgt_p, tgt_p)


def ks_decompose_plain(c_ntt, dl):
    c_coeff = intt4(c_ntt, dl.q.t4, dl.q.ninv, dl.q.p)
    exts = [fbc(c_coeff[dg.src_lo:dg.src_hi], dg, dl.t.p[:, None])
            for dg in dl.digits]
    # one batched NTT over (dnum, n_t, N): every digit's extension shares
    # the target-basis tables
    return ntt4(torch.stack(exts), dl.t.t4, dl.t.p)


def ks_inner(ext, dl, ksk_data, ksk_shoup=None, trimmed=False):
    """Key inner product WITHOUT ModDown: (2, n_t, N) extended-basis acc.
    Shoup and lean keys give the same residues, so ksk_shoup is not read."""
    tp = dl.t.p[:, None]
    acc0 = acc1 = None
    for j in range(len(dl.digits)):
        k0, k1 = ksk_data[j, 0], ksk_data[j, 1]
        if not trimmed:
            k0, k1 = k0[dl.ksk_rows_idx], k1[dl.ksk_rows_idx]
        t0 = ext[j] * k0 % tp
        t1 = ext[j] * k1 % tp
        if acc0 is None:
            acc0, acc1 = t0, t1
        else:
            acc0 = add_mod(acc0, t0, tp)
            acc1 = add_mod(acc1, t1, tp)
    return torch.stack([acc0, acc1])


def mod_down(x, dl):
    """Divide an extended-basis poly (nl + n_sp, N, NTT) by P -> Q base."""
    lvl = dl.level
    qp = dl.q.p[:, None]
    pp_coeff = intt4(x[lvl + 1:], dl.s.t4, dl.s.ninv, dl.s.p)
    lift = fbc(pp_coeff, dl.moddown, qp)
    lift_ntt = ntt4(lift, dl.q.t4, dl.q.p)
    diff = sub_mod(x[: lvl + 1], lift_ntt, qp)
    return diff * dl.pinv_mod_q % qp


def ks_finish_plain(ext, dl, ksk_data, ksk_shoup=None, trimmed=False):
    acc = ks_inner(ext, dl, ksk_data, ksk_shoup, trimmed)
    return torch.stack([mod_down(acc[0], dl), mod_down(acc[1], dl)])


# ------------------------------------------------------------------ #
#  Kernel tables and wrappers                                        #
# ------------------------------------------------------------------ #

def _digit_stack(dl) -> dict:
    """Per-digit conversion constants padded to alpha_max, on the device
    (cached on the level)."""
    kt = dl.kernel_tables
    if "dig" not in kt:
        dev = dl.t.p.device
        dnum = len(dl.digits)
        n_t = dl.t.p.shape[0]
        amax = max(dg.src_hi - dg.src_lo for dg in dl.digits)

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        t = {"lo": z(dnum), "alpha": z(dnum), "qi": z(dnum, amax),
             "qi_sh": z(dnum, amax), "srcp": z(dnum, amax),
             "srcq": torch.ones(dnum, amax, dtype=torch.float32, device=dev),
             "conv": z(dnum, amax, n_t), "conv_sh": z(dnum, amax, n_t),
             "dmod": z(dnum, n_t), "dmod_sh": z(dnum, n_t), "amax": amax}
        for d, dg in enumerate(dl.digits):
            a = dg.src_hi - dg.src_lo
            t["lo"][d] = dg.src_lo
            t["alpha"][d] = a
            t["qi"][d, :a] = dg.qhat_inv[:, 0]
            t["qi_sh"][d, :a] = dg.qhat_inv_shoup[:, 0]
            t["srcp"][d, :a] = dg.src_p[:, 0]
            t["srcq"][d, :a] = dg.src_q_f32[:, 0]
            t["conv"][d, :a] = dg.conv[:, :, 0]
            t["conv_sh"][d, :a] = dg.conv_shoup[:, :, 0]
            t["dmod"][d] = dg.d_mod_t[:, 0]
            t["dmod_sh"][d] = dg.d_mod_t_shoup[:, 0]
        kt["dig"] = t
    return kt["dig"]


def ks_decompose(c_ntt, dl):
    """Digit-decompose c and extend every digit to the full basis."""
    if c_ntt.device.type == "cpu":
        return ks_decompose_plain(c_ntt, dl)
    nl, n = dl.level + 1, dl.ring_n
    n_t = dl.t.p.shape[0]
    dnum = len(dl.digits)
    check_residues(KS_DECOMPOSE.name, c_ntt, (nl, n))
    d = _digit_stack(dl)
    ext = torch.empty((dnum, n_t, n), dtype=torch.int64, device=c_ntt.device)
    coeff = torch.empty((nl, n), dtype=torch.int64, device=c_ntt.device)
    t = dl.t
    KS_DECOMPOSE.launch(
        c_ntt.device, ext, coeff, c_ntt, nl, n_t, dnum, d["amax"],
        n.bit_length() - 1, d["lo"], d["alpha"], d["qi"], d["qi_sh"],
        d["srcp"], d["srcq"], d["conv"], d["conv_sh"], d["dmod"],
        d["dmod_sh"], t.p, t.tw, t.tw_shoup, t.itw, t.itw_shoup, t.ninv,
        t.ninv_shoup)
    return ext


def ks_finish(ext, dl, ksk_data, ksk_shoup=None, trimmed=False):
    """Inner-product the decomposed digits with a KSK and ModDown.

    ext: (dnum, n_t, N); ksk arrays: (dnum_full, 2, n_all, N), or, with
    trimmed=True, already sliced to this level's digits and prime rows
    (dnum, 2, n_t, N).  ksk_shoup=None is a lean key (Montgomery lift).
    Returns (2, level+1, N) in NTT domain.
    """
    if ext.device.type == "cpu":
        return ks_finish_plain(ext, dl, ksk_data, ksk_shoup, trimmed)
    name = KS_FINISH.name
    nl, n = dl.level + 1, dl.ring_n
    n_t = dl.t.p.shape[0]
    dnum = len(dl.digits)
    check_residues(name, ext, (dnum, n_t, n))
    if trimmed:
        krows, row_map = n_t, dl.kernel_row_map(trimmed=True)
        check_residues(name, ksk_data, (dnum, 2, n_t, n))
    else:
        krows, row_map = ksk_data.shape[2], dl.kernel_row_map(trimmed=False)
        if ksk_data.shape[0] < dnum:
            raise ValueError(f"{name}: key has {ksk_data.shape[0]} digits, "
                             f"level {dl.level} needs {dnum}")
        check_residues(name, ksk_data,
                       (ksk_data.shape[0], 2, max(dl.ksk_rows) + 1, n))
    if ksk_shoup is not None:
        check_residues(name, ksk_shoup, tuple(ksk_data.shape))
    out = torch.empty((2, nl, n), dtype=torch.int64, device=ext.device)
    work = torch.empty((2, n_t, n), dtype=torch.int64, device=ext.device)
    t, md = dl.t, dl.moddown
    KS_FINISH.launch(
        ext.device, out, work, ext, ksk_data, ksk_shoup, row_map, krows, nl,
        n_t, dnum, n.bit_length() - 1, t.p, dl.t_pinv, dl.t_rmod,
        dl.t_rshoup, t.tw, t.tw_shoup, t.itw, t.itw_shoup, t.ninv,
        t.ninv_shoup, md.qhat_inv, md.qhat_inv_shoup, md.src_p,
        md.src_q_f32, md.conv, md.conv_shoup, md.d_mod_t, md.d_mod_t_shoup,
        dl.pinv_mod_q, dl.pinv_mod_q_shoup)
    return out
