"""Wrappers of the `ks_decompose` and `ks_finish` kernels, with their plain
PyTorch versions.  Both take a batch of key-switches per launch.

`ks_decompose(c, dl)`: c (nl, N) or (B, nl, N), NTT domain -> ext
(dnum, n_t, N) or (B, dnum, n_t, N), every digit converted to the level's
n_t = nl + n_sp primes (`csrc/ks_decompose.cu`).
`ks_finish(ext, dl, ksk, ksk_shoup, trimmed, key_index)`: key inner
product + ModDown -> (2, nl, N) per item (`csrc/ks_finish.cu`);
`ks_finish_raw` the inner product alone -> (2, n_t, N) per item.  Keys
are full-chain or level-trimmed, with Shoup companions or lean
(Montgomery).  Items:
  - key_index None: `ksk` is one key (kdig, 2, rows, N) and ext
    (dnum, n_t, N) gives one result;
  - key_index (K,) int64: `ksk` is a stacked pack (n_keys, kdig, 2, rows,
    N) and item k takes key key_index[k], read in place; ext is shared
    (dnum, n_t, N), or (E, dnum, n_t, N) with E dividing K and item k
    taking ext[k % E]: paired when E = K, and E queries' decompositions
    each shared by K / E rotations otherwise (a batch of queries through
    one key pack, the keys read once per item, not copied per query).
    Results are (K, ...).
The caller keeps key_index within the pack (the kernel does not check
values, which would cost a device sync).

A limb-sharded key-switch (`parallel/limbshard.py`) runs the launches of
the two kernels apart, on one rank's block of extended rows (`row_block`),
with a collective between them: `ks_convert_rows` is `ks_decompose`'s
conversion grid, from the gathered coefficients of every Q row;
`ks_inner_rows` is `ks_finish`'s inner-product grid, whose special rows
leave it in the coefficient domain; `ks_moddown_rows` is its ModDown grid
onto the block's Q rows, from the special rows summed over the ranks.
Each has a C entry point of its own (`orion_ks_convert`, `orion_ks_inner`,
`orion_ks_moddown`) and a count of its own; the arithmetic is the
kernels', so a sharded key-switch equals the unsharded one bit for bit.
Standard ring only.

On the standard ring the kernels hoist the digit-invariant half of every
basis conversion (`csrc/hoist.cuh`): each source coefficient's zq = z *
qhat_inv mod q is stored once as uint32 and each (digit, coefficient)'s
v = round(sum_m zq_m / q_m) once as a byte, and the loops over the target
rows read them (at most `MAX_ALPHA` source rows per digit).  In the
unsharded kernels the inverse transforms that produce the source rows
store zq (their n^-1 scale folded with qhat_inv: `_zq_scale`), and a pass
between the two launches computes v, so each key-switch kernel launches
three grids.  The sharded `ks_convert_rows` and `ks_moddown_rows` get
their source rows as int64 coefficients and hoist zq and v in that pass,
into scratch that the wrapper allocates behind the output
(`hoist_bytes`).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version in this module, which is the port of
orion_tpu's jnp key-switch (`orion_tpu/crypto/keyswitch.py`), looped over
the batch.  The plain versions call the four-step torch transforms
directly, so on the card they stay pure torch ops and can be held against
the kernels.

On the ConjugateInvariant ring (`dl.ci`) every row is n wide and the
transforms go through the 2n lift, as orion_tpu's jnp path does there:
the kernels run with the CI map (`ks_decompose_ci`, `ks_finish_ci`).  Each
inverse transform gathers its 2n positions through `ci.src` and keeps n
coefficients; each basis conversion (`fbc`) runs on those n coefficients
only, once each, and its results are then lifted (mirrored, negated) into
the 2n forward transform, whose store keeps the n orbit positions
(`ci.pos`).  On the card every row of the CI forms is split over a
thread-block cluster of `Split<LOGN>` CTAs (`csrc/cluster_ntt.cuh`
`ntt_fwd_lift`), as the NTT kernels' rows are (`kernels/ntt.py`
`cluster_size`), so their twiddles come packed in the split's order
(`cluster_twiddles`), where the standard forms read the core's
(`packed_twiddles`).
"""

from __future__ import annotations

import torch

from dataclasses import dataclass, replace

from ..crypto.modops import add_mod, sub_mod
from ._launch import Kernel, check_residues
from .ntt import (cluster_twiddles, ntt_fwd_plain, ntt_inv_plain,
                  pack_twiddles, packed_twiddles, split_logc)

# the most source rows of a digit, or special primes, the standard ring's
# kernels take (csrc/hoist.cuh MAX_ALPHA: the target loops unroll over it)
MAX_ALPHA = 8

_DECOMPOSE_SIG = "ppp" + "iiiiii" + "p" * 19
_FINISH_SIG = "pppii" + "pppp" + "iiiiiiii" + "p" * 22
KS_DECOMPOSE = Kernel(
    "ks_decompose", "ks_decompose.cu", "orion_ks_decompose", _DECOMPOSE_SIG,
    "orion_tpu/crypto/ks_pallas.py:717 ks_decompose_pallas "
    "(_decompose_k :201, _fbc_k :174), :509 ks_decompose_pallas_grid")
KS_FINISH = Kernel(
    "ks_finish", "ks_finish.cu", "orion_ks_finish", _FINISH_SIG,
    "orion_tpu/crypto/ks_pallas.py:740 ks_finish_pallas (_finish_k :217), "
    ":592 ks_finish_pallas_grid")
KS_CONVERT_ROWS = Kernel(
    "ks_convert_rows", "ks_decompose.cu", "orion_ks_convert",
    "pp" + "iiiiii" + "p" * 12,
    "orion_tpu/crypto/ks_pallas.py:717 ks_decompose_pallas's conversion "
    "(_fbc_k :174) onto one rank's rows, as orion_tpu/parallel/limbshard.py"
    ":193 fbc_local and the ntt after its all-gather")
KS_INNER_ROWS = Kernel(
    "ks_inner_rows", "ks_finish.cu", "orion_ks_inner",
    "ppii" + "pppp" + "iiiiiiii" + "p" * 7,
    "orion_tpu/crypto/ks_pallas.py:740 ks_finish_pallas's inner product "
    "(_finish_k :217) on one rank's rows, as orion_tpu/parallel/limbshard.py"
    ":218 and the intt of the special rows before its psum")
KS_MODDOWN_ROWS = Kernel(
    "ks_moddown_rows", "ks_finish.cu", "orion_ks_moddown",
    "pp" + "iiii" + "p" * 12,
    "orion_tpu/crypto/ks_pallas.py:740 ks_finish_pallas's ModDown "
    "(_finish_k :217) onto one rank's Q rows, as orion_tpu/parallel/"
    "limbshard.py:239 after its psum")
KS_DECOMPOSE_CI = Kernel(
    "ks_decompose_ci", "ks_decompose.cu", "orion_ks_decompose",
    _DECOMPOSE_SIG,
    "orion_tpu/crypto/keyswitch.py:324 _ks_decompose_jit on the CI ring "
    "(jnp fbc around ks_pallas.py:351 pallas_ntt4 and :387 pallas_intt4; "
    "ks_decompose_pallas refuses CI at ks_pallas.py:303)")
KS_FINISH_CI = Kernel(
    "ks_finish_ci", "ks_finish.cu", "orion_ks_finish", _FINISH_SIG,
    "orion_tpu/crypto/keyswitch.py:363 _ks_finish_jit on the CI ring "
    "(jnp inner product and mod_down around ks_pallas.py:351 pallas_ntt4 "
    "and :387 pallas_intt4; ks_finish_pallas refuses CI at "
    "ks_pallas.py:303)")


# ------------------------------------------------------------------ #
#  Plain versions                                                    #
# ------------------------------------------------------------------ #

def fbc(z, dg, tgt_p):
    """Convert coeff-domain residues z (alpha, N) in the digit's base to
    the target base (n_t, N).  Approximate HPS with a float32 v-correction
    summed in source order, as orion_tpu's `fbc` and the kernels do."""
    return fbc_from_zq(z * dg.qhat_inv % dg.src_p, dg, tgt_p)


def fbc_from_zq(zq, dg, tgt_p):
    """`fbc` from each source coefficient's zq = z * qhat_inv mod q
    (alpha, N), the half the kernels compute once per source coefficient
    (csrc/hoist.cuh): v = round(sum_m f32(zq_m) / f32(q_m)) in source
    order, then sum_m zq_m * conv_m - v * dmod mod each target."""
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
    if c_ntt.dim() == 3:
        return torch.stack([ks_decompose_plain(c, dl) for c in c_ntt])
    c_coeff = ntt_inv_plain(c_ntt, dl.q)
    exts = [fbc(c_coeff[dg.src_lo:dg.src_hi], dg, dl.t.p[:, None])
            for dg in dl.digits]
    # one batched NTT over (dnum, n_t, N): every digit's extension shares
    # the target-basis tables
    return ntt_fwd_plain(torch.stack(exts), dl.t)


def _items(ext, ksk, key_index):
    """[(ext, key)] per item, and whether the call is batched.  The plain
    versions read no Shoup companions: they give the same residues."""
    if key_index is None:
        if ext.dim() != 3:
            raise ValueError("a batch of ext items needs a key_index")
        return [(ext, ksk)], False
    idx = key_index.tolist()
    if ext.dim() == 3:
        exts = [ext] * len(idx)
    else:
        if len(idx) % ext.shape[0]:
            raise ValueError(f"{ext.shape[0]} ext items for {len(idx)} "
                             f"keys")
        exts = [ext[k % ext.shape[0]] for k in range(len(idx))]
    return [(e, ksk[i]) for e, i in zip(exts, idx)], True


def _inner_one(ext, dl, ksk_data, trimmed):
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


def ks_inner(ext, dl, ksk_data, ksk_shoup=None, trimmed=False,
             key_index=None):
    """Key inner product WITHOUT ModDown: (2, n_t, N) extended-basis acc
    per item (the plain version of `ks_finish_raw`)."""
    items, batched = _items(ext, ksk_data, key_index)
    out = [_inner_one(e, dl, k, trimmed) for e, k in items]
    return torch.stack(out) if batched else out[0]


def mod_down(x, dl):
    """Divide an extended-basis poly (nl + n_sp, N, NTT) by P -> Q base."""
    lvl = dl.level
    qp = dl.q.p[:, None]
    pp_coeff = ntt_inv_plain(x[lvl + 1:], dl.s)
    lift = fbc(pp_coeff, dl.moddown, qp)
    lift_ntt = ntt_fwd_plain(lift, dl.q)
    diff = sub_mod(x[: lvl + 1], lift_ntt, qp)
    return diff * dl.pinv_mod_q % qp


def ks_finish_plain(ext, dl, ksk_data, ksk_shoup=None, trimmed=False,
                    key_index=None):
    items, batched = _items(ext, ksk_data, key_index)
    out = [torch.stack([mod_down(acc, dl)
                        for acc in _inner_one(e, dl, k, trimmed)])
           for e, k in items]
    return torch.stack(out) if batched else out[0]


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
        if dl.ci is None:
            t["zs"], t["zs_sh"] = _zq_scale(
                dl.t.ninv[:len(dl.q.p)],
                torch.cat([dg.qhat_inv[:, 0] for dg in dl.digits]),
                dl.q.p)
        kt["dig"] = t
    return kt["dig"]


def _zq_scale(ninv, qhat_inv, p):
    """The Shoup constants (w, w_shoup) of an inverse transform whose store
    gives zq: w = n^-1 * qhat_inv mod p per row, so that x * w mod p =
    (x * n^-1 mod p) * qhat_inv mod p, the coefficient's zq."""
    w = ninv * qhat_inv % p
    return w.contiguous(), ((w << 32) // p).contiguous()


def hoist_bytes(polys: int, rows: int, digits: int, n: int) -> int:
    """Bytes of the hoisted conversion's scratch over `polys` polys of
    `rows` source rows in `digits` digits: zq (polys, rows, n) uint32,
    then v (polys, digits, n) bytes."""
    return polys * n * (4 * rows + digits)


def _with_scratch(shape, nbytes, device):
    """An int64 output of `shape` with `nbytes` of scratch behind it in
    the same buffer (the sharded entries' hoisted conversion)."""
    words = torch.Size(shape).numel()
    buf = torch.empty(words + -(-nbytes // 8), dtype=torch.int64,
                      device=device)
    return buf[:words].view(shape)


def _check_alpha(name, rows, what):
    if rows > MAX_ALPHA:
        raise ValueError(f"{name}: {rows} {what}; the kernels take at most "
                         f"{MAX_ALPHA}")


def ks_decompose(c_ntt, dl):
    """Digit-decompose c, (nl, N) or (B, nl, N), and extend every digit to
    the full basis: (dnum, n_t, N) or (B, dnum, n_t, N), one launch of
    ks_decompose.cu (its coefficient scratch holds the hoisted zq and v on
    the standard ring)."""
    if c_ntt.device.type == "cpu":
        return ks_decompose_plain(c_ntt, dl)
    nl, n = dl.level + 1, dl.ring_n
    n_t = dl.t.p.shape[0]
    dnum = len(dl.digits)
    kernel = KS_DECOMPOSE if dl.ci is None else KS_DECOMPOSE_CI
    batched = c_ntt.dim() == 3
    c3 = c_ntt if batched else c_ntt[None]
    b = c3.shape[0]
    check_residues(kernel.name, c3, (b, nl, n))
    d = _digit_stack(dl)
    t = dl.t
    twp, itwp = _twiddles(dl)
    if dl.ci is None:
        _check_alpha(kernel.name, d["amax"], "source rows in a digit")
        itwp = _decompose_itw(dl)
    ext = torch.empty((b, dnum, n_t, n), dtype=torch.int64,
                      device=c_ntt.device)
    coeff = torch.empty((b, nl, n), dtype=torch.int64, device=c_ntt.device)
    kernel.launch(
        c_ntt.device, ext, coeff, c3, b, nl, n_t, dnum, d["amax"], t.logn,
        d["lo"], d["alpha"], d["qi"], d["qi_sh"], d["srcp"], d["srcq"],
        d["conv"], d["conv_sh"], d["dmod"], d["dmod_sh"], t.p, twp, itwp,
        t.ninv, t.ninv_shoup, d.get("zs"), d.get("zs_sh"), *_ci_maps(dl),
        level=dl.level, items=b, grids=2 if dl.ci is not None else 3)
    return ext if batched else ext[0]


def _twiddles(dl) -> tuple:
    """The target rows' packed (forward, inverse) tables as the level's
    kernels read them: the core's order, or the cluster split's on the CI
    ring."""
    return (packed_twiddles(dl.t) if dl.ci is None
            else cluster_twiddles(dl.t))


def _decompose_itw(dl):
    """The inverse table of the Q rows as the standard ks_decompose's
    launch A reads it: in the cluster split's order (cached; no forward
    table, which the split forward of its launch B does not read)."""
    kt = dl.q.kernel_tables
    if "ks_itwc" not in kt:
        kt["ks_itwc"] = pack_twiddles(dl.q.itw, dl.q.itw_shoup,
                                      split_logc(dl.q.logn))
    return kt["ks_itwc"]


def _ci_maps(dl) -> tuple:
    """The CI map arguments (src, pos) of the key-switch kernels: null
    pointers on the standard ring."""
    return (None, None) if dl.ci is None else (dl.ci.src, dl.ci.pos)


def _finish(ext, dl, ksk_data, ksk_shoup, trimmed, key_index, moddown):
    """Launch ks_finish.cu over the items (see the module docstring)."""
    kernel = KS_FINISH if dl.ci is None else KS_FINISH_CI
    name = kernel.name
    dev = ext.device
    nl, n = dl.level + 1, dl.ring_n
    n_t = dl.t.p.shape[0]
    dnum = len(dl.digits)
    paired = ext.dim() == 4
    batched = key_index is not None
    if not batched:
        if paired:
            raise ValueError(f"{name}: a batch of ext items needs a "
                             f"key_index")
        pack = ksk_data[None]
        pack_sh = None if ksk_shoup is None else ksk_shoup[None]
        k = 1
        if "key0" not in dl.kernel_tables:
            dl.kernel_tables["key0"] = torch.zeros(1, dtype=torch.int64,
                                                   device=dev)
        key_index = dl.kernel_tables["key0"]
    else:
        pack, pack_sh = ksk_data, ksk_shoup
        k = key_index.shape[0]
        if key_index.device != dev or key_index.dtype != torch.int64 \
                or key_index.dim() != 1 or not key_index.is_contiguous():
            raise ValueError(f"{name}: key_index must be a contiguous 1-D "
                             f"int64 tensor on {dev}")
    if k < 1:
        raise ValueError(f"{name}: no items")
    if moddown and dl.ci is None:
        _check_alpha(name, n_t - nl, "special primes")
    e = ext.shape[0] if paired else 1
    if k % e:
        raise ValueError(f"{name}: {e} ext items for {k} keys")
    check_residues(name, ext, ((e,) if paired else ()) + (dnum, n_t, n))
    if pack.dim() != 5:
        raise ValueError(f"{name}: key shape {tuple(pack.shape)}")
    n_keys, kdig, krows = pack.shape[0], pack.shape[1], pack.shape[3]
    if trimmed:
        row_map = dl.kernel_row_map(trimmed=True)
        check_residues(name, pack, (n_keys, dnum, 2, n_t, n))
    else:
        row_map = dl.kernel_row_map(trimmed=False)
        if kdig < dnum:
            raise ValueError(f"{name}: key has {kdig} digits, level "
                             f"{dl.level} needs {dnum}")
        check_residues(name, pack, (n_keys, kdig, 2, max(dl.ksk_rows) + 1,
                                    n))
    if pack_sh is not None:
        check_residues(name, pack_sh, tuple(pack.shape))
    work = torch.empty((k, 2, n_t, n), dtype=torch.int64, device=dev)
    out = (torch.empty((k, 2, nl, n), dtype=torch.int64, device=dev)
           if moddown else None)
    kernel.launch(
        dev, out, work, ext, dnum * n_t * n if paired else 0, e, pack,
        pack_sh, key_index, row_map, k, kdig, krows, nl, n_t, dnum, dl.t.logn,
        int(moddown), *_finish_tables(dl), *_ci_maps(dl), level=dl.level,
        items=k, grids=(2 if dl.ci is not None else 3) if moddown else 1)
    res = out if moddown else work
    return res if batched else res[0]


def _finish_tables(dl) -> tuple:
    """The level's ks_finish tables, in the kernel's argument order: on the
    standard ring with the special rows' zq constants (`_zq_scale`)."""
    t, md = dl.t, dl.moddown
    twp, itwp = _twiddles(dl)
    kt = dl.kernel_tables
    if "md_zs" not in kt:
        nl = dl.level + 1
        kt["md_zs"] = ((None, None) if dl.ci is not None else _zq_scale(
            t.ninv[nl:], md.qhat_inv[:, 0], t.p[nl:]))
    return (t.p, dl.t_pinv, dl.t_rmod, dl.t_rshoup, twp, itwp, t.ninv,
            t.ninv_shoup, md.qhat_inv, md.qhat_inv_shoup, md.src_p,
            md.src_q_f32, md.conv, md.conv_shoup, md.d_mod_t,
            md.d_mod_t_shoup, dl.pinv_mod_q, dl.pinv_mod_q_shoup,
            *kt["md_zs"])


def ks_finish(ext, dl, ksk_data, ksk_shoup=None, trimmed=False,
              key_index=None):
    """Inner-product the decomposed digits with key-switch keys and ModDown.

    ext: (dnum, n_t, N), or (E, dnum, n_t, N) with key_index; keys
    and key_index as in the module docstring: full-chain (kdig, 2, n_all, N) or, with trimmed=True,
    sliced to this level's digits and prime rows (dnum, 2, n_t, N), one
    key or a stacked pack.  ksk_shoup=None is a lean key (Montgomery lift).
    Returns (2, level+1, N), or (K, 2, level+1, N) for a batch, NTT domain.
    """
    if ext.device.type == "cpu":
        return ks_finish_plain(ext, dl, ksk_data, ksk_shoup, trimmed,
                               key_index)
    return _finish(ext, dl, ksk_data, ksk_shoup, trimmed, key_index, True)


def ks_finish_raw(ext, dl, ksk_data, ksk_shoup=None, trimmed=False,
                  key_index=None):
    """The inner product of ks_finish WITHOUT ModDown: (2, n_t, N) per
    item, extended basis, NTT domain (the ks_finish kernel's launch A)."""
    if ext.device.type == "cpu":
        return ks_inner(ext, dl, ksk_data, ksk_shoup, trimmed, key_index)
    return _finish(ext, dl, ksk_data, ksk_shoup, trimmed, key_index, False)


# ------------------------------------------------------------------ #
#  One rank's row block (limb-sharded key-switching)                 #
# ------------------------------------------------------------------ #

@dataclass
class RowBlock:
    """Extended rows lo..hi-1 of a level and the level's tables cut to
    them: what one rank of a limb-sharded key-switch reads.  Q rows come
    first in the extended basis, so the block's first nq rows are Q rows
    and the others special rows."""
    lo: int
    hi: int
    nq: int
    rows: object                  # RingRows of the block
    q_rows: object | None         # RingRows of its nq Q rows
    digits: list                  # each DevDigit, its targets cut to the block
    moddown: object | None        # the ModDown DevDigit, cut to the Q rows
    pinv_mod_q: torch.Tensor      # (nq, 1)
    pinv_mod_q_shoup: torch.Tensor
    t_pinv: torch.Tensor          # Montgomery constants of the block's rows
    t_rmod: torch.Tensor
    t_rshoup: torch.Tensor
    dig: dict                     # the conversion tables in kernel layout


def row_block(dl, lo: int, hi: int) -> RowBlock:
    """The block of extended rows lo..hi-1 of level `dl`, cached on the
    level: one per rank and limb group size."""
    key = ("rows", lo, hi)
    kt = dl.kernel_tables
    if key in kt:
        return kt[key]
    if dl.ci is not None:
        raise ValueError("limb-sharded key-switching runs on the standard "
                         "ring only")
    nq = max(0, min(hi, dl.level + 1) - lo)

    def cut(dg, a, b):
        return replace(dg, conv=dg.conv[:, a:b].contiguous(),
                       conv_shoup=dg.conv_shoup[:, a:b].contiguous(),
                       d_mod_t=dg.d_mod_t[a:b].contiguous(),
                       d_mod_t_shoup=dg.d_mod_t_shoup[a:b].contiguous())

    md = cut(dl.moddown, lo, lo + nq) if nq else None
    dig = {}
    if dl.t.p.is_cuda:
        dig = dict(_digit_stack(dl))
        for k in ("conv", "conv_sh"):
            dig[k] = dig[k][:, :, lo:hi].contiguous()
        for k in ("dmod", "dmod_sh"):
            dig[k] = dig[k][:, lo:hi].contiguous()
    blk = RowBlock(
        lo=lo, hi=hi, nq=nq, rows=dl.t.rows(lo, hi),
        q_rows=dl.t.rows(lo, lo + nq) if nq else None,
        digits=[cut(dg, lo, hi) for dg in dl.digits], moddown=md,
        pinv_mod_q=dl.pinv_mod_q[lo:lo + nq].contiguous(),
        pinv_mod_q_shoup=dl.pinv_mod_q_shoup[lo:lo + nq].contiguous(),
        t_pinv=dl.t_pinv[lo:hi], t_rmod=dl.t_rmod[lo:hi],
        t_rshoup=dl.t_rshoup[lo:hi], dig=dig)
    kt[key] = blk
    return blk


def ks_convert_rows_plain(coeff, dl, blk):
    p = blk.rows.p[:, None]
    exts = [torch.stack([fbc(c[dg.src_lo:dg.src_hi], dg, p)
                         for dg in blk.digits]) for c in coeff]
    return ntt_fwd_plain(torch.stack(exts), blk.rows)


def ks_convert_rows(coeff, dl, blk: RowBlock):
    """Convert every digit of coeff (B, nl, N), the coefficients of all Q
    rows, onto the block's rows: ext (B, dnum, rows, N), NTT domain.  On
    the card the `orion_ks_convert` launch: the hoisting prologue, then
    ks_decompose's grid B (ext's buffer carries the scratch)."""
    if coeff.device.type == "cpu":
        return ks_convert_rows_plain(coeff, dl, blk)
    k = KS_CONVERT_ROWS
    nl, n = dl.level + 1, dl.ring_n
    b, rows, dnum = coeff.shape[0], blk.hi - blk.lo, len(dl.digits)
    check_residues(k.name, coeff, (b, nl, n))
    d = blk.dig
    _check_alpha(k.name, d["amax"], "source rows in a digit")
    ext = _with_scratch((b, dnum, rows, n), hoist_bytes(b, nl, dnum, n),
                        coeff.device)
    k.launch(coeff.device, ext, coeff, b, nl, rows, dnum, d["amax"],
             blk.rows.logn, d["lo"], d["alpha"], d["qi"], d["qi_sh"],
             d["srcp"], d["srcq"], d["conv"], d["conv_sh"], d["dmod"],
             d["dmod_sh"], blk.rows.p, packed_twiddles(blk.rows)[0],
             level=dl.level, items=b, grids=2)
    return ext


def _inner_rows_one(ext, blk, ksk, row_map, moddown):
    p = blk.rows.p[:, None]
    acc = []
    for q in range(2):
        a = None
        for j in range(ext.shape[0]):
            t = ext[j] * ksk[j, q][row_map] % p
            a = t if a is None else add_mod(a, t, p)
        acc.append(a)
    acc = torch.stack(acc)
    rows = blk.hi - blk.lo
    if moddown and blk.nq < rows:
        sp = ntt_inv_plain(acc[:, blk.nq:], blk.rows.rows(blk.nq, rows))
        acc = torch.cat([acc[:, :blk.nq], sp], dim=1)
    return acc


def ks_inner_rows_plain(ext, dl, blk, ksk, ksk_shoup, row_map,
                        key_index=None, moddown=True):
    items, batched = _items(ext, ksk, key_index)
    out = [_inner_rows_one(e, blk, k, row_map, moddown) for e, k in items]
    return torch.stack(out) if batched else out[0]


def ks_inner_rows(ext, dl, blk: RowBlock, ksk, ksk_shoup, row_map,
                  key_index=None, moddown=True):
    """The key inner product on the block's rows: (2, rows, N) per item,
    NTT domain; with moddown set its special rows leave in the
    coefficient domain, for the all-reduce of a sharded ModDown.

    ext (dnum, rows, N), or (E, dnum, rows, N) with key_index, and the
    keys as in `ks_finish`; block row t reads key row row_map[t] (a slice
    of the level's `kernel_row_map`, or 0..rows-1 for keys cut to the
    block).  On the card the `orion_ks_inner` launch (ks_finish's grid
    A)."""
    if ext.device.type == "cpu":
        return ks_inner_rows_plain(ext, dl, blk, ksk, ksk_shoup, row_map,
                                   key_index, moddown)
    k = KS_INNER_ROWS
    dev, n = ext.device, dl.ring_n
    rows, dnum = blk.hi - blk.lo, len(dl.digits)
    batched = key_index is not None
    if not batched:
        if ext.dim() != 3:
            raise ValueError(f"{k.name}: a batch of ext items needs a "
                             f"key_index")
        ksk = ksk[None]
        ksk_shoup = None if ksk_shoup is None else ksk_shoup[None]
        key_index = torch.zeros(1, dtype=torch.int64, device=dev)
    items = key_index.shape[0]
    e = ext.shape[0] if ext.dim() == 4 else 1
    if items < 1 or items % e:
        raise ValueError(f"{k.name}: {e} ext items for {items} keys")
    check_residues(k.name, ext, ext.shape[:-3] + (dnum, rows, n))
    if ksk.dim() != 5 or ksk.shape[1] < dnum or \
            tuple(row_map.shape) != (rows,):
        raise ValueError(f"{k.name}: keys {tuple(ksk.shape)} and row map "
                         f"{tuple(row_map.shape)} for {rows} rows")
    check_residues(k.name, ksk, tuple(ksk.shape))
    if ksk_shoup is not None:
        check_residues(k.name, ksk_shoup, tuple(ksk.shape))
    work = torch.empty((items, 2, rows, n), dtype=torch.int64, device=dev)
    t = blk.rows
    k.launch(dev, work, ext, dnum * rows * n if ext.dim() == 4 else 0, e,
             ksk, ksk_shoup, key_index, row_map, items, ksk.shape[1],
             ksk.shape[3], blk.nq, rows, dnum, t.logn, int(moddown), t.p,
             blk.t_pinv, blk.t_rmod, blk.t_rshoup, packed_twiddles(t)[1],
             t.ninv, t.ninv_shoup, level=dl.level, items=items)
    return work if batched else work[0]


def ks_moddown_rows_plain(x, dl, blk):
    qp = blk.q_rows.p[:, None]
    out = []
    for poly in x.reshape((-1,) + tuple(x.shape[-2:])):
        lift = ntt_fwd_plain(fbc(poly[blk.nq:], blk.moddown, qp),
                             blk.q_rows)
        out.append(sub_mod(poly[:blk.nq], lift, qp) * blk.pinv_mod_q % qp)
    return torch.stack(out).reshape(tuple(x.shape[:-2]) + (blk.nq,
                                                           x.shape[-1]))


def ks_moddown_rows(x, dl, blk: RowBlock):
    """ModDown onto the block's Q rows: x (K, 2, nq + n_sp, N) holds the
    block's nq Q rows (NTT domain), then the level's n_sp special rows in
    the coefficient domain; returns (K, 2, nq, N), NTT domain.  On the
    card the `orion_ks_moddown` launch: the hoisting prologue over the
    special rows, then ks_finish's grid B (the output's buffer carries the
    scratch)."""
    if blk.nq == 0:
        raise ValueError("ks_moddown_rows: the block holds no Q row")
    if x.device.type == "cpu":
        return ks_moddown_rows_plain(x, dl, blk)
    k = KS_MODDOWN_ROWS
    n_sp, n = dl.s.p.shape[0], dl.ring_n
    items = x.shape[0]
    check_residues(k.name, x, (items, 2, blk.nq + n_sp, n))
    _check_alpha(k.name, n_sp, "special primes")
    out = _with_scratch((items, 2, blk.nq, n),
                        hoist_bytes(2 * items, n_sp, 1, n), x.device)
    md, q = blk.moddown, blk.q_rows
    k.launch(x.device, out, x, items, blk.nq, blk.nq + n_sp, q.logn,
             md.qhat_inv, md.qhat_inv_shoup, md.src_p, md.src_q_f32,
             md.conv, md.conv_shoup, md.d_mod_t, md.d_mod_t_shoup,
             blk.pinv_mod_q, blk.pinv_mod_q_shoup, q.p,
             packed_twiddles(q)[0], level=dl.level, items=items, grids=2)
    return out
