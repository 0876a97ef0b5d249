"""Hybrid key-switching, basis conversion and rescale on int64 tensors.

Counterpart of `orion_tpu/crypto/keyswitch.py`.  The algorithms are the
standard RNS-CKKS set (full-RNS HPS fast basis conversion with a float32
correction term, hybrid gadget decomposition, ModDown by the special
primes).

Dispatch: `ring_ntt` / `ring_intt`, `ks_decompose`, `ks_finish`,
`ks_finish_raw`, `keyswitch`, `mod_drop_rescale` and `rescale_poly` launch
the hand-written CUDA kernels (`kernels/`) when given CUDA tensors, at
every level, and run the plain PyTorch versions on CPU tensors.  The
key-switch kernels take a batch of key-switches per launch
(`kernels/keyswitch.py`); each rescale epilogue is one launch pair over
any leading batch shape, its elementwise glue fused into the transforms'
launches (`kernels/rescale.py`), where orion_tpu computes it in jnp
outside Pallas.

Limb sharding: while a limb group is set (`set_limb_group`, which
`runtime/mesh.make_sharded_forward` does around a forward), `ks_decompose`,
`ks_finish` and `ks_finish_raw` run limb-sharded through the group
(`parallel/limbshard.py`): each rank of the group switches its block of
extended rows with the key-switch kernels' launches apart, and the Q rows
(or, for `ks_finish_raw`, the extended rows) are all-gathered back, so
every caller above sees the unsharded result, bit for bit.  With no group
set the seam costs one `is None` test.

Float32 v-correction: the HPS correction term only needs to be within +-1
of round(sum z_m / q_m); an off-by-one adds a multiple of the digit
modulus, which ModDown's division by P absorbs.  Both packages compute it
in the same float32 order, so their ciphertexts agree bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import keyswitch as _kks
from ..kernels.keyswitch import fbc, mod_down
from ..kernels import rescale as _rescale
from ..kernels.ntt import (cluster_twiddles, ntt_fwd, ntt_inv,
                           packed_twiddles)
from .context import CKKSContext, DigitTables, LevelKSTables
from .ntt import CIMap

__all__ = ["DevDigit", "RingRows", "DevLevel", "dev_level", "ring_ntt",
           "ring_intt", "fbc", "ks_decompose", "ks_finish", "keyswitch",
           "ks_finish_raw", "mod_down", "mod_drop_rescale", "rescale_poly",
           "set_limb_group"]


@dataclass
class DevDigit:
    src_lo: int                   # first source limb index (within Q rows)
    src_hi: int
    qhat_inv: torch.Tensor        # (alpha, 1)
    qhat_inv_shoup: torch.Tensor
    conv: torch.Tensor            # (alpha, n_t, 1)
    conv_shoup: torch.Tensor
    d_mod_t: torch.Tensor         # (n_t, 1)
    d_mod_t_shoup: torch.Tensor
    src_q_f32: torch.Tensor       # (alpha, 1) float32
    src_p: torch.Tensor           # (alpha, 1)


@dataclass
class RingRows:
    """NTT tables of a list of prime rows (all contiguous, on the device).

    The kernels read the merged-psi twiddles with their Shoup companions,
    packed (`kernels.ntt.packed_twiddles` and `cluster_twiddles`, cached
    in `kernel_tables`);
    the plain versions read the four-step tables `t4`.  On the CI ring
    the tables are the 2n lift's (N = 2n) and `ci` holds the orbit maps:
    rows of residues are n wide, and every transform of them goes
    through the lift (`crypto/ntt.py`)."""
    p: torch.Tensor               # (L,)
    tw: torch.Tensor              # (L, N)
    tw_shoup: torch.Tensor
    itw: torch.Tensor
    itw_shoup: torch.Tensor
    ninv: torch.Tensor            # (L,)
    ninv_shoup: torch.Tensor
    t4: dict
    kernel_tables: dict = field(default_factory=dict)
    ci: CIMap | None = None       # the CI ring's orbit maps

    @classmethod
    def from_ctx(cls, ctx: CKKSContext, rows) -> "RingRows":
        d = ctx.dev
        idx = torch.as_tensor(list(rows), dtype=torch.long,
                              device=ctx.device)
        return cls(d["p"][idx], d["tw"][idx], d["tw_shoup"][idx],
                   d["itw"][idx], d["itw_shoup"][idx], d["ninv"][idx],
                   d["ninv_shoup"][idx],
                   {k[3:]: d[k][idx] for k in ctx.t4_keys}, ci=ctx.ci)

    @property
    def width(self) -> int:
        """Residues per row: N, or n on the CI ring."""
        return self.tw.shape[-1] if self.ci is None else self.ci.n

    @property
    def logn(self) -> int:
        """log2 of the transform size (the lift's on the CI ring)."""
        return self.tw.shape[-1].bit_length() - 1

    def rows(self, lo: int, hi: int) -> "RingRows":
        """Rows lo..hi-1 as views.  On the card the packed kernel tables
        are built on this set first, so that every slice shares them."""
        if self.p.is_cuda:
            packed_twiddles(self)
            cluster_twiddles(self)
        return RingRows(self.p[lo:hi], self.tw[lo:hi], self.tw_shoup[lo:hi],
                        self.itw[lo:hi], self.itw_shoup[lo:hi],
                        self.ninv[lo:hi], self.ninv_shoup[lo:hi],
                        {k: v[lo:hi] for k, v in self.t4.items()},
                        {k: v[lo:hi] for k, v in self.kernel_tables.items()},
                        self.ci)


@dataclass
class DevLevel:
    """All device tables needed to run ops at one ciphertext level."""
    level: int
    q: RingRows                   # Q rows 0..level
    t: RingRows                   # extended rows: Q rows + specials
    s: RingRows                   # special rows
    q_pinv: torch.Tensor          # Montgomery constants of the Q rows
    q_rmod: torch.Tensor
    q_rshoup: torch.Tensor
    t_pinv: torch.Tensor          # ... and of the extended rows (lean keys)
    t_rmod: torch.Tensor
    t_rshoup: torch.Tensor
    digits: list[DevDigit]
    moddown: DevDigit
    pinv_mod_q: torch.Tensor      # (l+1, 1)
    pinv_mod_q_shoup: torch.Tensor
    qlast_mod_t: torch.Tensor     # (l, 1)
    qlast_inv: torch.Tensor
    qlast_inv_shoup: torch.Tensor
    qlast_half: int               # (q_l + 1) // 2
    ksk_rows: tuple               # global prime rows used by this level
    ksk_rows_idx: torch.Tensor    # the same, as an index tensor
    ring_n: int                   # stored coefficients per row
    # the CI ring's orbit maps (None on the standard ring)
    ci: CIMap | None = None
    # fused ModDown+rescale (divide by P*q_l in one basis conversion);
    # None at level 0 and on the CI ring
    dropdown: DevDigit | None = None
    dqinv: torch.Tensor | None = None
    dqinv_shoup: torch.Tensor | None = None
    p_mod_q: torch.Tensor | None = None
    p_mod_q_shoup: torch.Tensor | None = None
    # tables the kernels build from the above, cached per level
    kernel_tables: dict = field(default_factory=dict)

    def kernel_row_map(self, trimmed: bool) -> torch.Tensor:
        """Key row of each extended row: itself for a trimmed key, the
        global prime row for a full-chain key."""
        key = "rows_trimmed" if trimmed else "rows_full"
        if key not in self.kernel_tables:
            self.kernel_tables[key] = (
                torch.arange(len(self.ksk_rows), device=self.ksk_rows_idx.device)
                if trimmed else self.ksk_rows_idx.clone())
        return self.kernel_tables[key]


def _col(ctx: CKKSContext, x) -> torch.Tensor:
    return ctx.to_device(np.asarray(x)[:, None])


def _dev_digit(dt: DigitTables, ctx: CKKSContext) -> DevDigit:
    src_p = np.array([ctx.primes[i] for i in dt.src_idx], np.int64)
    in_q = dt.src_idx[0] < ctx.n_q
    return DevDigit(
        src_lo=dt.src_idx[0] if in_q else 0,
        src_hi=(dt.src_idx[-1] + 1) if in_q else 0,
        qhat_inv=_col(ctx, dt.qhat_inv),
        qhat_inv_shoup=_col(ctx, dt.qhat_inv_shoup),
        conv=ctx.to_device(dt.conv[:, :, None]),
        conv_shoup=ctx.to_device(dt.conv_shoup[:, :, None]),
        d_mod_t=_col(ctx, dt.d_mod_t),
        d_mod_t_shoup=_col(ctx, dt.d_mod_t_shoup),
        src_q_f32=torch.as_tensor(dt.src_q[:, None], device=ctx.device),
        src_p=_col(ctx, src_p),
    )


def dev_level(ctx: CKKSContext, level: int) -> DevLevel:
    """The level's device tables, built once per context and level."""
    cache = ctx.__dict__.setdefault("_dev_levels", {})
    if level not in cache:
        cache[level] = _build_dev_level(ctx, level)
    return cache[level]


def _build_dev_level(ctx: CKKSContext, level: int) -> DevLevel:
    d = ctx.dev
    lt: LevelKSTables = ctx.ks_tables[level]
    nq_rows = list(range(level + 1))
    sp_rows = list(range(ctx.n_q, ctx.n_all))
    t_rows = nq_rows + sp_rows
    t_idx = torch.as_tensor(t_rows, dtype=torch.long, device=ctx.device)
    q_idx = t_idx[: level + 1]

    out = DevLevel(
        level=level,
        q=RingRows.from_ctx(ctx, nq_rows),
        t=RingRows.from_ctx(ctx, t_rows),
        s=RingRows.from_ctx(ctx, sp_rows),
        q_pinv=d["pinv"][q_idx], q_rmod=d["r_mod"][q_idx],
        q_rshoup=d["r_shoup"][q_idx],
        t_pinv=d["pinv"][t_idx], t_rmod=d["r_mod"][t_idx],
        t_rshoup=d["r_shoup"][t_idx],
        digits=[_dev_digit(dt, ctx) for dt in lt.digits],
        moddown=_dev_digit(lt.moddown, ctx),
        pinv_mod_q=_col(ctx, lt.pinv_mod_q),
        pinv_mod_q_shoup=_col(ctx, lt.pinv_mod_q_shoup),
        qlast_mod_t=_col(ctx, lt.qlast_mod_t),
        qlast_inv=_col(ctx, lt.qlast_inv),
        qlast_inv_shoup=_col(ctx, lt.qlast_inv_shoup),
        qlast_half=(ctx.primes[level] + 1) // 2,
        ksk_rows=tuple(t_rows),
        ksk_rows_idx=t_idx,
        ring_n=ctx.n,
        ci=ctx.ci,
    )
    # rescale_poly's Shoup constants, built here and not at its first call:
    # nothing may run on the stream between its two launches
    out.kernel_tables["one_shoup"] = _rescale.one_shoup(out.q.p)
    # the CI ring builds no drop-down tables (orion_tpu's dev_level), so
    # its multiplies rescale through rescale_poly
    if lt.dropdown is not None and ctx.ci is None:
        out.dropdown = _dev_digit(lt.dropdown, ctx)
        out.dqinv = _col(ctx, lt.dqinv_mod_q)
        out.dqinv_shoup = _col(ctx, lt.dqinv_mod_q_shoup)
        out.p_mod_q = _col(ctx, lt.p_mod_q)
        out.p_mod_q_shoup = _col(ctx, lt.p_mod_q_shoup)
        # divisor rows of the fused drop: [specials..., q_l], and launch
        # A's constants that give their zq (built here for the reason
        # one_shoup is)
        rr = RingRows.from_ctx(ctx, sp_rows + [level])
        out.kernel_tables["drop_rows"] = rr
        out.kernel_tables["drop_zs"] = _kks._zq_scale(
            rr.ninv, out.dropdown.qhat_inv[:, 0], rr.p)
    return out


# ------------------------------------------------------------------ #
#  Transform seam                                                    #
# ------------------------------------------------------------------ #

def ring_ntt(a, rr: RingRows):
    """Forward NTT of (..., L, N) over the rows of `rr`: the `ntt_fwd`
    kernel on a CUDA tensor, the four-step torch transform on the CPU.
    On the CI ring (`rr.ci`) the rows are n wide and go through the 2n
    lift: the kernel's CI map, or `crypto.ntt.ci_ntt`."""
    return ntt_fwd(a.contiguous(), rr)


def ring_intt(a, rr: RingRows):
    """Inverse NTT (see ring_ntt): the `ntt_inv` kernel or `intt4`, on
    the CI ring its map or `crypto.ntt.ci_intt`."""
    return ntt_inv(a.contiguous(), rr)


# ------------------------------------------------------------------ #
#  Key switching                                                     #
# ------------------------------------------------------------------ #

# the limb group the key-switches run sharded over, or None
_limb_group = None


def set_limb_group(group):
    """Run the key-switches of this process limb-sharded over `group` (a
    `parallel.limbshard.LimbGroup`), or on the device alone with None.
    Returns the group set before."""
    global _limb_group
    prev, _limb_group = _limb_group, group
    return prev


def ks_decompose(c_ntt, dl: DevLevel):
    """The `ks_decompose` kernel (kernels/keyswitch.py); under a limb group
    the rank's block of the decomposition, (..., dnum, rows, N)."""
    if _limb_group is None:
        return _kks.ks_decompose(c_ntt, dl)
    return _limb_group.decompose(c_ntt, dl)


def ks_finish(ext, dl: DevLevel, ksk_data, ksk_shoup=None, trimmed=False,
              key_index=None):
    """The `ks_finish` kernel (kernels/keyswitch.py); under a limb group
    from the rank's block of the decomposition, the Q rows gathered."""
    if _limb_group is None:
        return _kks.ks_finish(ext, dl, ksk_data, ksk_shoup, trimmed,
                              key_index)
    return _limb_group.finish(ext, dl, ksk_data, ksk_shoup, trimmed,
                              key_index, raw=False)


def ks_finish_raw(ext, dl: DevLevel, ksk_data, ksk_shoup=None,
                  trimmed=False, key_index=None):
    """`ks_finish` without ModDown; under a limb group the extended rows
    gathered."""
    if _limb_group is None:
        return _kks.ks_finish_raw(ext, dl, ksk_data, ksk_shoup, trimmed,
                                  key_index)
    return _limb_group.finish(ext, dl, ksk_data, ksk_shoup, trimmed,
                              key_index, raw=True)


def keyswitch(c_ntt, dl: DevLevel, ksk_data, ksk_shoup, raw=False):
    """Switch poly c (level+1, N, NTT domain), or a batch (..., level+1,
    N), with one hybrid KSK: the ks_decompose and ks_finish kernels back
    to back on a CUDA tensor, one launch pair for the whole batch (the key
    as a pack of one, read by every item).  With raw the inner product is
    returned in the extended basis, before ModDown (ks_finish_raw)."""
    finish = ks_finish_raw if raw else ks_finish
    if c_ntt.dim() == 2:
        return finish(ks_decompose(c_ntt, dl), dl, ksk_data, ksk_shoup)
    lead = tuple(c_ntt.shape[:-2])
    ext = ks_decompose(c_ntt.reshape((-1,) + tuple(c_ntt.shape[-2:])), dl)
    idx = torch.zeros(ext.shape[0], dtype=torch.long, device=ext.device)
    out = finish(ext, dl, ksk_data[None],
                 None if ksk_shoup is None else ksk_shoup[None],
                 key_index=idx)
    return out.reshape(lead + tuple(out.shape[-3:]))


def mod_drop_rescale(acc, dl: DevLevel):
    """Divide (..., n_t, N) NTT acc by P*q_l in ONE basis conversion.

    Returns (..., level, N): the fused ModDown+rescale epilogue.  One
    iNTT over the (n_sp+1) divisor rows + one FBC + one NTT over the
    (level) surviving rows replaces ModDown's full round trip followed by
    rescale's second one: on the card the `drop_intt` and `drop_ntt`
    launches, whatever the leading shape.
    """
    return _rescale.mod_drop_rescale(acc.contiguous(), dl)


def rescale_poly(c, dl: DevLevel):
    """Drop the last limb of c (..., level+1, N, NTT) with centered rounding.

    Returns (..., level, N): on the card the `drop_intt` and `rescale_ntt`
    launches.  Caller adjusts level/scale metadata.
    """
    return _rescale.rescale_poly(c.contiguous(), dl)
