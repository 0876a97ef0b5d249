"""The rescale epilogues as two kernel launches each (`csrc/ntt.cu`).

`mod_drop_rescale(acc, dl)`: (..., n_t, N) extended-basis acc, NTT domain
-> (..., l, N), divided by P * q_l in one basis conversion (the fused
ModDown + rescale).  `rescale_poly(c, dl)`: (..., l+1, N) -> (..., l, N),
the last limb dropped with centered rounding.  Any leading batch shape
takes one launch pair:
  - `drop_intt` (launch A): the inverse NTT of the divisor rows, read in
    place through a row map ([specials..., q_l] of acc, or q_l of c), into
    a uint32 scratch (groups, L, N): for rescale_poly the coefficients z,
    for mod_drop_rescale each coefficient's zq = z * qhat_inv mod q of the
    level's `dropdown` digit (n^-1 and qhat_inv folded into one Shoup
    constant per row, `kernel_tables["drop_zs"]`);
  - `drop_ntt` / `rescale_ntt` (launch B): per (group, target row j < l)
    the lift to q_j in the transform's load functor (the target half of
    the basis conversion from zq and v, or the centered lift of the last
    limb, reduced by a Shoup product by one, `one_shoup`), the forward
    NTT, and the subtract-and-scale by (P q_l)^-1 or q_l^-1 in its store
    functor.  `drop_ntt` first runs a pass (`csrc/hoist.cuh`
    hoist_digits) that sums each coefficient's float32 quotients zq_m /
    q_m in source order into v, one byte: so zq and v are computed once
    per divisor coefficient, not once per target row (at most `MAX_ALPHA`
    divisor rows).
Both transforms are the cluster transforms of `ntt.py`; nothing runs
between the launches but the allocation of the output and scratch
(every table they read is built with the level, or before launch A).
Every launch after A is the programmatic dependent of the one ahead of
it, and A lets its dependent start as A starts: launch B's clusters
fetch the values of c or acc their stores need (and the drop's the
conversion constants of their row), then wait for the grid ahead.

On the ConjugateInvariant ring `rescale_poly` runs with the CI map
(`drop_intt_ci`, `rescale_ntt_ci`): launch A reads the last limb's n
residues through `ci.src` into the 2n inverse transform and keeps its
first n coefficients; launch B lifts each (the centered lift, then the
antisymmetric 2n lift) in its load functor and writes through `ci.pos`.
The CI ring has no drop-down tables, so `mod_drop_rescale` refuses it.

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU tensor
they run the plain versions below, the port of orion_tpu's jnp epilogues
(`orion_tpu/crypto/keyswitch.py` mod_drop_rescale, rescale_poly) with the
four-step torch transforms, looped over the leading axes.
"""

from __future__ import annotations

import torch

from ..crypto.modops import sub_mod
from ..crypto.ntt4 import intt4, ntt4
from ._launch import Kernel, check_residues
from .keyswitch import MAX_ALPHA, fbc, fbc_from_zq
from .ntt import cluster_twiddles, ntt_fwd_plain, ntt_inv_plain

_EPILOGUES = ("orion_tpu/crypto/keyswitch.py:446 mod_drop_rescale, "
              ":503 rescale_poly (jnp)")
DROP_INTT = Kernel(
    "drop_intt", "ntt.cu", "orion_drop_intt", "pp" + "iiii" + "p" * 6,
    "orion_tpu/crypto/ks_pallas.py:387 pallas_intt4 (_kintt :106) in "
    + _EPILOGUES)
DROP_NTT = Kernel(
    "drop_ntt", "ntt.cu", "orion_drop_ntt", "pppp" + "iiiii" + "p" * 12,
    "orion_tpu/crypto/ks_pallas.py:351 pallas_ntt4 (_kntt :82) with the "
    "fbc and subtract-and-scale of orion_tpu/crypto/keyswitch.py:446 "
    "mod_drop_rescale (jnp)")
RESCALE_NTT = Kernel(
    "rescale_ntt", "ntt.cu", "orion_rescale_ntt", "ppp" + "i" * 5 + "p" * 7,
    "orion_tpu/crypto/ks_pallas.py:351 pallas_ntt4 (_kntt :82) with the "
    "centered lift and subtract-and-scale of "
    "orion_tpu/crypto/keyswitch.py:503 rescale_poly (jnp)")
DROP_INTT_CI = Kernel(
    "drop_intt_ci", "ntt.cu", "orion_drop_intt", "pp" + "iiii" + "p" * 6,
    "orion_tpu/crypto/ks_pallas.py:387 pallas_intt4 (_kintt :106) with the "
    "CI gather of orion_tpu/crypto/keyswitch.py:254 ring_intt in "
    ":503 rescale_poly (jnp)")
RESCALE_NTT_CI = Kernel(
    "rescale_ntt_ci", "ntt.cu", "orion_rescale_ntt", "ppp" + "i" * 5 + "p" * 7,
    "orion_tpu/crypto/ks_pallas.py:351 pallas_ntt4 (_kntt :82) with the "
    "centered lift, CI lift and keep and subtract-and-scale of "
    "orion_tpu/crypto/keyswitch.py:503 rescale_poly (jnp)")


# ------------------------------------------------------------------ #
#  Plain versions                                                    #
# ------------------------------------------------------------------ #

def _no_dropdown(dl):
    if dl.dropdown is None:
        raise ValueError(f"mod_drop_rescale: level {dl.level} has no "
                         f"drop-down tables (level 0, or the CI ring)")


def mod_drop_rescale_plain(acc, dl):
    _no_dropdown(dl)
    if acc.dim() > 2:
        # fbc contracts over a leading source-limb axis and so does not
        # broadcast over batch dims: loop over the leading axis
        return torch.stack([mod_drop_rescale_plain(a, dl) for a in acc])
    lvl = dl.level
    rr = dl.kernel_tables["drop_rows"]
    div = torch.cat([acc[lvl + 1:], acc[lvl:lvl + 1]])  # [specials..., q_l]
    z = intt4(div, rr.t4, rr.ninv, rr.p)
    qp = dl.q.p[:lvl, None]
    lift = fbc(z, dl.dropdown, qp)
    lift_ntt = ntt4(lift, {k: v[:lvl] for k, v in dl.q.t4.items()},
                    dl.q.p[:lvl])
    diff = sub_mod(acc[:lvl], lift_ntt, qp)
    return diff * dl.dqinv % qp


def rescale_poly_plain(c, dl):
    lvl = dl.level
    qp = dl.q.p[:lvl, None]
    last = ntt_inv_plain(c[..., lvl:lvl + 1, :],
                         dl.q.rows(lvl, lvl + 1))[..., 0, :]
    # centered lift of `last` into each remaining modulus
    red = last[..., None, :] % qp
    v = (last >= dl.qlast_half)[..., None, :]
    y = sub_mod(red, torch.where(v, dl.qlast_mod_t, 0), qp)
    y_ntt = ntt_fwd_plain(y, dl.q.rows(0, lvl))
    diff = sub_mod(c[..., :lvl, :], y_ntt, qp)
    return diff * dl.qlast_inv % qp


def divisor_intt_plain(x, dl, drop: bool):
    """Launch A's plain version: the divisor rows of x (read through the
    row map), inverse-transformed, as int32 (groups, L, n): the
    coefficients z, or with `drop` each one's zq = z * qhat_inv mod q."""
    lvl = dl.level
    rr = dl.kernel_tables["drop_rows"] if drop else dl.q.rows(lvl, lvl + 1)
    rows = x.index_select(-2, divisor_row_map(dl, drop))
    z = ntt_inv_plain(rows, rr)
    if drop:
        dg = dl.dropdown
        z = z * dg.qhat_inv % dg.src_p
    return z.reshape(-1, *z.shape[-2:]).to(torch.int32)


def drop_lift_ntt_plain(acc, z, dl):
    """Launch B's plain version for mod_drop_rescale, from launch A's zq
    (the pass's v computed again from it)."""
    _no_dropdown(dl)
    lvl = dl.level
    qp = dl.q.p[:lvl, None]
    a = acc.reshape(-1, *acc.shape[-2:])
    lift = torch.stack([fbc_from_zq(zg.to(torch.int64), dl.dropdown, qp)
                        for zg in z])
    lift_ntt = ntt4(lift, {k: v[:lvl] for k, v in dl.q.t4.items()},
                    dl.q.p[:lvl])
    out = sub_mod(a[:, :lvl], lift_ntt, qp) * dl.dqinv % qp
    return out.reshape(acc.shape[:-2] + out.shape[-2:])


def rescale_lift_ntt_plain(c, z, dl):
    """Launch B's plain version for rescale_poly, from launch A's z."""
    lvl = dl.level
    qp = dl.q.p[:lvl, None]
    last = z[:, 0].to(torch.int64)
    red = last[:, None, :] % qp
    y = sub_mod(red, torch.where((last >= dl.qlast_half)[:, None, :],
                                 dl.qlast_mod_t, 0), qp)
    y_ntt = ntt_fwd_plain(y, dl.q.rows(0, lvl))
    a = c.reshape(-1, *c.shape[-2:])
    out = sub_mod(a[:, :lvl], y_ntt, qp) * dl.qlast_inv % qp
    return out.reshape(c.shape[:-2] + out.shape[-2:])


# ------------------------------------------------------------------ #
#  Kernel wrappers                                                   #
# ------------------------------------------------------------------ #

def divisor_row_map(dl, drop: bool) -> torch.Tensor:
    """The rows launch A reads in place: [specials..., q_l] of an
    extended-basis acc (drop), or q_l of a Q-basis ciphertext.  Cached."""
    key = "drop_rmap" if drop else "last_rmap"
    if key not in dl.kernel_tables:
        lvl, n_t = dl.level, dl.t.p.shape[0]
        rows = list(range(lvl + 1, n_t)) + [lvl] if drop else [lvl]
        dl.kernel_tables[key] = torch.tensor(rows, dtype=torch.int64,
                                             device=dl.q.p.device)
    return dl.kernel_tables[key]


def _groups(name, x, rows, n):
    if x.dim() < 2 or x.shape[-2] != rows or x.shape[-1] != n:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not end in "
                         f"({rows}, {n})")
    check_residues(name, x, x.shape)
    return x.numel() // (rows * n)


def divisor_intt(x, dl, drop: bool):
    """Launch A: the divisor rows of x, (..., n_t, N) for the fused drop or
    (..., l+1, N) for rescale_poly, read in place through the row map and
    inverse-transformed into a new int32 (groups, L, N) scratch."""
    if x.device.type == "cpu":
        return divisor_intt_plain(x, dl, drop)
    lvl, n = dl.level, dl.ring_n
    k = DROP_INTT if dl.ci is None else DROP_INTT_CI
    if lvl < 1:
        raise ValueError(f"{k.name}: level 0 has no limb to drop")
    if drop:
        _no_dropdown(dl)
        rr = dl.kernel_tables["drop_rows"]
        p, itwc = rr.p, cluster_twiddles(rr)[1]
        ninv, ninv_sh = dl.kernel_tables["drop_zs"]
        n_src = dl.t.p.shape[0]
    else:
        q, last = dl.q, slice(lvl, lvl + 1)
        p, itwc, ninv, ninv_sh = (q.p[last], cluster_twiddles(q)[1][last],
                                  q.ninv[last], q.ninv_shoup[last])
        n_src = lvl + 1
    groups = _groups(k.name, x, n_src, n)
    n_div = p.shape[0]
    z = torch.empty((groups, n_div, n), dtype=torch.int32, device=x.device)
    k.launch(x.device, z, x, groups, n_src, n_div, dl.q.logn,
             divisor_row_map(dl, drop), p, itwc, ninv, ninv_sh,
             None if dl.ci is None else dl.ci.src,
             level=lvl, items=groups * n_div)
    return z


def _check_scratch(name, z, x, rows, dl):
    groups = _groups(name, x, rows, dl.ring_n)
    if (z.device != x.device or z.dtype != torch.int32
            or z.dim() != 3 or z.shape[0] != groups
            or z.shape[2] != dl.ring_n or not z.is_contiguous()):
        raise ValueError(f"{name}: scratch {tuple(z.shape)} {z.dtype} does "
                         f"not come from divisor_intt of this input")
    return groups


def drop_lift_ntt(acc, z, dl):
    """Launch B of mod_drop_rescale, from launch A's zq scratch z: the pass
    (v of each coefficient into a byte scratch), then the conversion's
    target half, transform and subtract-and-scale, each grid the
    programmatic dependent of the one ahead.  Launch B reads acc before
    it waits: call it right after `divisor_intt` of this acc
    (mod_drop_rescale), or behind any kernel that does not write acc."""
    if acc.device.type == "cpu":
        return drop_lift_ntt_plain(acc, z, dl)
    _no_dropdown(dl)
    lvl, n = dl.level, dl.ring_n
    n_t = dl.t.p.shape[0]
    groups = _check_scratch(DROP_NTT.name, z, acc, n_t, dl)
    n_div = z.shape[1]
    if n_div > MAX_ALPHA:
        raise ValueError(f"{DROP_NTT.name}: {n_div} divisor rows; the "
                         f"kernel takes at most {MAX_ALPHA}")
    dg = dl.dropdown
    vb = torch.empty((groups, n), dtype=torch.uint8, device=acc.device)
    out = torch.empty(acc.shape[:-2] + (lvl, n), dtype=torch.int64,
                      device=acc.device)
    DROP_NTT.launch(acc.device, out, acc, z, vb, groups, n_t, lvl, n_div,
                    n.bit_length() - 1, dg.qhat_inv, dg.qhat_inv_shoup,
                    dg.src_p, dg.src_q_f32, dg.conv, dg.conv_shoup,
                    dg.d_mod_t, dg.d_mod_t_shoup, dl.q.p,
                    cluster_twiddles(dl.q)[0], dl.dqinv, dl.dqinv_shoup,
                    level=lvl, items=groups * lvl, grids=2)
    return out


def one_shoup(p: torch.Tensor) -> torch.Tensor:
    """floor(2^32 / p) of each prime: x mod p = x - umulhi(x, it) * p,
    less p once more if that is >= p, exactly for every x < 2^32 (a Shoup
    product by one, orion_tpu's `one_shoup_q`); in each level's
    `kernel_tables` (crypto/keyswitch.py `_build_dev_level`)."""
    return torch.div(1 << 32, p, rounding_mode="floor")


def rescale_lift_ntt(c, z, dl):
    """Launch B of rescale_poly, from launch A's scratch z.  It is launched
    as the programmatic dependent of the kernel ahead of it on the stream
    and reads c before it waits for that kernel: call it right after
    `divisor_intt` of this c (rescale_poly), or behind any kernel that does
    not write c."""
    if c.device.type == "cpu":
        return rescale_lift_ntt_plain(c, z, dl)
    lvl, n = dl.level, dl.ring_n
    k = RESCALE_NTT if dl.ci is None else RESCALE_NTT_CI
    groups = _check_scratch(k.name, z, c, lvl + 1, dl)
    out = torch.empty(c.shape[:-2] + (lvl, n), dtype=torch.int64,
                      device=c.device)
    k.launch(c.device, out, c, z, groups, lvl + 1, lvl, dl.q.logn,
             dl.qlast_half, dl.q.p, cluster_twiddles(dl.q)[0],
             dl.qlast_mod_t, dl.kernel_tables["one_shoup"], dl.qlast_inv,
             dl.qlast_inv_shoup, None if dl.ci is None else dl.ci.pos,
             level=lvl, items=groups * lvl)
    return out


def mod_drop_rescale(acc, dl):
    """Divide (..., n_t, N) NTT acc by P*q_l: (..., l, N), two launches on
    a CUDA tensor, the plain version on a CPU tensor."""
    if acc.device.type == "cpu":
        return mod_drop_rescale_plain(acc, dl)
    return drop_lift_ntt(acc, divisor_intt(acc, dl, drop=True), dl)


def rescale_poly(c, dl):
    """Drop the last limb of c (..., l+1, N, NTT) with centered rounding:
    (..., l, N), two launches on a CUDA tensor, the plain version on a CPU
    tensor."""
    if c.device.type == "cpu":
        return rescale_poly_plain(c, dl)
    return rescale_lift_ntt(c, divisor_intt(c, dl, drop=False), dl)
