"""Limb (RNS)-sharded hybrid key-switching over a torch.distributed group.

Counterpart of `orion_tpu/parallel/limbshard.py`.  The extended basis of a
level (its level+1 Q rows, then the special P rows: `_t_rows`) is cut into
M blocks of B = n_t / M rows, one per rank of the group (in a sharded
forward, at levels where M does not divide n_t, B = ceil(n_t / M) and the
last ranks hold fewer rows).  A rank holds its block of the key-switch key
(or reads its rows of a replicated key in place) and does 1/M of the
per-row work.  Collectives per key-switch, as
orion_tpu's:

  1. ONE all-gather of the rank's Q rows in the coefficient domain
     (level+1 rows in all), so that every rank converts every digit from
     its source rows;
  2. ONE all-reduce of the special rows of the inner product in the
     coefficient domain (2 x n_sp rows; each rank adds the rows it owns
     and zeros elsewhere, so the int64 sum of residues below 2^31 is
     exact), for the distributed ModDown.

Everything else runs on the rank's block, through the port's kernels on
the card (`kernels/keyswitch.py`, `kernels/ntt.py`): the inverse NTT of its
Q rows (`ntt_inv`), each digit's basis conversion and NTT onto its rows
(`ks_convert_rows`), the inner product with its key rows and the inverse
NTT of its special rows (`ks_inner_rows`), and the P-division of its Q
rows (`ks_moddown_rows`).  Every rank computes exactly the integers the
unsharded `keyswitch` computes for its rows (the v-correction sums whole
source rows in source order), so the result is equal bit for bit.

`ShardedKS.fn` is orion_tpu's sharded function: each rank gives its row
block of the ciphertext poly and of the key and gets its row block of the
result; `gather` assembles the blocks.  `LimbGroup` is the seam of a
sharded forward (`crypto.keyswitch.set_limb_group`): the ciphertext and
the keys stay replicated, as in orion_tpu's forward, each rank switches
its block, and the result's Q rows (or the extended rows, before ModDown)
are all-gathered back.

On a CPU tensor every step is its plain PyTorch version; the collectives
are the group's (gloo on the CPU).  Standard ring only: on the
ConjugateInvariant ring the rows are the n-wide orbit halves of a 2n lift,
which orion_tpu's limbshard does not handle either (it transforms with the
standard tables), and `row_block` raises.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..crypto.context import CKKSContext
from ..crypto.keyswitch import DevLevel, dev_level
from ..kernels.keyswitch import (ks_convert_rows, ks_inner_rows,
                                 ks_moddown_rows, row_block)
from ..kernels.ntt import ntt_inv

# calls and bytes of the collectives of this process (the output tensor's
# bytes: M blocks for an all-gather, the summed tensor for an all-reduce)
COLLECTIVES: Counter = Counter()


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(M, *t.shape): every rank's t, in group rank order."""
    m = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((m,) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t, group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_bytes"] += out.numel() * out.element_size()
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the group, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def _t_rows(ctx: CKKSContext, level: int) -> list[int]:
    """The extended basis of a level: Q rows 0..level, then the specials."""
    return list(range(level + 1)) + list(range(ctx.n_q, ctx.n_all))


@dataclass
class ShardedKS:
    """A limb-sharded key-switch at one level, for one rank of a group.

    Rank r holds the extended rows r*B .. r*B+B-1 (B = block).  Where M
    does not divide n_t (levels of a sharded forward), B = ceil(n_t / M)
    and the last ranks hold fewer rows, or none; every block is padded to
    B rows in the collectives, so global row g sits at g in the gathered
    result."""
    level: int
    m: int
    block: int
    nl: int
    n_sp: int
    rank: int
    group: object           # the torch.distributed group (None: the world)
    dl: DevLevel

    @property
    def blk(self):
        """This rank's rows lo..hi-1 and their tables (cached on the
        level)."""
        n_t = self.nl + self.n_sp
        lo = min(self.rank * self.block, n_t)
        return row_block(self.dl, lo, min(lo + self.block, n_t))

    # ---- orion_tpu's interface: row blocks in, row blocks out ----

    def pad_poly(self, c_ntt: torch.Tensor) -> torch.Tensor:
        """(level+1, N) poly -> (M, B, N) row blocks (zeros in special
        rows)."""
        n = c_ntt.shape[-1]
        full = c_ntt.new_zeros((self.m * self.block, n))
        full[: self.nl] = c_ntt
        return full.reshape(self.m, self.block, n)

    def shard_ksk(self, ksk_data, ksk_shoup, ctx: CKKSContext):
        """(kdig, 2, n_all, N) key -> (M, dnum, 2, B, N) row blocks (and
        its Shoup companions' blocks, or None for a lean key)."""
        rows = torch.as_tensor(_t_rows(ctx, self.level),
                               device=ksk_data.device)
        dnum = len(self.dl.digits)

        def cut(k):
            k = k[:dnum][:, :, rows]
            k = k.reshape(dnum, 2, self.m, self.block, k.shape[-1])
            return k.permute(2, 0, 1, 3, 4).contiguous()

        return cut(ksk_data), None if ksk_shoup is None else cut(ksk_shoup)

    def put(self, arr) -> torch.Tensor:
        """(M, ...) blocks -> this rank's block, on the level's device."""
        a = torch.as_tensor(arr)[self.rank]
        return a.to(self.dl.t.p.device).contiguous()

    def fn(self, c_blk, ksk_blk, ksk_sh_blk=None) -> torch.Tensor:
        """This rank's block of the switched poly, (2, B, N): its Q rows
        valid, as orion_tpu's sharded output.  c_blk (B, N) is the rank's
        block of `pad_poly`, the keys its block of `shard_ksk`."""
        blk = self.blk
        ext = ks_convert_rows(self._coeff(c_blk[None, :blk.nq]), self.dl,
                              blk)[0]
        work = ks_inner_rows(ext, self.dl, blk, ksk_blk, ksk_sh_blk,
                             self._local_rows())
        return self._moddown(work[None])[0]

    def gather(self, blk_out: torch.Tensor) -> torch.Tensor:
        """(..., rows, N) row blocks of every rank -> (..., M*B, N), each
        block padded to B rows."""
        lead, n = tuple(blk_out.shape[:-2]), blk_out.shape[-1]
        if blk_out.shape[-2] < self.block:
            pad = blk_out.new_zeros(lead + (self.block, n))
            pad[..., : blk_out.shape[-2], :] = blk_out
            blk_out = pad
        g = all_gather(blk_out, self.group).movedim(0, -3)
        return g.reshape(lead + (self.m * self.block, n))

    # ---- the replicated seam of a sharded forward ----

    def decompose(self, c_ntt: torch.Tensor) -> torch.Tensor:
        """c (nl, N) or (b, nl, N), replicated -> this rank's block of the
        decomposition, (dnum, rows, N) or (b, dnum, rows, N)."""
        blk = self.blk
        c3 = c_ntt if c_ntt.dim() == 3 else c_ntt[None]
        coeff = self._coeff(c3[:, blk.lo:blk.lo + blk.nq])
        if blk.hi > blk.lo:
            ext = ks_convert_rows(coeff, self.dl, blk)
        else:
            ext = coeff.new_zeros((c3.shape[0], len(self.dl.digits), 0,
                                   coeff.shape[-1]))
        return ext if c_ntt.dim() == 3 else ext[0]

    def finish(self, ext, ksk_data, ksk_shoup, trimmed, key_index, raw):
        """`ks_finish` (or `ks_finish_raw`) from this rank's block of the
        decomposition, keys replicated: the Q rows (the extended rows)
        of every item, gathered."""
        blk = self.blk
        if blk.hi > blk.lo:
            row_map = self.dl.kernel_row_map(trimmed)[blk.lo:blk.hi]
            work = ks_inner_rows(ext, self.dl, blk, ksk_data, ksk_shoup,
                                 row_map, key_index, moddown=not raw)
        else:
            lead = () if key_index is None else (key_index.shape[0],)
            work = ext.new_zeros(lead + (2, 0, ext.shape[-1]))
        if raw:
            return self.gather(work)[..., : self.nl + self.n_sp, :]
        w4 = work if key_index is not None else work[None]
        out = self.gather(self._moddown(w4))[..., : self.nl, :]
        return out if key_index is not None else out[0]

    # ---- the steps around the collectives ----

    def _local_rows(self) -> torch.Tensor:
        kt = self.dl.kernel_tables
        key = ("rows_local", self.block)
        if key not in kt:
            kt[key] = torch.arange(self.block, device=self.dl.t.p.device)
        return kt[key]

    def _coeff(self, q_rows: torch.Tensor) -> torch.Tensor:
        """This rank's Q rows (b, nq, N), NTT domain -> the coefficients
        of every Q row (b, nl, N): the inverse NTT on the rank's rows,
        then the all-gather."""
        blk = self.blk
        b, n = q_rows.shape[0], q_rows.shape[-1]
        mine = q_rows.new_zeros((b, self.block, n))
        if blk.nq:
            mine[:, :blk.nq] = ntt_inv(q_rows.contiguous(), blk.q_rows)
        full = all_gather(mine, self.group).movedim(0, 1)
        return full.reshape(b, self.m * self.block, n)[:, : self.nl] \
            .contiguous()

    def _moddown(self, work: torch.Tensor) -> torch.Tensor:
        """work (K, 2, rows, N), special rows in the coefficient domain ->
        (K, 2, rows, N) with the rank's Q rows divided by P (its special
        rows zero): the all-reduce of the special rows, then the
        ModDown."""
        blk = self.blk
        k, n = work.shape[0], work.shape[-1]
        rows = blk.hi - blk.lo
        sp = work.new_zeros((k, 2, self.n_sp, n))
        first = blk.lo + blk.nq - self.nl     # this rank's first special
        if rows > blk.nq:
            sp[:, :, first:first + rows - blk.nq] = work[:, :, blk.nq:]
        all_reduce_sum(sp, self.group)
        out = work.new_zeros((k, 2, rows, n))
        if blk.nq:
            x = torch.cat([work[:, :, :blk.nq], sp], dim=2)
            out[:, :, :blk.nq] = ks_moddown_rows(x, self.dl, blk)
        return out


def _sharded(dl: DevLevel, group, even: bool) -> ShardedKS:
    m = dist.get_world_size(group)
    rank = dist.get_rank(group)
    nl = dl.level + 1
    n_sp = dl.s.p.shape[0]
    n_t = nl + n_sp
    if even and n_t % m:
        raise ValueError(f"extended basis has {n_t} rows; a limb group of "
                         f"{m} needs m | n_t")
    if dl.ci is not None:
        raise ValueError("limb-sharded key-switching runs on the standard "
                         "ring only")
    return ShardedKS(level=dl.level, m=m, block=-(-n_t // m), nl=nl,
                     n_sp=n_sp, rank=rank, group=group, dl=dl)


def make_sharded_keyswitch(ctx: CKKSContext, level: int,
                           group=None) -> ShardedKS:
    """The limb-sharded key-switch at `level` over `group` (a
    torch.distributed group; None: the world), for the calling rank.  As
    orion_tpu's, it needs M | n_t."""
    return _sharded(dev_level(ctx, level), group, even=True)


class LimbGroup:
    """The key-switch seam of a limb-sharded forward: every key-switch of
    the process runs sharded over `group` while this is set
    (`crypto.keyswitch.set_limb_group`)."""

    def __init__(self, group=None):
        self.group = group
        self._levels: dict = {}    # id(level) -> (level, its ShardedKS)

    def sharded(self, dl: DevLevel) -> ShardedKS:
        if id(dl) not in self._levels:
            self._levels[id(dl)] = (dl, _sharded(dl, self.group,
                                                  even=False))
        return self._levels[id(dl)][1]

    def decompose(self, c_ntt, dl: DevLevel):
        return self.sharded(dl).decompose(c_ntt)

    def finish(self, ext, dl: DevLevel, ksk_data, ksk_shoup, trimmed,
               key_index, raw):
        return self.sharded(dl).finish(ext, ksk_data, ksk_shoup, trimmed,
                                       key_index, raw)
