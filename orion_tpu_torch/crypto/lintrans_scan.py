"""BSGS linear transforms with hoisted rotations and deferred ModDown.

Counterpart of `orion_tpu/crypto/lintrans_scan.py`.  orion_tpu writes the
rotation loops as `lax.scan` so its XLA programs stay small; the port runs
each scan as one batch: the baby steps of a key pack are one `ks_finish`
call over the pack, and the giant steps of a transform one `ks_decompose`
and one `ks_finish` (or `ks_finish_raw`) call, summed afterwards.  Modular
sums are exact, so the residues equal the scan's bit for bit.

Structure per transform (diag idx = g*n1 + b):
  1. baby steps : rot_b(ct) for every needed b, sharing ONE decomposition
                  of the ciphertext (hoisting) across rotations;
  2. diagonals  : acc[g] += pt_d * rot[b_pos(d)]      (elementwise)
  3. giant steps: out += rot_{g*n1}(acc[g])           (one batch)

Rotation keys for a set of amounts are stacked once, pre-permuted by the
inverse automorphism and trimmed to the level (KeyPack), cached per unique
(amounts, level).

Batches of queries: a ciphertext's data may carry leading query axes,
(..., 2, L, N) (`runtime/jit.make_batched_forward`).  Every step then runs
once over the batch: the queries' baby rotations of a pack are one
`ks_finish` launch whose items pair each key with each query's
decomposition, the giants of every query one `ks_decompose` and one
`ks_finish` launch, each key read in place through `key_index` (not
copied per query).  orion_tpu maps the same transform over the queries
with `jax.vmap`; the residues agree query for query.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import placement
from .ciphertext import Ciphertext
from .keyswitch import (dev_level, ks_decompose, ks_finish, ks_finish_raw,
                        mod_drop_rescale)
from .lintrans import choose_n1
from .modops import add_mod
from .ops import Evaluator

# diagonal products per batched product in the diagonal step, queries
# included: bounds the (chunk, queries, 2, L, N) temporary while keeping
# the loop short
_DIAG_CHUNK = 32


@dataclass
class KeyPack:
    """Stacked galois keys + NTT-domain permutations for rotation amounts.

    Keys are stored PRE-PERMUTED by the inverse automorphism, so a rotation
    becomes: inner-product the (hoisted, unpermuted) decomposition with the
    pre-permuted key, ModDown, then apply ONE permutation to the result:
    rot_b(ct) = tau_b(c0 + MD(sum_j D_j tau_b^-1(k_j))).
    """
    amounts: tuple
    perms: torch.Tensor            # (n, N) long: forward permutation tau_b
    ksk: torch.Tensor              # (n, dnum, 2, rows, N), tau_b^-1-applied
    ksk_shoup: torch.Tensor | None  # None: lean keys (Montgomery lift)
    level: int | None = None       # if set, ksk is trimmed to this level
    cache_key: tuple = None
    index: dict = field(default_factory=dict)  # device index tensors

    def slots_index(self, slots) -> torch.Tensor:
        """The pack slots `slots` as an int64 tensor on the keys' device
        (cached): the key_index of a batched ks_finish."""
        slots = tuple(int(s) for s in slots)
        if slots not in self.index:
            if any(not 0 <= s < len(self.amounts) for s in slots):
                raise ValueError(f"slots {slots} outside the pack of "
                                 f"{len(self.amounts)} keys")
            self.index[slots] = placement.buffer(slots, self.ksk.device)
        return self.index[slots]


def _permute(x, perms):
    """x[k][..., perms[k]] for each item k of x (K, ..., 2, L, N)."""
    shape = (perms.shape[0],) + (1,) * (x.dim() - 2) + (perms.shape[1],)
    return torch.gather(x, -1, perms.view(shape).expand_as(x))


def _queries(data) -> tuple:
    """The leading query axes of ciphertext data (..., 2, L, N)."""
    return tuple(data.shape[:-3])


def _query_keys(pack: "KeyPack", slots, nq: int) -> torch.Tensor:
    """The key_index of `slots` with each slot repeated for nq queries
    (item k * nq + b is key slot k for query b)."""
    return pack.slots_index(s for s in slots for _ in range(nq))


def build_key_pack(ev: Evaluator, amounts, level: int | None = None) -> KeyPack:
    """Stack keys for the given rotation amounts (cached on the evaluator).

    With `level` given, keys are TRIMMED to that level's digit count and
    prime rows: (dnum_l, 2, level+1+n_sp, N) instead of the full chain.
    With ev.lean_keys (bootstrapped configs) the Shoup companions are
    dropped, as orion_tpu does: ks_finish lifts the keys through a
    Montgomery product instead, half the pack's memory.  A trimmed pack is
    read in place through the level's trimmed row map (row r of the pack
    is extended row r), a full-chain one through the global prime rows.
    """
    amounts = tuple(sorted(set(int(a) % ev.ctx.slots for a in amounts)
                           - {0}))
    key = (amounts, level)
    if key in ev._key_packs:
        return ev._key_packs[key]
    ctx = ev.ctx
    dev = ctx.device
    lean = ev.lean_keys
    if level is not None:
        dl = dev_level(ctx, level)
        dnum_l = len(dl.digits)
        rows = dl.ksk_rows_idx
    perms, ks, kss = [], [], []
    for a in amounts:
        k = ctx.galois_element(a)
        gk = ev.keys.galois_key(k)
        perms.append(np.asarray(ctx.automorphism_perm(k), np.int64))
        inv_perm = torch.as_tensor(
            ctx.automorphism_perm(pow(k, -1, ctx.gal_mod)),
            dtype=torch.long, device=dev)
        # a key that io_mode stream spilled to the host comes back here
        kd, ksd = gk.data.to(dev), gk.shoup.to(dev)
        if level is not None:
            kd = kd[:dnum_l][:, :, rows]
            ksd = ksd[:dnum_l][:, :, rows]
        ks.append(kd[..., inv_perm])
        if not lean:
            kss.append(ksd[..., inv_perm])
    pack = KeyPack(
        amounts=amounts,
        perms=placement.buffer(np.stack(perms), dev),
        ksk=torch.stack(ks),
        ksk_shoup=None if lean else torch.stack(kss),
        level=level,
        cache_key=key,
    )
    ev._key_packs[key] = pack
    return pack


def rotate_scan(ev: Evaluator, ct: Ciphertext, pack: KeyPack):
    """All rotations of ct for the pack's amounts, sharing one hoisted
    decomposition per query.  Returns (n_amounts, ..., 2, L, N) in
    pack.amounts order, `...` the ciphertext's query axes."""
    if pack.level is not None and pack.level != ct.level:
        raise ValueError(
            f"KeyPack trimmed to level {pack.level} used at level {ct.level}")
    if not pack.amounts:
        return ct.data.new_zeros((0,) + tuple(ct.data.shape))
    dl = dev_level(ev.ctx, ct.level)
    qp = dl.q.p[:, None]
    queries = _queries(ct.data)
    nq = int(np.prod(queries, dtype=np.int64))
    c1 = ct.data.select(-3, 1)
    if queries:
        c1 = c1.reshape((nq,) + tuple(c1.shape[-2:])).contiguous()
    # one decomposition per query, shared by all its rotations, and one
    # ks_finish over the whole pack (and every query)
    ext = ks_decompose(c1, dl)
    ks = ks_finish(ext, dl, pack.ksk, pack.ksk_shoup,
                   trimmed=pack.level is not None,
                   key_index=_query_keys(pack, range(len(pack.amounts)), nq))
    ks = ks.reshape((len(pack.amounts),) + tuple(ct.data.shape))
    t0 = add_mod(ct.data.select(-3, 0), ks.select(-3, 0), qp)
    return _permute(torch.stack([t0, ks.select(-3, 1)], dim=-3), pack.perms)


@dataclass
class ScanTransform:
    """One compiled (slots x slots) block."""
    level: int
    n1: int
    pt_scale: float
    pts: torch.Tensor        # (n_d, L+1, N), pre-rotated by -g*n1
    b_pos: torch.Tensor      # (n_d,) long: index into the baby-rot stack
    g_pos: torch.Tensor      # (n_d,) long: index into the giant accumulator
    babies_full: tuple       # distinct baby values in b_pos order (may incl 0)
    babies: tuple            # baby rotation amounts needed (excluding 0)
    giants: tuple            # giant rotation amounts per accumulator row
    n_giants: int
    giant_rows: torch.Tensor  # (n_nonzero,) long: rows of nonzero giants


def bsgs_steps(diag_indices, slots, bsgs_ratio=2.0):
    """The baby-step count n1 of a block and the (giant, baby) step of
    each of its diagonals idx = g*n1 + b."""
    n1 = choose_n1(len(diag_indices), slots, bsgs_ratio)
    return n1, [divmod(int(idx) % slots, n1) for idx in diag_indices]


def bsgs_rotations(diag_indices, slots, bsgs_ratio=2.0) -> set:
    """The rotation amounts a block's BSGS evaluation asks keys for (the
    transform's nonzero `babies` and `giants`), known before any diagonal
    is encoded."""
    n1, steps = bsgs_steps(diag_indices, slots, bsgs_ratio)
    return {b for _, b in steps if b} | {g * n1 for g, _ in steps if g}


def compile_transform_scan(encoder, diagonals, level, slots,
                           bsgs_ratio=2.0, pt_scale=None) -> ScanTransform:
    """Encode the diagonals (pre-rotated for BSGS) at scale q_level, or at
    `pt_scale` when given."""
    ctx = encoder.ctx
    ql = float(pt_scale) if pt_scale is not None else float(
        ctx.q_primes[level])
    n1, steps = bsgs_steps(diagonals, slots, bsgs_ratio)

    entries = []
    for (g, b), vec in zip(steps, diagonals.values()):
        v = np.asarray(vec)
        dtype = np.complex128 if np.iscomplexobj(v) else np.float64
        v = v.astype(dtype)
        if v.shape[0] != slots:
            pad = np.zeros(slots, dtype=dtype)
            pad[: v.shape[0]] = v
            v = pad
        entries.append((g, b, np.roll(v, g * n1)))

    giants = sorted({g for g, _, _ in entries})
    babies = sorted({b for _, b, _ in entries})
    g_index = {g: i for i, g in enumerate(giants)}
    b_index = {b: i for i, b in enumerate(babies)}

    vecs = np.stack([v for _, _, v in entries])
    # the plain product needs no Shoup companions (orion_tpu stores them)
    data, _ = encoder.encode_batch(vecs, level=level, scale=ql)
    dev = ctx.device
    return ScanTransform(
        level=level, n1=n1, pt_scale=ql,
        pts=placement.buffer(data, dev),
        b_pos=placement.buffer([b_index[b] for _, b, _ in entries], dev),
        g_pos=placement.buffer([g_index[g] for g, _, _ in entries], dev),
        babies_full=tuple(babies),
        babies=tuple(b for b in babies if b != 0),
        giants=tuple(g * n1 for g in giants),
        n_giants=len(giants),
        giant_rows=placement.buffer(
            [i for i, g in enumerate(giants) if g != 0], dev),
    )


def _check_level(tr: ScanTransform, ct: Ciphertext):
    if ct.level > tr.level:
        raise ValueError(
            f"transform compiled at level {tr.level} fed a level-{ct.level} "
            f"ciphertext; align with mod_drop first")


def _diagonal_step(tr: ScanTransform, ct: Ciphertext, rots_cache: dict, qp):
    """acc[g] = sum over the diagonals d of giant g of pt_d * rot_{b(d)},
    (n_giants, ..., 2, L, N) with the ciphertext's query axes.

    Residues are < 2^31, so up to _DIAG_CHUNK products add in int64
    before one reduction; the modular sum equals orion_tpu's sequential
    add_mod chain bit for bit."""
    nl = ct.level + 1
    queries = _queries(ct.data)
    rot_stack = torch.stack([rots_cache[b] for b in tr.babies_full])
    acc = ct.data.new_zeros((tr.n_giants,) + queries
                            + (2, nl, ct.data.shape[-1]))
    # the plaintexts broadcast over the query axes and both polys
    bcast = (None,) * (len(queries) + 1)
    chunk = max(1, _DIAG_CHUNK // int(np.prod(queries, dtype=np.int64)))
    for lo in range(0, tr.pts.shape[0], chunk):
        hi = lo + chunk
        pts = tr.pts[(slice(lo, hi),) + bcast + (slice(None, nl),)]
        prod = rot_stack[tr.b_pos[lo:hi]] * pts % qp
        acc.index_add_(0, tr.g_pos[lo:hi], prod)
        acc %= qp
    return acc


def _giant_batch(ev: Evaluator, tr: ScanTransform, level: int, nq: int):
    """The nonzero giants of nq queries as one batch: (pack, their
    accumulator rows, their pack slots, the key_index of the giants' items
    giant-major), or None.  The slots are passed explicitly: a giant's
    pack slot need not follow its row."""
    nonzero = [a for a in tr.giants if a != 0]
    if not nonzero:
        return None
    pack = build_key_pack(ev, nonzero, level=level)
    slot = {a: s for s, a in enumerate(pack.amounts)}
    slots = [slot[a] for a in nonzero]
    return (pack, tr.giant_rows, pack.slots_index(slots),
            _query_keys(pack, slots, nq))


def _giant_items(sel):
    """The c1 of every (giant, query) of `sel` (G, ..., 2, L, N) as items
    (G * queries, L, N), giant-major, for one ks_decompose."""
    c1 = sel.select(-3, 1)
    return c1.reshape((-1,) + tuple(c1.shape[-2:])).contiguous()


def eval_transform_scan(ev: Evaluator, tr: ScanTransform, ct: Ciphertext,
                        rots_cache: dict) -> Ciphertext:
    """Evaluate one block given a shared baby-rotation cache for this ct.

    rots_cache maps baby amount -> (..., 2, L, N); amount 0 is the ct.
    Returns the UN-rescaled accumulated ciphertext at scale Delta*q_level.
    """
    _check_level(tr, ct)
    dl = dev_level(ev.ctx, ct.level)
    qp = dl.q.p[:, None]
    acc = _diagonal_step(tr, ct, rots_cache, qp)

    out = acc[0] if tr.giants and tr.giants[0] == 0 else None
    nq = int(np.prod(_queries(ct.data), dtype=np.int64))
    batch = _giant_batch(ev, tr, ct.level, nq)
    if batch is not None:
        pack, rows, slots, key_index = batch
        sel = acc.index_select(0, rows)
        ks = ks_finish(ks_decompose(_giant_items(sel), dl), dl,
                       pack.ksk, pack.ksk_shoup,
                       trimmed=pack.level is not None, key_index=key_index)
        ks = ks.reshape(sel.shape)
        t0 = add_mod(sel.select(-3, 0), ks.select(-3, 0), qp)
        rot = _permute(torch.stack([t0, ks.select(-3, 1)], dim=-3),
                       pack.perms.index_select(0, slots))
        # residues < 2^31: the int64 sum of the giants is exact
        part = rot.sum(0) % qp
        out = part if out is None else add_mod(out, part, qp)
    if out is None:
        raise ValueError("empty transform")
    return Ciphertext(out, ct.level, ct.scale * tr.pt_scale)


def baby_rotation_cache(ev: Evaluator, ct: Ciphertext, amounts) -> dict:
    """rot_b(ct) for all amounts (shared across blocks in a row/column)."""
    amounts = sorted(set(int(a) for a in amounts))
    cache = {0: ct.data}
    todo = [a for a in amounts if a != 0]
    if todo:
        pack = build_key_pack(ev, todo, level=ct.level)
        rots = rotate_scan(ev, ct, pack)
        for slot, a in enumerate(pack.amounts):
            cache[a] = rots[slot]
    return cache


def eval_transform_scan_ext(ev: Evaluator, tr: ScanTransform,
                            ct: Ciphertext, rots_cache: dict):
    """eval_transform_scan with DEFERRED ModDown: returns the extended-basis
    accumulator (..., 2, n_t, N) in NTT domain, Q-basis contributions
    folded in as P*x.  The caller sums accumulators across column blocks
    and divides ONCE by P*q_l (mod_drop_rescale), all output rows in one
    call.
    """
    _check_level(tr, ct)
    dl = dev_level(ev.ctx, ct.level)
    qp = dl.q.p[:, None]
    tp = dl.t.p[:, None]
    nl = ct.level + 1
    n_t = dl.t.p.shape[0]
    acc = _diagonal_step(tr, ct, rots_cache, qp)

    def fold_q(x_q):
        """Q-basis (..., nl, N) value -> extended accumulator as P*x
        (special rows of P*x vanish: P = 0 mod each special prime)."""
        px = x_q * dl.p_mod_q % qp
        zeros = px.new_zeros(tuple(px.shape[:-2]) + (n_t - nl, px.shape[-1]))
        return torch.cat([px, zeros], dim=-2)

    out = fold_q(acc[0]) if tr.giants and tr.giants[0] == 0 else None
    nq = int(np.prod(_queries(ct.data), dtype=np.int64))
    batch = _giant_batch(ev, tr, ct.level, nq)
    if batch is not None:
        pack, rows, slots, key_index = batch
        sel = acc.index_select(0, rows)
        raw = ks_finish_raw(ks_decompose(_giant_items(sel), dl), dl,
                            pack.ksk, pack.ksk_shoup,
                            trimmed=pack.level is not None,
                            key_index=key_index)
        raw = raw.reshape(tuple(sel.shape[:-2]) + (n_t, sel.shape[-1]))
        pc0 = sel.select(-3, 0) * dl.p_mod_q % qp
        raw0 = raw.select(-3, 0)
        r0 = torch.cat([add_mod(raw0[..., :nl, :], pc0, qp),
                        raw0[..., nl:, :]], dim=-2)
        rot = _permute(torch.stack([r0, raw.select(-3, 1)], dim=-3),
                       pack.perms.index_select(0, slots))
        part = rot.sum(0) % tp
        out = part if out is None else add_mod(out, part, tp)
    if out is None:
        raise ValueError("empty transform")
    return out


def eval_transform_blocked_scan(ev: Evaluator, grid: dict,
                                cts: list[Ciphertext],
                                num_rows: int) -> list[Ciphertext]:
    """Blocked transform: accumulate column blocks, ONE rescale per output
    row (lt_evaluator semantics)."""
    num_cols = len(cts)
    # align inputs to the compiled transform level (a ciphertext may
    # arrive above the solver-assigned layer level; the drop is free)
    col_level = {}
    for (i, j), tr in grid.items():
        col_level[j] = min(col_level.get(j, tr.level), tr.level)
    cts = [ev.mod_drop(c, col_level[j]) if c.level > col_level.get(j, c.level)
           else c for j, c in enumerate(cts)]
    babies_per_col = {j: set() for j in range(num_cols)}
    for (i, j), tr in grid.items():
        babies_per_col[j] |= set(tr.babies) | {0}
    rot_caches = {
        j: baby_rotation_cache(ev, cts[j], babies_per_col[j])
        for j in range(num_cols)
    }

    levels = {c.level for c in cts}
    if len(levels) == 1:
        lvl = cts[0].level
        dl = dev_level(ev.ctx, lvl)
        if dl.dropdown is not None:
            # deferred path: per (row, col) the giants accumulate in the
            # extended basis; column blocks sum there too; ONE fused
            # ModDown+rescale over the stacked output rows.  The plaintext
            # scale is taken from the first grid cell, as orion_tpu does.
            tp = dl.t.p[:, None]
            pt_scale = next(iter(grid.values())).pt_scale
            accs = []
            for i in range(num_rows):
                acc = None
                for j in range(num_cols):
                    tr = grid.get((i, j))
                    if tr is None:
                        continue
                    part = eval_transform_scan_ext(ev, tr, cts[j],
                                                   rot_caches[j])
                    acc = part if acc is None else add_mod(acc, part, tp)
                accs.append(acc)
            data = mod_drop_rescale(torch.stack(accs), dl)
            scale = cts[0].scale * pt_scale / ev.ctx.q_primes[lvl]
            return [Ciphertext(d, lvl - 1, scale) for d in data]

    outs = []
    for i in range(num_rows):
        acc = None
        for j in range(num_cols):
            tr = grid.get((i, j))
            if tr is None:
                continue
            part = eval_transform_scan(ev, tr, cts[j], rot_caches[j])
            acc = part if acc is None else ev.add(acc, part)
        outs.append(ev.rescale(acc))
    return outs
