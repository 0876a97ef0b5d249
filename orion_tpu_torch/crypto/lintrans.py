"""Homomorphic linear transforms: the naive BSGS diagonal matvec.

Counterpart of `orion_tpu/crypto/lintrans.py`.  A transform is a dict of
generalised diagonals {idx: vec}; the matvec is
    out = sum_idx  diag_idx * rot(ct, idx).
Baby-step/giant-step: idx = g*n1 + b, diagonals pre-rotated by -g*n1 at
compile time, so
    out = sum_g rot( sum_b  pt[g,b] * rot(ct, b),  g*n1 )
costing ~(n1 + #giants) key-switches instead of #diags.

Diagonal plaintexts are encoded at scale q_l (errorless rescale), with
their Shoup companions as orion_tpu stores them; products accumulate at
Delta*q_l and the caller rescales once per output ciphertext.  Every
rotation is one `Evaluator.rotate` (a key-switch through the kernels on
the card), every product one `mul_plain`: this is the test oracle of the
batched form in `lintrans_scan.py`, which the nets run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import placement
from .ciphertext import Ciphertext, Plaintext
from .ops import Evaluator


def choose_n1(num_diags: int, slots: int, bsgs_ratio: float = 2.0) -> int:
    """Baby-step count: power of two near sqrt(#diags * ratio)."""
    if num_diags <= 1:
        return 1
    target = math.sqrt(num_diags * max(bsgs_ratio, 0.25))
    n1 = 1 << max(0, round(math.log2(target)))
    return int(min(max(n1, 1), slots))


@dataclass
class CompiledTransform:
    """One (slots x slots) block, compiled: pre-rotated encoded diagonals."""
    level: int
    n1: int
    # plaintexts[(g, b)] for diagonal idx = g*n1 + b
    plaintexts: dict = field(default_factory=dict)
    giants: list = field(default_factory=list)   # sorted distinct g values
    babies: list = field(default_factory=list)   # sorted distinct b values

    def rotations_needed(self) -> set[int]:
        rots = {b for b in self.babies if b != 0}
        rots |= {g * self.n1 for g in self.giants if g != 0}
        return rots


def compile_transform(encoder, diagonals: dict[int, np.ndarray], level: int,
                      slots: int, bsgs_ratio: float = 2.0
                      ) -> CompiledTransform:
    """Encode diagonals (pre-rotated for BSGS) at scale q_level."""
    ctx = encoder.ctx
    ql = float(ctx.q_primes[level])
    n1 = choose_n1(len(diagonals), slots, bsgs_ratio)
    out = CompiledTransform(level=level, n1=n1)
    giants, babies = set(), set()
    for idx, vec in diagonals.items():
        g, b = divmod(int(idx) % slots, n1)
        giants.add(g)
        babies.add(b)
        v = np.asarray(vec, dtype=np.float64)
        if v.shape[0] != slots:
            padded = np.zeros(slots)
            padded[: v.shape[0]] = v
            v = padded
        v_rot = np.roll(v, g * n1)  # pre-rotate by -g*n1 slots (roll right)
        data, shoup, scale = encoder.encode(
            v_rot, level=level, scale=ql, with_shoup=True)
        out.plaintexts[(g, b)] = Plaintext(
            placement.buffer(data, ctx.device),
            placement.buffer(shoup, ctx.device), level, scale)
    out.giants = sorted(giants)
    out.babies = sorted(babies)
    return out


def baby_rotations(ev: Evaluator, ct: Ciphertext,
                   babies: list[int]) -> dict[int, Ciphertext]:
    """rot(ct, b) for each baby step (b=0 is the ct itself)."""
    return {b: (ct if b == 0 else ev.rotate(ct, b)) for b in babies}


def eval_transform(ev: Evaluator, tr: CompiledTransform,
                   rots: dict[int, Ciphertext]) -> Ciphertext:
    """BSGS matvec given precomputed baby rotations.

    Returns an UN-rescaled ciphertext at scale Delta*q_level; the caller
    accumulates column blocks and rescales once.
    """
    acc = None
    for g in tr.giants:
        inner = None
        for b in tr.babies:
            if (g, b) not in tr.plaintexts:
                continue
            term = ev.mul_plain(rots[b], tr.plaintexts[(g, b)], rescale=False)
            inner = term if inner is None else ev.add(inner, term)
        if inner is None:
            continue
        if g != 0:
            inner = ev.rotate(inner, g * tr.n1)
        acc = inner if acc is None else ev.add(acc, inner)
    if acc is None:
        raise ValueError("empty transform")
    return acc


def eval_transform_blocked(ev: Evaluator, grid: dict, cts: list[Ciphertext],
                           num_rows: int) -> list[Ciphertext]:
    """Blocked transform: out_row i = rescale( sum_j T[i,j] @ ct[j] ).

    grid[(i, j)] is a CompiledTransform; every block shares the input ct's
    baby rotations per column j.
    """
    num_cols = len(cts)
    # union of babies per column so rotations are computed once
    babies_per_col: dict[int, set] = {j: set() for j in range(num_cols)}
    for (i, j), tr in grid.items():
        babies_per_col[j] |= set(tr.babies)
    rots_per_col = {
        j: baby_rotations(ev, cts[j], sorted(babies_per_col[j]))
        for j in range(num_cols)
    }
    outs = []
    for i in range(num_rows):
        acc = None
        for j in range(num_cols):
            tr = grid.get((i, j))
            if tr is None:
                continue
            part = eval_transform(ev, tr, rots_per_col[j])
            acc = part if acc is None else ev.add(acc, part)
        outs.append(ev.rescale(acc))
    return outs
