"""Homomorphic polynomial evaluation (monomial and Chebyshev bases).

Counterpart of `orion_tpu/crypto/polyeval.py`, the same algorithm step for
step, so the ciphertexts agree bit for bit.  Depth =
ceil(log2(#coeffs)).

Algorithm: depth-optimal binary splitting.  Powers T_2, T_4, ...,
T_{2^(m-1)} by repeated squaring (monomial) / double-angle (Chebyshev:
T_{a+b} = 2 T_a T_b - T_{|a-b|}); the polynomial splits recursively as
p = q * T_g + r (with the Chebyshev product correction) all the way down
to linear chunks, reaching exactly depth = ceil(log2(#coeffs)) with every
scalar coefficient encoded at a ~q-sized scale.

Scale management: every recombination term is steered to one exact output
scale by encoding each scalar coefficient at scale
    s_i = target * q_(level_i) / scale(T_i),
so each multiply-then-rescale lands on `target` to float precision.  An
optional `output_scale` pins the result scale (used by `_Sign`).

Large polynomials (degree >= _BSGS_MIN_DEGREE, i.e. bootstrap EvalMod)
stop the recursion at baby-step chunks of size k ~ sqrt(degree) evaluated
as direct coefficient sums over the cached Chebyshev babies (classic
Paterson-Stockmeyer): ~2*sqrt(d) ciphertext products instead of ~d/2, for
ONE extra level: depth 2*ceil(log2(d+1)) + 1 in hi_scale mode
(`chunked_depth`).

Batches: the Evaluator takes ciphertexts whose data carry a leading batch
axis (B, 2, L, N), so one call evaluates the polynomial on B ciphertexts
that share a level and a scale, every kernel launch covering the batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .ciphertext import Ciphertext
from .ops import Evaluator

_COEF_EPS = 1e-12

# below this degree the depth-optimal binary splitting runs to linear
# leaves (activations keep their level plans); at or above it, chunked
# Paterson–Stockmeyer kicks in
_BSGS_MIN_DEGREE = 32


def chunk_size(degree: int) -> int:
    """Baby-step size for chunked evaluation: 2^round(log2(sqrt(d+1)))."""
    if degree < _BSGS_MIN_DEGREE:
        return 2  # recursion runs to linear leaves (no chunking)
    return 1 << int(round(math.log2(math.sqrt(degree + 1))))


def chunked_depth(degree: int) -> int:
    """Levels consumed by evaluate_polynomial in hi_scale chunked mode."""
    return 2 * int(math.ceil(math.log2(degree + 1))) + 1


def hi_scale_depth(degree: int) -> int:
    """Levels evaluate_polynomial(hi_scale=True) consumes for this degree
    (chunked PS above the threshold, binary splitting below)."""
    if degree >= _BSGS_MIN_DEGREE:
        return chunked_depth(degree)
    return 2 * int(math.ceil(math.log2(degree + 1)))


@dataclass
class Polynomial:
    """Compiled polynomial object (reference GenerateMonomial/Chebyshev)."""
    coeffs: list[float]
    basis: str  # "monomial" | "chebyshev"

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    @property
    def depth(self) -> int:
        return int(math.ceil(math.log2(len(self.coeffs))))


class PowerBasis:
    """Lazy cache of ciphertext powers of x in the chosen basis.

    hi_scale mode: the working scale is ~x.scale^2 / default_scale (e.g.
    2^52 for Delta = 2^26) and every ct-ct product rescales TWICE — the
    32-bit-lane equivalent of evaluating at a double-width prime, which
    keeps bootstrap EvalMod far above the noise floor.
    """

    def __init__(self, ev: Evaluator, x: Ciphertext, basis: str,
                 hi_scale: bool = False):
        self.ev = ev
        self.basis = basis
        self.hi = hi_scale
        self.cache: dict[int, Ciphertext] = {1: x}
        self.work_scale = x.scale

    @property
    def rescales_per_mult(self) -> int:
        return 2 if self.hi else 1

    def _norm(self, t: Ciphertext) -> Ciphertext:
        if self.hi:
            t = self.ev.rescale(t)
        return t

    def get(self, i: int) -> Ciphertext:
        if i in self.cache:
            return self.cache[i]
        ev = self.ev
        a = (i + 1) // 2
        b = i // 2
        ta, tb = self.get(a), self.get(b)
        if self.basis == "monomial":
            out = self._norm(ev.mul_relin(ta, tb))
        else:
            # T_{a+b} = 2*T_a*T_b - T_{a-b}, a-b in {0, 1}
            t = self._norm(ev.mul_relin(ta, tb))
            t = ev.mul_scalar_int(t, 2)
            if a == b:
                out = ev.sub_scalar(t, 1.0)
            else:
                tc = self.get(a - b)
                # align T_{a-b} to the product's scale (one spare level)
                tc = ev.adjust_scale(tc, t.scale)
                out = ev.sub(t, tc)
        self.cache[i] = out
        return out

    def level_of(self, i: int) -> int:
        return self.get(i).level


def _nonzero_deg(coeffs: list[float]) -> int:
    d = -1
    for i, c in enumerate(coeffs):
        if abs(c) > _COEF_EPS:
            d = i
    return d


def evaluate_polynomial(ev: Evaluator, x: Ciphertext, poly: Polynomial,
                        output_scale: float | None = None,
                        hi_scale: bool = False) -> Ciphertext:
    """Evaluate poly(x) homomorphically.  Returns ct at `output_scale`
    (default: x.scale).  hi_scale doubles rescales per multiplication for
    wide working scales (bootstrap EvalMod)."""
    target = float(output_scale) if output_scale else x.scale
    d = _nonzero_deg(poly.coeffs)
    if d <= 0:
        raise ValueError("constant polynomial: nothing to evaluate")
    m = max(1, int(math.ceil(math.log2(d + 1))))
    pb = PowerBasis(ev, x, poly.basis, hi_scale=hi_scale)
    pb.baby_k = chunk_size(d)
    for k in range(1, m):
        pb.get(1 << k)  # power-of-two powers (babies + giants)
    out = _eval_rec(ev, pb, list(poly.coeffs[: d + 1]), target)
    if out is None:
        raise ValueError("polynomial had no evaluable terms")
    ct, const = out
    if abs(const) > _COEF_EPS:
        ct = ev.add_scalar(ct, const)
    return ct


def _eval_rec(ev: Evaluator, pb: PowerBasis, coeffs: list[float],
              target: float):
    """Recursive PS evaluation steering every term to scale `target`.

    Returns (ct, pending_constant) or None if all coefficients vanish.
    The constant term is returned un-applied so callers can fold it into a
    single add_scalar at the end (saves encodings).
    """
    d = _nonzero_deg(coeffs)
    if d < 0:
        return None
    if d == 0:
        return None if abs(coeffs[0]) <= _COEF_EPS else (None, coeffs[0])

    if d < max(getattr(pb, "baby_k", 2), 2):
        # baby chunk: direct coefficient sum over cached powers, every
        # term steered to `target` (Paterson–Stockmeyer leaves)
        acc = None
        for j in range(1, d + 1):
            if abs(coeffs[j]) <= _COEF_EPS:
                continue
            tj = pb.get(j)
            enc_scale = target * ev.ctx.q_primes[tj.level] / tj.scale
            term = ev.mul_scalar_at(tj, coeffs[j], enc_scale
                                    ).with_(scale=target)
            acc = term if acc is None else ev.add(acc, term)
        return (acc, coeffs[0])

    # giant split at g = largest power of two <= d (and >= baby)
    g = 1 << (d.bit_length() - 1)
    tg = pb.get(g)
    if pb.basis == "monomial":
        q = coeffs[g:]
        r = coeffs[:g]
    else:
        q = [coeffs[g]] + [2.0 * c for c in coeffs[g + 1:]]
        r = list(coeffs[:g])
        for i in range(g + 1, d + 1):
            r[2 * g - i] -= coeffs[i]

    # predict the product level to steer q's target scale
    lq = _predict_level(ev, pb, q)
    if lq is None:
        # q is a pure constant: q*T_g is a scalar multiple of T_g
        cq = q[0]
        enc_scale = target * ev.ctx.q_primes[tg.level] / tg.scale
        qterm = ev.mul_scalar_at(tg, cq, enc_scale).with_(scale=target)
    else:
        lp = min(lq, tg.level)
        drop = ev.ctx.q_primes[lp]
        if pb.hi:
            drop *= ev.ctx.q_primes[lp - 1]
        target_q = target * drop / tg.scale
        qres = _eval_rec(ev, pb, q, target_q)
        q_ct, q_const = qres
        if q_ct is None:
            enc_scale = target * ev.ctx.q_primes[tg.level] / tg.scale
            qterm = ev.mul_scalar_at(tg, q_const, enc_scale
                                     ).with_(scale=target)
        else:
            if abs(q_const) > _COEF_EPS:
                q_ct = ev.add_scalar(q_ct, q_const)
            qterm = ev.mul_relin(q_ct, tg, rescale=False)
            qterm = ev.rescale(qterm)
            if pb.hi:
                qterm = ev.rescale(qterm)
            qterm = qterm.with_(scale=target)

    rres = _eval_rec(ev, pb, r, target)
    if rres is None:
        return (qterm, 0.0)
    r_ct, r_const = rres
    if r_ct is None:
        return (qterm, r_const)
    return (ev.add(qterm, r_ct), r_const)


def _predict_level(ev: Evaluator, pb: PowerBasis, coeffs: list[float]):
    """Level the ct from _eval_rec(coeffs) will have (None if constant)."""
    d = _nonzero_deg(coeffs)
    if d <= 0:
        return None
    if d < max(getattr(pb, "baby_k", 2), 2):
        return min(pb.get(j).level
                   for j in range(1, d + 1)
                   if abs(coeffs[j]) > _COEF_EPS) - 1
    g = 1 << (d.bit_length() - 1)
    tg = pb.get(g)
    if pb.basis == "monomial":
        q = coeffs[g:]
        r = coeffs[:g]
    else:
        q = [coeffs[g]] + [2.0 * c for c in coeffs[g + 1:]]
        r = list(coeffs[:g])
        for i in range(g + 1, d + 1):
            r[2 * g - i] -= coeffs[i]
    lq = _predict_level(ev, pb, q)
    lp = (tg.level if lq is None else min(lq, tg.level)) \
        - pb.rescales_per_mult
    lr = _predict_level(ev, pb, r)
    return lp if lr is None else min(lp, lr)
