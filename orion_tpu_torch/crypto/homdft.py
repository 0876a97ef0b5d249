"""Special-FFT factorisation for the homomorphic DFT (bootstrapping CtS/StC).

Counterpart of `orion_tpu/crypto/homdft.py` (the same numpy and scipy
code, kept as the port's own copy).

The canonical-embedding evaluation y_j = sum_k c_k zeta^(e_j k)
(e_j = 5^j mod 2N, j < n = N/2) factors exactly like a radix-2 FFT:
since 5^(n/2) = N+1 (mod 2N), the second half of the orbit flips the sign
of odd-k terms, giving the classic butterfly

    y_j      = A_j + w_j B_j         w_j = zeta^(E_j)
    y_{j+h}  = A_j - w_j B_j         (h = n_sub/2)

with A/B the transforms of the even/odd coefficients (half root order).
Recursing to length-2 base cases (which contribute c_a + i*c_b since every
exponent is 1 mod 4):

    decode(c) = B_1 B_2 ... B_log2(n) fold(c)

where each stage B_s is a sparse complex matrix with generalised diagonals
{0, +h_s, -h_s} and fold packs N real coefficients into n complex slots.

For the homomorphic evaluation:
  * StC applies B_1..B_k directly (slots <- coefficients);
  * CtS applies the inverse chain B_k^-1 .. B_1^-1 (each inverse butterfly
    is again 3-diagonal), then splits real/imag parts with ONE conjugation
    — the only real-linear step, exactly Lattigo's structure;
  * adjacent stages are merged by sparse products into radix-2^g groups
    (<= 2^(g+1)-1 diagonals) to trade rotations for depth.

Everything here is host numpy/scipy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def build_fold(n: int):
    """Sparse (n x 2n) complex matrix F with decode(c) = B_1..B_k (F c).

    Built by the same recursion as the stages so leaf ordering is exact.
    """
    big_n = 2 * n
    entries = []  # (row, col, val)

    def rec(start, coeff_idx, nslots):
        if nslots == 1:
            a, b = coeff_idx
            entries.append((start, a, 1.0))
            entries.append((start, b, 1j))
            return
        h = nslots // 2
        rec(start, coeff_idx[0::2], h)
        rec(start + h, coeff_idx[1::2], h)

    rec(0, list(range(big_n)), n)
    rows = [r for r, _, _ in entries]
    cols = [c for _, c, _ in entries]
    vals = [v for _, _, v in entries]
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, big_n),
                         dtype=np.complex128)


def build_stages(n: int):
    """Butterfly stage matrices [B_1, ..., B_log2(n)] (B_1 outermost).

    Exponent bookkeeping: each subproblem carries its slots' evaluation
    exponents modulo its own root order m_sub; the stage twiddle at local
    slot j is exp(2*pi*i * exps[j] / m_sub).
    """
    logn = n.bit_length() - 1
    big_n = 2 * n
    m = 2 * big_n

    e = np.empty(n, dtype=np.int64)
    acc = 1
    for j in range(n):
        e[j] = acc
        acc = (acc * 5) % m

    stage_entries: list[list] = [[] for _ in range(logn)]

    def rec(start, exps, m_sub, depth):
        nslots = len(exps)
        if nslots == 1:
            return
        h = nslots // 2
        w = np.exp(2j * np.pi * (exps[:h] % m_sub) / m_sub)
        ent = stage_entries[depth]
        for j in range(h):
            ent.append((start + j, start + j, 1.0))
            ent.append((start + j, start + h + j, w[j]))
            ent.append((start + h + j, start + j, 1.0))
            ent.append((start + h + j, start + h + j, -w[j]))
        sub = exps[:h] % (m_sub // 2)
        rec(start, sub, m_sub // 2, depth + 1)
        rec(start + h, sub, m_sub // 2, depth + 1)

    rec(0, e, m, 0)
    stages = []
    for ent in stage_entries:
        rows = [r for r, _, _ in ent]
        cols = [c for _, c, _ in ent]
        vals = [v for _, _, v in ent]
        stages.append(sp.csr_matrix((vals, (rows, cols)), shape=(n, n),
                                    dtype=np.complex128))
    return stages


def invert_stage(B: sp.csr_matrix) -> sp.csr_matrix:
    """Inverse of a butterfly stage: [[1,w],[1,-w]]^-1 = 1/2 [[1,1],[w^-1,-w^-1]].

    Computed generically: stages are unitary-up-to-scaling block butterflies;
    B^-1 = B^H D with D diagonal... we simply invert per 2x2 block by
    exploiting that B B^H = 2 I when |w| = 1:  B^-1 = B^H / 2.
    """
    return sp.csr_matrix(B.conjugate().transpose() / 2.0)


def group_stages(stages: list, num_groups: int) -> list:
    """Merge adjacent stages into `num_groups` products.

    Input order is application order (first applied = index 0); output
    preserves application order: out[0] applied first.
    """
    k = len(stages)
    num_groups = max(1, min(num_groups, k))
    sizes = [k // num_groups + (1 if i < k % num_groups else 0)
             for i in range(num_groups)]
    out = []
    idx = 0
    for s in sizes:
        # product applied-first-last: stages applied in sequence s_i then
        # s_{i+1}: combined matrix = s_{i+1} @ s_i
        m = stages[idx]
        for j in range(idx + 1, idx + s):
            m = stages[j] @ m
        out.append(sp.csr_matrix(m))
        idx += s
    return out


def matrix_diagonals(mat: sp.csr_matrix) -> dict[int, np.ndarray]:
    """Generalised diagonals {d: vec} with mat @ v = sum_d vec_d * rot(v, d)."""
    n = mat.shape[0]
    coo = mat.tocoo()
    diags: dict[int, np.ndarray] = {}
    for r, c, v in zip(coo.row, coo.col, coo.data):
        d = int((c - r) % n)
        if d not in diags:
            diags[d] = np.zeros(n, dtype=np.complex128)
        diags[d][r] = v
    return diags


def cts_matrices(n: int, num_groups: int, scale: float):
    """CoeffsToSlots grouped matrices (application order), total map =
    scale * (B_k^-1 .. B_1^-1)."""
    stages = build_stages(n)  # [B_1..B_k], decode applies B_k first
    inv = [invert_stage(B) for B in stages]  # CtS applies B_1^-1 first
    groups = group_stages(inv, num_groups)
    # distribute the scalar evenly so no single matrix has tiny entries
    s = scale ** (1.0 / len(groups))
    return [sp.csr_matrix(g * s) for g in groups]


def stc_matrices(n: int, num_groups: int, scale: float):
    """SlotsToCoeffs grouped matrices (application order), total map =
    scale * (B_1 .. B_k) — apply B_k first."""
    stages = build_stages(n)
    seq = list(reversed(stages))  # B_k applied first
    groups = group_stages(seq, num_groups)
    s = scale ** (1.0 / len(groups))
    return [sp.csr_matrix(g * s) for g in groups]
