"""Composite minimax sign approximation (host-side, compile time).

Counterpart of `orion_tpu/crypto/minimax.py` (the same numpy and scipy
code, kept as the port's own copy): a chain of odd polynomials
p_k(...p_1(x)) approximating sign(x) on +-[2^-logalpha, 1], with the final
polynomial mapped to the step function (p+1)/2 in [0, 1].

Each stage is the solution of a linear program: minimise the sup-norm error
to sign on the current band, SUBJECT to |p(x)| <= 1 on the whole of
[-1, 1].  The boundedness constraint keeps dead-zone inputs
(|x| < 2^-logalpha) inside the next stage's Chebyshev domain.  The LP in
the Chebyshev-value basis is well conditioned even when the band is tiny,
and the HiGHS solution is accurate to ~1e-9.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog


def _lp_minimax_odd(degree: int, lo: float, hi: float = 1.0,
                    band_grid: int = 4000, bound_grid: int = 2000):
    """Best odd polynomial approx of 1 on [lo, hi] with |p| <= 1 on [0, 1].

    Returns (chebyshev coefficients over [-1, 1], band error).
    """
    ks = np.arange(1, degree + 1, 2)
    n = len(ks)

    band = np.linspace(lo, hi, band_grid)
    full = np.linspace(0.0, 1.0, bound_grid)

    A_band = np.polynomial.chebyshev.chebvander(band, degree)[:, ks]
    A_full = np.polynomial.chebyshev.chebvander(full, degree)[:, ks]

    nb, nf = len(band), len(full)
    # vars: c (n), t
    A_ub = np.vstack([
        np.hstack([A_band, -np.ones((nb, 1))]),    # p - 1 <= t
        np.hstack([-A_band, -np.ones((nb, 1))]),   # 1 - p <= t
        np.hstack([A_full, np.zeros((nf, 1))]),    # p <= 1
        np.hstack([-A_full, np.zeros((nf, 1))]),   # -p <= 1
    ])
    b_ub = np.concatenate([
        np.ones(nb), -np.ones(nb), np.ones(nf), np.ones(nf)])
    obj = np.zeros(n + 1)
    obj[-1] = 1.0
    res = linprog(obj, A_ub=A_ub, b_ub=b_ub,
                  bounds=[(None, None)] * n + [(0, None)], method="highs")
    if not res.success:
        raise RuntimeError(f"minimax LP failed: {res.message}")
    coefs = np.zeros(degree + 1)
    coefs[ks] = res.x[:n]
    return coefs, float(res.x[-1])


def generate_minimax_sign_coeffs(degrees, prec=128, logalpha=6, logerr=12):
    """Chebyshev coefficient sets for the composite sign -> step chain.

    Stage k approximates sign on the band [lo_k, 1]; outputs land in
    [1 - e_k, 1] (after 1/(1+e_k) normalisation), which becomes the next
    band.  The last stage becomes (p+1)/2 (step function).
    """
    lo = 2.0 ** (-logalpha)
    coeff_sets = []
    for i, degree in enumerate(degrees):
        coefs, e = _lp_minimax_odd(degree, lo)
        is_last = i == len(degrees) - 1
        if is_last:
            coefs = coefs / 2.0
            coefs[0] += 0.5
        else:
            coefs = coefs / (1.0 + e)
            lo = (1.0 - e) / (1.0 + e)
        coeff_sets.append(coefs.tolist())
    return coeff_sets
