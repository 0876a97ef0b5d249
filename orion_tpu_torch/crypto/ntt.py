"""The ConjugateInvariant ring's transforms as plain PyTorch ops (int64).

Counterpart of the CI part of `orion_tpu/crypto/ntt.py` (`ci_lift`,
`ci_ntt`, `ci_intt`), over the port's four-step transforms
(`crypto/ntt4.py`).  A CI element of degree n is stored as n coefficients
and transformed through the 2n-degree standard ring:

  forward: lift to the antisymmetric 2n representative
           (a_0..a_{n-1}, 0, -a_{n-1}..-a_1) mod p, 2n-point negacyclic
           NTT, keep the n orbit positions `keep` (CI slot j evaluates at
           psi^(5^j));
  inverse: gather the 2n positions from the n values through `src` (a CI
           element takes equal values at e and -e), 2n-point inverse NTT
           times (2n)^-1, keep the first n coefficients (the tail is the
           lift's mirror).

These are the plain versions of the kernels' CI map (`kernels/ntt.py`,
`kernels/rescale.py`, `kernels/keyswitch.py`): on a CUDA tensor they still
run as torch ops, which is how the kernels are checked on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ntt4 import intt4, ntt4


@dataclass
class CIMap:
    """The orbit maps of a CI ring of degree n, on the device (int64)."""
    n: int                      # stored coefficients (and slots)
    keep: torch.Tensor          # (n,) 2n-NTT position kept for CI slot j
    src: torch.Tensor           # (2n,) CI slot feeding 2n position g
    pos: torch.Tensor           # (2n,) CI slot stored from position g, or -1

    @classmethod
    def from_ctx(cls, ctx) -> "CIMap | None":
        if ctx.ci_keep is None:
            return None
        d = ctx.dev
        return cls(ctx.n, d["ci_keep"], d["ci_src"], d["ci_pos"])


def ci_lift(a, p):
    """Lift CI coefficients (..., L, n) to the 2n antisymmetric standard
    representative (..., L, 2n), mod the per-limb moduli p (L,)."""
    tail = a[..., 1:].flip(-1)
    neg = torch.where(tail == 0, tail, p[:, None] - tail)
    zeros = a.new_zeros(a.shape[:-1] + (1,))
    return torch.cat([a, zeros, neg], dim=-1)


def ci_ntt(a, t4: dict, p, ci: CIMap):
    """CI forward transform of (..., L, n): lift, 2n NTT, keep n."""
    return ntt4(ci_lift(a, p), t4, p)[..., ci.keep]


def ci_intt(v, t4: dict, ninv, p, ci: CIMap):
    """CI inverse transform of (..., L, n): gather 2n, 2n iNTT, first n."""
    return intt4(v[..., ci.src], t4, ninv, p)[..., : ci.n]
