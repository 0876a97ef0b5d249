"""BSGS geometry of homomorphic linear transforms.

Counterpart of `orion_tpu/crypto/lintrans.py` (`choose_n1`).  A transform
is a dict of generalised diagonals {idx: vec}; with idx = g*n1 + b the
matvec is  out = sum_g rot( sum_b pt[g,b] * rot(ct, b), g*n1 ),  costing
~(n1 + #giants) key-switches instead of #diags.  The evaluation itself is
`lintrans_scan.py`.
"""

from __future__ import annotations

import math


def choose_n1(num_diags: int, slots: int, bsgs_ratio: float = 2.0) -> int:
    """Baby-step count: power of two near sqrt(#diags * ratio)."""
    if num_diags <= 1:
        return 1
    target = math.sqrt(num_diags * max(bsgs_ratio, 0.25))
    n1 = 1 << max(0, round(math.log2(target)))
    return int(min(max(n1, 1), slots))
