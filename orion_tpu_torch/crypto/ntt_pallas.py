"""Per-row NTTs over chosen limbs of the context's chain.

Counterpart of `orion_tpu/crypto/ntt_pallas.py` `PallasNTT`, with its
interface: `PallasNTT(ctx)`, `.ntt(a, limb_rows)` and `.intt(a, limb_rows)`
transform the last axis of (..., L, N) residues whose L limbs are the
chain's prime rows `limb_rows`.  It computes the same function as
orion_tpu's `crypto/ntt.py` `ntt` / `intt`.  On a CUDA tensor it launches
the `ntt_fwd` / `ntt_inv` kernels (`kernels/csrc/ntt.cu`), on a CPU tensor
it runs their plain versions.
"""

from __future__ import annotations

from ..kernels.ntt import ntt_fwd, ntt_inv
from .keyswitch import RingRows


class PallasNTT:
    def __init__(self, ctx):
        self.ctx = ctx
        self._tables: dict[tuple, RingRows] = {}

    def _rows(self, limb_rows) -> RingRows:
        key = tuple(int(r) for r in limb_rows)
        if key not in self._tables:
            self._tables[key] = RingRows.from_ctx(self.ctx, key)
        return self._tables[key]

    def ntt(self, a, limb_rows):
        """Forward negacyclic NTT (standard -> bit-reversed order)."""
        return ntt_fwd(a.contiguous(), self._rows(limb_rows))

    def intt(self, a, limb_rows):
        """Inverse negacyclic NTT (bit-reversed -> standard, times n^-1)."""
        return ntt_inv(a.contiguous(), self._rows(limb_rows))
