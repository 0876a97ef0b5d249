"""Polynomial activations.

Counterpart of `orion_tpu/nn/activation.py`; this slice ports `Quad`
(x^2 with the scale fix).  The Chebyshev family, `_Sign` and `ReLU` are a
later slice.
"""

from __future__ import annotations

from .module import Module, timer, to_tensor


class Quad(Module):
    """x^2; under FHE the output keeps the input's scale."""

    def __init__(self):
        super().__init__()
        self.set_depth(1)

    @timer
    def forward(self, x):
        if not self.he_mode:
            x = to_tensor(x)
            return x * x
        out = x * x
        out.set_scale(x.scale())
        return out
