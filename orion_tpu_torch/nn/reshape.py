"""Reshape modules.  Counterpart of `orion_tpu/nn/reshape.py`: Flatten is
the identity under FHE because packing already flattens; Identity passes
its input through (ResNet's optional pool slot)."""

from __future__ import annotations

from .module import Module, to_tensor


class Flatten(Module):
    def __init__(self):
        super().__init__()
        self.set_depth(0)

    def forward(self, x):
        if self.he_mode:
            return x
        x = to_tensor(x)
        return x.reshape(x.shape[0], -1)


class Identity(Module):
    def __init__(self):
        super().__init__()
        self.set_depth(0)

    def forward(self, x):
        return x
