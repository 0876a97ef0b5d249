"""Linear transform modules: LinearTransform and Linear.

Counterpart of `orion_tpu/nn/linear.py` (`Conv2d` is a later slice).  The
cleartext forward is a torch matmul; the FHE forward evaluates compiled
BSGS diagonal transforms through the scheme's lt_evaluator, then applies
the hybrid embedding's output rotations (out += out.roll(slots/2^i)) and
adds the encoded bias.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .module import Module, timer, to_tensor


def _kaiming_uniform(rng, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


# orion_tpu draws initial weights from one module-level generator with this
# seed; the port does the same, so a fresh process that builds the same
# network in the same order gets the same weights in both packages
_WEIGHT_RNG = np.random.default_rng(2024)


class LinearTransform(Module):
    def __init__(self, bsgs_ratio=2, level=None):
        super().__init__()
        self.bsgs_ratio = float(bsgs_ratio)
        self.set_depth(1)
        self.set_level(level)
        self.diagonals = {}          # {(row, col): {idx: vec}}
        self.compiled = {}           # {(row, col): ScanTransform}
        self.output_rotations = 0
        self.on_bias_ptxt = None

    def init_orion_params(self):
        """Clone weights as float32 numpy so fusing never mutates the
        trained network."""
        self.on_weight = self.weight.detach().cpu().numpy().copy()
        self.on_bias = (self.bias.detach().cpu().numpy().copy()
                        if self.bias is not None
                        else np.zeros(self.weight.shape[0], np.float32))

    @timer
    def evaluate_transforms(self, x):
        out = self.scheme.lt_evaluator.evaluate_transforms(self, x)
        slots = self.scheme.params.slots
        for i in range(1, self.output_rotations + 1):
            out = out + out.roll(slots // (2 ** i))
        return out + self.on_bias_ptxt


class Linear(LinearTransform):
    def __init__(self, in_features, out_features, bias=True, bsgs_ratio=2,
                 level=None):
        super().__init__(bsgs_ratio, level)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = torch.nn.Parameter(torch.from_numpy(_kaiming_uniform(
            _WEIGHT_RNG, (out_features, in_features), in_features)))
        if bias:
            self.bias = torch.nn.Parameter(torch.from_numpy(_kaiming_uniform(
                _WEIGHT_RNG, (out_features,), in_features)))
        else:
            self.register_parameter("bias", None)

    def compute_fhe_output_gap(self, **kwargs):
        return 1  # linear layers reset the multiplexed gap

    def compute_fhe_output_shape(self, **kwargs):
        return kwargs["clear_output_shape"]

    def generate_diagonals(self, last):
        from ..compiler import packing
        self.diagonals, self.output_rotations = packing.pack_linear(self, last)

    def compile(self):
        from ..compiler import packing
        bias = packing.construct_linear_bias(self)
        self.on_bias_ptxt = self.scheme.encoder.encode(
            bias, level=self.level - self.depth)
        self.scheme.lt_evaluator.generate_transforms(self)

    def forward(self, x):
        if not self.he_mode:
            x = to_tensor(x)
            if x.dim() != 2:
                extra = (" Forgot to call on.Flatten() first?"
                         if x.dim() == 4 else "")
                raise ValueError(
                    f"Expected 2D input (N, in_features) to "
                    f"{type(self).__name__}, got {tuple(x.shape)}." + extra)
            with torch.no_grad():
                return torch.nn.functional.linear(x, self.weight, self.bias)
        return self.evaluate_transforms(x)
