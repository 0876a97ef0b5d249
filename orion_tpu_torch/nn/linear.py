"""Linear transform modules: LinearTransform, Linear and Conv2d.

Counterpart of `orion_tpu/nn/linear.py`.  The cleartext forward is a torch
matmul or `conv2d`; the FHE forward evaluates compiled BSGS diagonal
transforms through the scheme's lt_evaluator, then applies the hybrid
embedding's output rotations (out += out.roll(slots/2^i)) and adds the
encoded bias.
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

    def _try_load_diagonals(self) -> bool:
        """io_mode load: the packed diagonals from the archive."""
        p = self.scheme.params
        if p.io_mode != "load" or not p.diags_path:
            return False
        from ..runtime.io import load_layer_diagonals
        return load_layer_diagonals(p, self, p.diags_path)

    def _maybe_save_diagonals(self):
        p = self.scheme.params
        if p.io_mode == "save" and p.diags_path:
            from ..runtime.io import save_layer_diagonals
            save_layer_diagonals(p, self, p.diags_path)

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
        if self._try_load_diagonals():
            return
        self.diagonals, self.output_rotations = packing.pack_linear(self, last)
        self._maybe_save_diagonals()

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


class Conv2d(LinearTransform):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, bsgs_ratio=2,
                 level=None):
        super().__init__(bsgs_ratio, level)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = self._pair(kernel_size)
        self.stride = self._pair(stride)
        self.padding = self._pair(padding)
        self.dilation = self._pair(dilation)
        self.groups = groups
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        self.weight = torch.nn.Parameter(torch.from_numpy(_kaiming_uniform(
            _WEIGHT_RNG,
            (out_channels, in_channels // groups, *self.kernel_size),
            fan_in)))
        if bias:
            self.bias = torch.nn.Parameter(torch.from_numpy(_kaiming_uniform(
                _WEIGHT_RNG, (out_channels,), fan_in)))
        else:
            self.register_parameter("bias", None)

    @staticmethod
    def _pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    def compute_fhe_output_gap(self, **kwargs):
        # strided convs increase the multiplexed gap by the stride
        return kwargs["input_gap"] * self.stride[0]

    def compute_fhe_output_shape(self, **kwargs):
        Hi, Wi = kwargs["input_shape"][2:]
        N, Co, Ho, Wo = kwargs["clear_output_shape"]
        og = self.compute_fhe_output_gap(input_gap=kwargs["input_gap"])
        return (N, math.ceil(Co / (og ** 2)), max(Hi, Ho * og),
                max(Wi, Wo * og))

    def generate_diagonals(self, last):
        from ..compiler import packing
        if self._try_load_diagonals():
            return
        self.diagonals, self.output_rotations = packing.pack_conv2d(self, last)
        self._maybe_save_diagonals()

    def compile(self):
        from ..compiler import packing
        bias = packing.construct_conv2d_bias(self)
        self.on_bias_ptxt = self.scheme.encoder.encode(
            bias, level=self.level - self.depth)
        self.scheme.lt_evaluator.generate_transforms(self)

    def forward(self, x):
        if not self.he_mode:
            x = to_tensor(x)
            if x.dim() != 4:
                raise ValueError(
                    f"Expected 4D input (N, C, H, W) to "
                    f"{type(self).__name__}, got {tuple(x.shape)}.")
            with torch.no_grad():
                return torch.nn.functional.conv2d(
                    x, self.weight, self.bias, stride=self.stride,
                    padding=self.padding, dilation=self.dilation,
                    groups=self.groups)
        return self.evaluate_transforms(x)
