"""Pooling modules.

Counterpart of `orion_tpu/nn/pooling.py`: AvgPool2d is a grouped Conv2d
with a constant 1/(kH*kW) kernel whose channel count is resolved after
tracing (`update_params`); AdaptiveAvgPool2d derives kernel and stride
from the observed input shape and keeps its input's multiplexed gap.
"""

from __future__ import annotations

import numpy as np
import torch

from .linear import Conv2d
from .module import to_tensor


class AvgPool2d(Conv2d):
    def __init__(self, kernel_size, stride=None, padding=0, bsgs_ratio=2,
                 level=None):
        stride = stride if stride is not None else kernel_size
        # channel count unknown until tracing; start with 1 channel
        super().__init__(1, 1, kernel_size, stride=stride, padding=padding,
                         groups=1, bias=False, bsgs_ratio=bsgs_ratio,
                         level=level)
        self.resolved = False

    def update_params(self):
        """Resolve channels from the traced input shape."""
        if self.resolved or self.input_shape is None:
            return
        channels = self.input_shape[1]
        self.in_channels = channels
        self.out_channels = channels
        self.groups = channels
        kh, kw = self.kernel_size
        w = np.full((channels, 1, kh, kw), 1.0 / (kh * kw), dtype=np.float32)
        self.weight = torch.nn.Parameter(torch.from_numpy(w))
        self.register_parameter("bias", None)
        self.resolved = True
        self.init_orion_params()

    def forward(self, x):
        if not self.he_mode:
            x = to_tensor(x)
            kh, kw = self.kernel_size
            c = x.shape[1]
            w = torch.full((c, 1, kh, kw), 1.0 / (kh * kw), dtype=x.dtype)
            with torch.no_grad():
                return torch.nn.functional.conv2d(
                    x, w, stride=self.stride, padding=self.padding, groups=c)
        return self.evaluate_transforms(x)


class AdaptiveAvgPool2d(AvgPool2d):
    def __init__(self, output_size, bsgs_ratio=2, level=None):
        if isinstance(output_size, int):
            output_size = (output_size, output_size)
        super().__init__(kernel_size=1, stride=1, bsgs_ratio=bsgs_ratio,
                         level=level)
        self.output_size = output_size

    def update_params(self):
        if self.resolved or self.input_shape is None:
            return
        Hi, Wi = self.input_shape[2:]
        Ho, Wo = self.output_size
        stride = (Hi // Ho, Wi // Wo)
        kernel = (Hi - (Ho - 1) * stride[0], Wi - (Wo - 1) * stride[1])
        if stride[0] != stride[1] or kernel[0] != kernel[1]:
            raise ValueError(
                "AdaptiveAvgPool2d requires square stride/kernel under FHE")
        self.kernel_size = kernel
        self.stride = stride
        super().update_params()

    def compute_fhe_output_gap(self, **kwargs):
        # adaptive pooling keeps the multiplexed layout of its input
        return kwargs["input_gap"] * self.stride[0]

    def forward(self, x):
        if not self.he_mode:
            # adaptive mean over equal blocks (kernel resolved at compile)
            x = to_tensor(x)
            n, c, h, w = x.shape
            ho, wo = self.output_size
            return x.reshape(n, c, ho, h // ho, wo, w // wo).mean(
                dim=(3, 5))
        return self.evaluate_transforms(x)
