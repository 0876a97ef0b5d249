"""BatchNorm modules.

Counterpart of `orion_tpu/nn/normalization.py` (`BatchNorm1d`).  Running
statistics are buffers and the affine weight/bias are parameters.  Under
FHE the normalisation constants are encoded so every rescale is errorless:
mean and inverse-std at level l with scale q_l, affine weight/bias one
level lower at scale q_(l-1).  When fused into a preceding linear layer
the module becomes the identity.
"""

from __future__ import annotations

import numpy as np
import torch

from .module import Module, timer, to_tensor


class BatchNormNd(Module):
    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.set_depth(2 if affine else 1)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(num_features))
            self.bias = torch.nn.Parameter(torch.zeros(num_features))

    # ----------------- orion params / packing ----------------- #

    def init_orion_params(self):
        def host(t):
            return t.detach().cpu().numpy().astype(np.float32).copy()
        self.on_running_mean = host(self.running_mean)
        self.on_running_var = host(self.running_var)
        if self.affine:
            self.on_weight = host(self.weight)
            self.on_bias = host(self.bias)

    def compile(self):
        if self.fused:
            return
        mean, inv_std, weight, bias = self.pack()
        chain = self.scheme.encoder.get_moduli_chain()
        ql = float(chain[self.level])
        self.mean_ptxt = self.scheme.encoder.encode(
            mean, level=self.level, scale=None)
        self.inv_std_ptxt = self.scheme.encoder.encode(
            inv_std, level=self.level, scale=ql)
        if self.affine:
            ql1 = float(chain[self.level - 1])
            self.weight_ptxt = self.scheme.encoder.encode(
                weight, level=self.level - 1, scale=ql1)
            self.bias_ptxt = self.scheme.encoder.encode(
                bias, level=self.level - 2)

    def pack(self):
        raise NotImplementedError

    # ----------------- forward ----------------- #

    def _clear_forward(self, x):
        shape = [1, self.num_features] + [1] * (x.dim() - 2)
        out = ((x - self.running_mean.reshape(shape))
               / torch.sqrt(self.running_var.reshape(shape) + self.eps))
        if self.affine:
            out = out * self.weight.reshape(shape) + self.bias.reshape(shape)
        return out

    @timer
    def forward(self, x):
        if not self.he_mode:
            if self.training:
                raise RuntimeError(
                    "BatchNorm statistics are collected with the training "
                    "utilities; fit/inference require eval() mode")
            with torch.no_grad():
                return self._clear_forward(to_tensor(x))
        if self.fused:
            return x
        out = x - self.mean_ptxt
        out = out * self.inv_std_ptxt
        if self.affine:
            out = out * self.weight_ptxt
            out = out + self.bias_ptxt
        return out


class BatchNorm1d(BatchNormNd):
    def forward(self, x):
        if not self.he_mode and to_tensor(x).dim() != 2:
            raise ValueError(
                f"BatchNorm1d expects (N, C), got {tuple(x.shape)}")
        return super().forward(x)

    def pack(self):
        from ..compiler import packing
        return packing.pack_bn1d(self)
