"""Module fusion.

Counterpart of `orion_tpu/compiler/fuser.py` for the modules of this slice:
Linear -> BatchNorm folds the BN statistics and affine into the linear
layer's cloned `on_weight` / `on_bias` (the trained network is untouched)
and the BN becomes the identity (depth 0).  The patterns that fold a
Chebyshev activation's prescale arrive with those activations.
"""

from __future__ import annotations

import numpy as np

from ..nn.linear import LinearTransform
from ..nn.normalization import BatchNormNd


class Fuser:
    def __init__(self, dag):
        self.dag = dag

    def _single_parent_child(self, name):
        succs = list(self.dag.successors(name))
        if len(succs) != 1:
            return None
        child = succs[0]
        if len(list(self.dag.predecessors(child))) != 1:
            return None
        return child

    def fuse_modules(self):
        for name in list(self.dag.topological_sort()):
            module = self.dag.nodes[name]["module"]
            if not isinstance(module, LinearTransform) or module.fused:
                continue
            child_name = self._single_parent_child(name)
            if child_name is None:
                continue
            child = self.dag.nodes[child_name]["module"]
            if isinstance(child, BatchNormNd) and not child.fused:
                self._fuse_linear_bn(module, child)

    @staticmethod
    def _bn_terms(bn):
        inv_std = 1.0 / np.sqrt(bn.on_running_var + bn.eps)
        scale = inv_std * (bn.on_weight if bn.affine else 1.0)
        shift = (bn.on_bias if bn.affine else 0.0) \
            - bn.on_running_mean * scale
        return scale.astype(np.float64), np.asarray(shift, np.float64)

    def _fuse_linear_bn(self, lin, bn):
        scale, shift = self._bn_terms(bn)
        w = lin.on_weight.astype(np.float64)
        # scale output rows/channels
        lin.on_weight = (w * scale.reshape((-1,) + (1,) * (w.ndim - 1))
                         ).astype(np.float32)
        lin.on_bias = (lin.on_bias.astype(np.float64) * scale + shift
                       ).astype(np.float32)
        bn.fused = True
        bn.set_depth(0)
