"""Module fusion.

Counterpart of `orion_tpu/compiler/fuser.py`: three patterns, each
operating on the cloned `on_weight` / `on_bias` parameters so the trained
network is untouched:

  1. Linear/Conv -> BatchNorm: fold BN statistics and affine into the
     linear transform's weights and bias; BN becomes the identity (depth 0).
  2. Linear/Conv -> Chebyshev: fold the activation's [-1,1] prescale and
     shift into the preceding linear layer (saves the affine level).
  3. BatchNorm -> Chebyshev: the same fold when BN precedes the activation.
"""

from __future__ import annotations

import numpy as np

from ..nn.linear import LinearTransform
from ..nn.normalization import BatchNormNd
from ..nn.activation import Chebyshev


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
        """Three passes in orion_tpu's order: the activation affine first
        folds into BN, then BN folds into the linear layer, so a
        Linear->BN->Chebyshev chain lands entirely in the linear weights."""
        patterns = [
            (LinearTransform, Chebyshev, self._fuse_linear_cheb),
            (BatchNormNd, Chebyshev, self._fuse_bn_cheb),
            (LinearTransform, BatchNormNd, self._fuse_linear_bn),
        ]
        order = list(self.dag.topological_sort())
        for parent_t, child_t, fn in patterns:
            for name in order:
                module = self.dag.nodes[name]["module"]
                if not isinstance(module, parent_t) or \
                        getattr(module, "fused", False):
                    continue
                child_name = self._single_parent_child(name)
                if child_name is None:
                    continue
                child = self.dag.nodes[child_name]["module"]
                if isinstance(child, child_t) and not child.fused:
                    fn(module, child)

    # -------------------------------------------------- #

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

    def _fuse_linear_cheb(self, lin, cheb):
        if cheb.prescale == 1 and cheb.constant == 0:
            return
        w = lin.on_weight.astype(np.float64)
        lin.on_weight = (w * cheb.prescale).astype(np.float32)
        lin.on_bias = (lin.on_bias.astype(np.float64) * cheb.prescale
                       + cheb.constant).astype(np.float32)
        cheb.fused = True
        cheb.depth = int(np.ceil(np.log2(cheb.degree + 1)))

    def _fuse_bn_cheb(self, bn, cheb):
        if cheb.prescale == 1 and cheb.constant == 0:
            return
        # fold the activation's affine into BN's scale/shift
        bn.on_running_var = bn.on_running_var / (cheb.prescale ** 2)
        if bn.affine:
            bn.on_bias = (bn.on_bias * cheb.prescale + cheb.constant
                          ).astype(np.float32)
        else:
            raise NotImplementedError(
                "BN->Chebyshev fusion requires affine BatchNorm")
        cheb.fused = True
        cheb.depth = int(np.ceil(np.log2(cheb.degree + 1)))
