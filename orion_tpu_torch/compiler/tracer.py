"""Execution tracer + FHE statistics tracker.

Counterpart of `orion_tpu/compiler/tracer.py`: the network's own forward
runs on `TracedTensor` wrappers, every *leaf* module call becomes a DAG
node (composites are transparent), and min/max, shapes, multiplexing gaps
and FHE shapes are recorded per node.  Values are torch tensors; the
statistics are taken in numpy.

Constraints mirrored from the reference:
  * binary ops on activations must go through modules (`on.Add`, `on.Mult`)
    — reference models obey this too (`orion/models/resnet.py:26-30`);
  * equal strides, single-parent BatchNorm, consistent shapes/gaps across
    residual joins are validated during tracing (tracer.py:93-131).
"""

from __future__ import annotations

import threading

import numpy as np

from ..nn.module import to_numpy, to_tensor

_state = threading.local()


def active_tracer():
    return getattr(_state, "tracer", None)


class TracedTensor:
    """Wrapper carrying the producing node's name during tracing."""

    __slots__ = ("value", "node")

    def __init__(self, value, node):
        self.value = value
        self.node = node

    @property
    def shape(self):
        return self.value.shape

    def _scalar_op(self, other, fn):
        """Scalar arithmetic is transparent during tracing (it compiles to
        level-free scalar ops under FHE, e.g. ReLU's integer postscale);
        tensor-tensor arithmetic must go through on.Add / on.Mult."""
        if isinstance(other, (int, float, np.integer, np.floating)):
            return TracedTensor(fn(self.value, other), self.node)
        raise TypeError(
            "Tensor arithmetic on traced activations must use orion_tpu_torch.nn "
            "modules (on.Add / on.Mult), mirroring the reference model "
            "style; raw operators cannot be compiled to FHE.")

    def __mul__(self, o):
        return self._scalar_op(o, lambda v, s: v * s)

    __rmul__ = __mul__

    def __add__(self, o):
        return self._scalar_op(o, lambda v, s: v + s)

    __radd__ = __add__

    def __sub__(self, o):
        return self._scalar_op(o, lambda v, s: v - s)

    def __rsub__(self, o):
        return self._scalar_op(o, lambda v, s: s - v)


class NodeStats:
    """Per-node statistics accumulated across fit batches
    (reference StatsTracker node attributes)."""

    def __init__(self, name, module):
        self.name = name
        self.module = module
        self.parents: list[str] = []
        self.input_min = float("inf")
        self.input_max = float("-inf")
        self.output_min = float("inf")
        self.output_max = float("-inf")
        self.input_shape = None
        self.output_shape = None
        self.fhe_input_shape = None
        self.fhe_output_shape = None
        self.input_gap = 1
        self.output_gap = 1


class Tracer:
    """Runs the net on real batches, building the DAG + stats."""

    def __init__(self, net):
        self.net = net
        self.nodes: dict[str, NodeStats] = {}
        self.order: list[str] = []
        self.output_node: str | None = None
        self._names = {id(m): n for n, m in net.named_modules()}
        self._counts: dict[str, int] = {}

    # ------------------------------------------------ #

    def propagate(self, batch):
        """One cleartext forward with stats recording."""
        batch = to_tensor(batch)
        inp_node = self._get_node("_input", None)
        self._update_input_node(inp_node, batch)
        _state.tracer = self
        self._seen_this_run = set()
        try:
            out = self.net.forward(TracedTensor(batch, "_input"))
        finally:
            _state.tracer = None
        if not isinstance(out, TracedTensor):
            raise RuntimeError("network output was not produced by a module")
        self.output_node = out.node
        return out.value

    def run_leaf(self, module, args):
        name = self._names.get(id(module))
        if name is None:
            raise RuntimeError(
                f"module {type(module).__name__} is not registered under the "
                "traced network")
        node = self._get_node(name, module)
        if name in self._seen_this_run:
            raise RuntimeError(
                f"module {name} called more than once per forward; modules "
                "cannot be shared across call sites (reference constraint)")
        self._seen_this_run.add(name)

        parents = [a.node for a in args if isinstance(a, TracedTensor)]
        if not node.parents:
            node.parents = parents
        vals = [a.value if isinstance(a, TracedTensor) else a for a in args]

        self._validate(node, module, parents)
        self._update_input_stats(node, vals, parents)
        # a leaf's forward runs OUTSIDE the trace: if the leaf has internal
        # sub-modules (e.g. ReLU's mult/sign when train.build_functional
        # forces ReLU itself to be the leaf), their calls must execute
        # plainly rather than spawn nested DAG nodes
        _state.tracer = None
        try:
            result = module.forward(*vals)
        finally:
            _state.tracer = self
        self._update_output_stats(node, module, result)
        self._sync(node, module)
        return TracedTensor(result, name)

    # ------------------------------------------------ #

    def _get_node(self, name, module):
        if name not in self.nodes:
            self.nodes[name] = NodeStats(name, module)
            self.order.append(name)
        return self.nodes[name]

    def _update_input_node(self, node, batch):
        node.input_shape = tuple(batch.shape)
        node.output_shape = tuple(batch.shape)
        node.fhe_output_shape = tuple(batch.shape)
        node.output_gap = 1
        node.output_min = min(node.output_min, float(batch.min()))
        node.output_max = max(node.output_max, float(batch.max()))

    def _validate(self, node, module, parents):
        pnodes = [self.nodes[p] for p in parents]
        for attr, label in (("output_shape", "input shapes"),
                            ("fhe_output_shape", "FHE shapes"),
                            ("output_gap", "input gaps")):
            vals = {getattr(p, attr) for p in pnodes
                    if getattr(p, attr) is not None}
            if len(vals) > 1:
                raise ValueError(
                    f"Inconsistent {label} for {node.name}: {vals}")
        stride = getattr(module, "stride", None)
        if stride and len(set(stride)) > 1:
            raise ValueError(
                f"Stride for {node.name} must be equal in all directions: "
                f"{stride}")
        from ..nn.normalization import BatchNormNd
        if isinstance(module, BatchNormNd) and len(parents) > 1:
            raise ValueError(
                f"BatchNorm node {node.name} has multiple parents which "
                "prevents fusion")

    def _update_input_stats(self, node, vals, parents):
        mins, maxs = [], []
        for v in vals:
            arr = to_numpy(v)
            mins.append(float(arr.min()))
            maxs.append(float(arr.max()))
        if mins:
            node.input_min = min(node.input_min, min(mins))
            node.input_max = max(node.input_max, max(maxs))
        if parents:
            p = self.nodes[parents[0]]
            node.input_shape = p.output_shape
            node.input_gap = p.output_gap
            node.fhe_input_shape = p.fhe_output_shape

    def _update_output_stats(self, node, module, result):
        arr = to_numpy(result)
        node.output_min = min(node.output_min, float(arr.min()))
        node.output_max = max(node.output_max, float(arr.max()))
        node.output_shape = self._clear_out_shape(node, module, arr)
        node.fhe_output_shape = self._fhe_out_shape(node, module)
        node.output_gap = self._fhe_out_gap(node, module)

    def _clear_out_shape(self, node, module, arr):
        from ..nn.linear import LinearTransform
        if not node.input_shape:
            return tuple(arr.shape)
        if isinstance(module, LinearTransform):
            return tuple(arr.shape)
        return node.input_shape

    def _fhe_out_shape(self, node, module):
        from ..nn.linear import LinearTransform
        if not node.input_shape:
            return node.output_shape
        if isinstance(module, LinearTransform):
            return tuple(module.compute_fhe_output_shape(
                input_gap=node.input_gap,
                input_shape=node.input_shape,
                output_shape=node.output_shape,
                fhe_input_shape=node.fhe_input_shape,
                output_gap=node.output_gap,
                clear_output_shape=node.output_shape,
            ))
        return node.fhe_input_shape

    def _fhe_out_gap(self, node, module):
        from ..nn.linear import LinearTransform
        if isinstance(module, LinearTransform):
            return module.compute_fhe_output_gap(
                input_gap=node.input_gap,
                input_shape=node.input_shape,
                output_shape=node.output_shape,
            )
        return node.input_gap

    def _sync(self, node, module):
        module.name = node.name
        for attr in ("input_min", "input_max", "output_min", "output_max",
                     "input_shape", "output_shape", "fhe_input_shape",
                     "fhe_output_shape", "input_gap", "output_gap"):
            setattr(module, attr, getattr(node, attr))

    def update_batch_size(self, batch_size):
        """Rewrite the batch dim after fitting with a larger stats batch
        (reference StatsTracker.update_batch_size)."""
        for node in self.nodes.values():
            if node.module is None:
                continue
            for attr in ("input_shape", "output_shape",
                         "fhe_input_shape", "fhe_output_shape"):
                cur = getattr(node.module, attr, None)
                if cur:
                    new = (batch_size,) + tuple(cur[1:])
                    setattr(node.module, attr, new)
                    setattr(node, attr, new)
