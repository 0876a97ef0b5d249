"""Serving entry points: one encrypted forward, or a batch of queries run
as one forward.

Counterpart of `orion_tpu/runtime/jit.py`'s `make_jitted_forward` (:24)
and `make_batched_forward` (:58).  orion_tpu traces the `he()` forward
into XLA programs, since op-by-op dispatch on the TPU compiles every op
apart.  PyTorch runs eagerly and every kernel of the port is built once
per process, so the port needs no trace: `make_jitted_forward` runs the
forward as it is.  orion_tpu's per-module program caches
(`make_module_runner`, `PhaseRunner`, `aot_precompile_forward`,
`enable_module_jit`) have no counterpart here; on the GPU their role,
cutting the host's launch overhead, belongs to CUDA graphs.

`make_batched_forward` stacks B queries on a leading axis of every
ciphertext, (B, 2, L, N), where orion_tpu `jax.vmap`s its program over
them.  The network then runs once over the stack: the host issues one
forward's operations for all B queries, and every kernel launch covers
them (the key-switch kernels as B times the items, each key read in place
through `key_index`).  Modular arithmetic is exact, so each query's output
ciphertexts equal its own forward's bit for bit.
"""

from __future__ import annotations

import torch

from ..crypto.ciphertext import Ciphertext
from .tensors import CipherTensor


def make_jitted_forward(net, scheme):
    """Returns run(ctensor) -> ctensor: the net's `he()` forward.

    Nothing is traced or compiled: the port's forward runs eagerly on the
    scheme's device (see the module docstring)."""

    def run(ctensor: CipherTensor) -> CipherTensor:
        return net(ctensor)

    return run


def make_batched_forward(net, scheme):
    """Serve a batch of encrypted queries as ONE forward.

    Returns ``run(list[CipherTensor]) -> list[CipherTensor]``.  Every
    query must have the same ciphertext count, levels and scales (for a
    served model: the compiled input level and scale), or `run` raises.
    Ciphertext i of the B queries is stacked into one `Ciphertext` with
    data (B, 2, L, N), the network runs once over the stacked tensor, and
    the outputs are split back per query."""

    def run(ctensors):
        if not ctensors:
            raise ValueError("make_batched_forward: no queries")
        t0 = ctensors[0]
        meta = [(ct.level, ct.scale) for ct in t0.cts]
        for b, t in enumerate(ctensors[1:], 1):
            if [(ct.level, ct.scale) for ct in t.cts] != meta \
                    or (t.shape, t.on_shape) != (t0.shape, t0.on_shape):
                raise ValueError(
                    f"make_batched_forward: query {b} does not share query "
                    f"0's ciphertext levels, scales and shape {meta}; every "
                    f"query must be encoded at the compiled input level")
        stacked = [Ciphertext(torch.stack([t.cts[i].data for t in ctensors]),
                              lvl, sc) for i, (lvl, sc) in enumerate(meta)]
        out = net(CipherTensor(scheme, stacked, t0.shape, t0.on_shape))
        return [CipherTensor(scheme, [ct.with_(data=ct.data[b])
                                      for ct in out.cts],
                             out.shape, out.on_shape)
                for b in range(len(ctensors))]

    return run
