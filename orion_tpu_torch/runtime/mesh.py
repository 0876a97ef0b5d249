"""Sharded execution of compiled encrypted networks over a mesh of ranks.

Counterpart of `orion_tpu/runtime/mesh.py`.  A compiled network (the
output of the real fit -> compile pipeline) runs over a (dp, limb) mesh
(`parallel.mesh.Mesh`, `parallel.multihost.make_dcn_mesh`):

  * ``dp``   - the batch of encrypted queries: each dp row runs its share
               through `runtime.jit.make_batched_forward` (the queries
               stacked on a leading axis, one forward), and the outputs are
               all-gathered over dp, so every rank returns the whole batch;
  * ``limb`` - the RNS rows of every key-switch.  orion_tpu annotates the
               ciphertexts' limb axis and lets XLA's SPMD partitioner
               shard the program, every compiled buffer replicated.  The
               port has no partitioner: while the forward runs, the limb
               group is set on the key-switch seam
               (`crypto.keyswitch.set_limb_group`), so each rank switches
               its block of extended rows (`parallel/limbshard.py`) and the
               Q rows are all-gathered back; keys, diagonals and every
               other step stay replicated within the group.

Integer arithmetic is the same in every rank, so the sharded outputs equal
the unsharded forward's bit for bit.  Every rank calls `run` with the same
batch, SPMD style.

Usage (also `parallel.mesh.dryrun_model_mesh`)::

    init_multihost(("localhost", port), world, rank)
    mesh = make_dcn_mesh(limb=2)
    fwd = make_sharded_forward(net, scheme, mesh)       # after compile()
    outs = fwd(batch_of_ciphertensors)                  # len == B
"""

from __future__ import annotations

import torch

from ..crypto.keyswitch import set_limb_group
from ..parallel.limbshard import LimbGroup, all_gather
from .jit import make_batched_forward
from .tensors import CipherTensor


def make_sharded_forward(net, scheme, mesh, dp_axis: str = "dp",
                         limb_axis: str | None = "limb"):
    """Returns ``run(batch: list[CipherTensor]) -> list[CipherTensor]``.

    The batch (its length a multiple of the dp size) is split over
    `dp_axis`; with `limb_axis` in the mesh and of size > 1 every
    key-switch is limb-sharded over it (pass None, or a mesh without the
    axis, to replicate the limbs).  Every query must share the levels,
    scales and shape of the first (a served model's input level)."""
    if dp_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {dp_axis!r}: {mesh.axis_names}")
    if limb_axis is not None and limb_axis not in mesh.axis_names:
        limb_axis = None
    dp, row = mesh.size(dp_axis), mesh.index(dp_axis)
    dp_group = mesh.group(dp_axis)
    limb = (LimbGroup(mesh.group(limb_axis))
            if limb_axis is not None and mesh.size(limb_axis) > 1 else None)
    forward = make_batched_forward(net, scheme)

    def run(batch):
        if isinstance(batch, CipherTensor):
            batch = [batch]
        if not batch or len(batch) % dp:
            raise ValueError(f"a batch of {len(batch)} queries over "
                             f"dp = {dp}")
        per = len(batch) // dp
        prev = set_limb_group(limb)
        try:
            outs = forward(batch[row * per:(row + 1) * per])
        finally:
            set_limb_group(prev)
        if dp == 1:
            return outs
        t0 = outs[0]
        gathered = [all_gather(torch.stack([o.cts[i].data for o in outs]),
                               dp_group).flatten(0, 1)
                    for i in range(len(t0.cts))]
        return [CipherTensor(scheme, [ct.with_(data=g[b])
                                      for ct, g in zip(t0.cts, gathered)],
                             t0.shape, t0.on_shape)
                for b in range(len(batch))]

    return run


def encrypt_batch(scheme, inputs, level=None):
    """Encode + encrypt a batch of queries -> list[CipherTensor]."""
    return [scheme.encrypt(scheme.encode(x, level)) for x in inputs]
