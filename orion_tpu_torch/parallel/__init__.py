"""The parallel layer on torch.distributed: meshes of ranks
(`mesh.py`, `multihost.py`) and limb-sharded key-switching
(`limbshard.py`).  Counterpart of `orion_tpu/parallel/`."""

from .mesh import build_mesh, dryrun_multichip, encrypted_dp_mp_step

__all__ = ["build_mesh", "encrypted_dp_mp_step", "dryrun_multichip"]
