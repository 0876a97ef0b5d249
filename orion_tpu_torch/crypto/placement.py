"""Buffer placement: which device the port runs on, and where compiled
buffers live.

Counterpart of `orion_tpu/crypto/placement.py`.  Every buffer is built as
an int64 tensor on the scheme's device; with `io_mode: stream` the
scheme spills each module's buffers to pinned host memory after it
compiles and brings them back around its forward (`runtime/buffers.py`),
where orion_tpu builds them in host memory from the start.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """`cuda` by default; a request for CUDA without a CUDA device raises.

    The port's entry points (`init_scheme`, `CKKSContext`) run on the GPU
    unless the caller asks for `device="cpu"`, the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def buffer(x, device) -> torch.Tensor:
    """Large-buffer materialisation: host integers -> int64 on `device`."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x, np.int64)),
                           device=device)
