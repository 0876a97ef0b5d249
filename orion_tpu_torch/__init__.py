"""orion_tpu_torch: the PyTorch/CUDA port of orion_tpu.

CKKS encrypted neural-network inference on an NVIDIA GPU: the same
PyTorch-like module API, packing compiler and level assignment as
orion_tpu, over an RNS-CKKS core whose NTTs and key-switches are
hand-written CUDA kernels (`kernels/`).  Runs on `cuda` by default;
`init_scheme(config, device="cpu")` runs the plain PyTorch path.

Public API (as orion_tpu's):
    init_scheme, delete_scheme, encode, decode, encrypt, decrypt,
    fit, compile
"""

from .runtime.scheme import scheme

init_scheme = scheme.init_scheme
delete_scheme = scheme.delete_scheme
encode = scheme.encode
decode = scheme.decode
encrypt = scheme.encrypt
decrypt = scheme.decrypt
fit = scheme.fit
compile = scheme.compile

from . import nn  # noqa: E402
from . import models  # noqa: E402

__version__ = "0.1.0"
