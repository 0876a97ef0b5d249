"""The port's hand-written CUDA kernels (sources in `csrc/`), their
build (`_build.py`) and their wrappers (`ntt.py`, `keyswitch.py`).

Every wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain PyTorch version on a CPU tensor.  `KERNELS` lists them with
their launch counts.
"""

from .keyswitch import KS_DECOMPOSE, KS_FINISH
from .ntt import NTT_FWD, NTT_INV

KERNELS = (NTT_FWD, NTT_INV, KS_DECOMPOSE, KS_FINISH)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
