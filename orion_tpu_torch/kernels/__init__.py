"""The port's hand-written CUDA kernels (sources in `csrc/`), their
build (`_build.py`) and their wrappers (`ntt.py`, `keyswitch.py`,
`rescale.py`).

Every wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain PyTorch version on a CPU tensor.  `KERNELS` lists them with
their launch and item counts (in all, and per level for the key-switch
kernels); the `*_ci` entries are the same C entry points run with the
ConjugateInvariant ring's map, counted apart (the transforms and rescale
epilogues as the same kernels' CI instantiations, the key-switch kernels
as cluster kernels of their own).  `SHARDED` are the
key-switch kernels' launches apart on one rank's rows, which only a
limb-sharded key-switch (`parallel/limbshard.py`) runs.
"""

from .keyswitch import (KS_CONVERT_ROWS, KS_DECOMPOSE, KS_DECOMPOSE_CI,
                        KS_FINISH, KS_FINISH_CI, KS_INNER_ROWS,
                        KS_MODDOWN_ROWS)
from .ntt import NTT_FWD, NTT_FWD_CI, NTT_INV, NTT_INV_CI
from .rescale import (DROP_INTT, DROP_INTT_CI, DROP_NTT, RESCALE_NTT,
                      RESCALE_NTT_CI)

SHARDED = (KS_CONVERT_ROWS, KS_INNER_ROWS, KS_MODDOWN_ROWS)
KERNELS = (NTT_FWD, NTT_INV, KS_DECOMPOSE, KS_FINISH, DROP_INTT, DROP_NTT,
           RESCALE_NTT, NTT_FWD_CI, NTT_INV_CI, KS_DECOMPOSE_CI,
           KS_FINISH_CI, DROP_INTT_CI, RESCALE_NTT_CI) + SHARDED


def reset_launches() -> None:
    for k in KERNELS:
        k.reset()


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def launch_counts_by_level() -> dict[str, dict[int, int]]:
    """Launches per ciphertext level of the kernels whose wrappers know it
    (the key-switch kernels and the rescale epilogues)."""
    return _by_level(lambda items, n: n)


def item_counts() -> dict[str, int]:
    """Items per kernel: key-switches for the key-switch kernels, so
    items / launches is how full a launch was."""
    return {k.name: k.items for k in KERNELS}


def item_counts_by_level() -> dict[str, dict[int, int]]:
    return _by_level(lambda items, n: items * n)


def batch_sizes() -> dict[str, dict[int, dict[int, int]]]:
    """{kernel: {level: {items per launch: launches}}} of the key-switch
    kernels and the rescale epilogues."""
    out: dict = {}
    for k in KERNELS:
        for (level, items), n in sorted(k.batches.items()):
            out.setdefault(k.name, {}).setdefault(level, {})[items] = n
    return out


def _by_level(count) -> dict[str, dict[int, int]]:
    out: dict = {}
    for name, levels in batch_sizes().items():
        out[name] = {level: sum(count(i, n) for i, n in sizes.items())
                     for level, sizes in levels.items()}
    return out
