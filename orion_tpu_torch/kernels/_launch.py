"""One hand-written CUDA kernel: its C entry point, its checks, its count.

A `Kernel` binds a C function of a library built by `_build.py` through
ctypes.  `launch` passes tensors as device pointers, integers as C ints,
appends PyTorch's current stream, raises if the function returns a CUDA
error, and adds one to `launches`, the launch's `items` (the
key-switches, or rows, it computed) to `items` and the device kernels
(grids) the C function launched to `grids`, which a profile of the card
can be held against.  When the caller names
the ciphertext level, it also counts the launch under (level, items) in
`batches`: launches say how often the path went to the card, items how
full each launch was.  Nothing else changes the counts, so a run that
sets them to 0 before the main path and reads them after shows which
kernels the path went through, at which levels and in which batches.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import _build


class Kernel:
    def __init__(self, name: str, source: str, symbol: str, signature: str,
                 replaces: str):
        self.name = name
        self.source = source          # file under kernels/csrc/
        self.symbol = symbol          # C entry point
        self.signature = signature    # one letter per argument: p / i
        self.replaces = replaces      # the Pallas function(s) it ports
        self.launches = 0
        self.items = 0
        self.grids = 0
        self.batches: Counter = Counter()   # (level, items) -> launches
        self._fn = None

    def reset(self) -> None:
        self.launches = self.items = self.grids = 0
        self.batches.clear()

    def _bind(self):
        if self._fn is None:
            fn = getattr(_build.load(self.source), self.symbol)
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
            fn.argtypes = [kinds[c] for c in self.signature] + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args, level=None, items=1,
               grids=1) -> None:
        fn = self._bind()
        if len(args) != len(self.signature):
            raise TypeError(f"{self.name}: {len(args)} arguments, "
                            f"expected {len(self.signature)}")
        conv = []
        for kind, a in zip(self.signature, args):
            if kind == "p":
                if a is None:
                    conv.append(None)
                    continue
                if a.device != device or not a.is_contiguous():
                    raise ValueError(
                        f"{self.name}: every tensor argument must be a "
                        f"contiguous tensor on {device}")
                conv.append(a.data_ptr())
            else:
                conv.append(int(a))
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*conv, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1
        self.items += items
        self.grids += grids
        if level is not None:
            self.batches[(level, items)] += 1


def check_residues(name: str, x: torch.Tensor, shape: tuple) -> None:
    """The checks every wrapper makes before it launches its kernel."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"{name}: residues must be int64, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
