"""PlainTensor / CipherTensor: the user-facing multi-ciphertext tensors.

Counterpart of `orion_tpu/runtime/tensors.py`: a tensor larger than the
slot count is a list of ciphertexts; operators map elementwise over the
list and dispatch on operand type; `roll` rotates every ciphertext;
`bootstrap()` picks the sparse slot count from the FHE shape.  Metadata (clear shape, FHE/multiplexed shape) lives on the tensor.
"""

from __future__ import annotations

import math

import numpy as np

from ..crypto.ciphertext import Ciphertext


class PlainTensor:
    def __init__(self, scheme, plaintexts: list, shape, on_shape=None):
        self.scheme = scheme
        self.plaintexts = plaintexts  # list[crypto.Plaintext]
        self.shape = tuple(shape)
        self.on_shape = tuple(on_shape) if on_shape is not None else tuple(shape)

    def __len__(self):
        return len(self.plaintexts)

    def decode(self):
        return self.scheme.encoder.decode(self)

    @property
    def level(self):
        return self.plaintexts[0].level

    @property
    def scale(self):
        return self.plaintexts[0].scale


class CipherTensor:
    def __init__(self, scheme, cts: list[Ciphertext], shape, on_shape=None):
        self.scheme = scheme
        self.cts = list(cts)
        self.shape = tuple(shape)
        self.on_shape = tuple(on_shape) if on_shape is not None else tuple(shape)

    # ----------------- helpers ----------------- #

    def __len__(self):
        return len(self.cts)

    def _ev(self):
        return self.scheme.evaluator

    def _like(self, cts):
        return CipherTensor(self.scheme, cts, self.shape, self.on_shape)

    def level(self):
        return min(ct.level for ct in self.cts)

    def scale(self):
        return self.cts[0].scale

    def set_scale(self, scale):
        self.cts = [self._ev().set_scale(ct, scale) for ct in self.cts]
        return self

    def min(self):
        return float(np.min(self.decrypt().decode()))

    def max(self):
        return float(np.max(self.decrypt().decode()))

    # ----------------- arithmetic ----------------- #

    def _zip_pt(self, other: PlainTensor):
        if len(other) != len(self):
            raise ValueError(
                f"ciphertext count {len(self)} != plaintext count "
                f"{len(other)}")
        return zip(self.cts, other.plaintexts)

    def __add__(self, other):
        ev = self._ev()
        if isinstance(other, CipherTensor):
            return self._like([ev.add(a, b)
                               for a, b in zip(self.cts, other.cts)])
        if isinstance(other, PlainTensor):
            return self._like([ev.add_plain(a, p)
                               for a, p in self._zip_pt(other)])
        return self._like([ev.add_scalar(ct, float(other))
                           for ct in self.cts])

    __radd__ = __add__

    def __sub__(self, other):
        ev = self._ev()
        if isinstance(other, CipherTensor):
            return self._like([ev.sub(a, b)
                               for a, b in zip(self.cts, other.cts)])
        if isinstance(other, PlainTensor):
            return self._like([ev.sub_plain(a, p)
                               for a, p in self._zip_pt(other)])
        return self._like([ev.sub_scalar(ct, float(other))
                           for ct in self.cts])

    def __mul__(self, other):
        ev = self._ev()
        if isinstance(other, CipherTensor):
            return self._like([ev.mul_relin(a, b)
                               for a, b in zip(self.cts, other.cts)])
        if isinstance(other, PlainTensor):
            return self._like([ev.mul_plain(a, p)
                               for a, p in self._zip_pt(other)])
        return self._like([ev.mul_scalar(ct, other) for ct in self.cts])

    __rmul__ = __mul__

    def __neg__(self):
        return self._like([self._ev().negate(ct) for ct in self.cts])

    def roll(self, amount: int):
        """Rotate slots left by `amount` within each ciphertext."""
        return self._like([self._ev().rotate(ct, amount) for ct in self.cts])

    def mod_drop(self, level: int):
        return self._like([self._ev().mod_drop(ct, level) for ct in self.cts])

    def decrypt(self) -> PlainTensor:
        return self.scheme.encryptor.decrypt(self)

    def bootstrap(self):
        numel = int(np.prod(self.on_shape[1:])) if len(self.on_shape) > 1 \
            else int(np.prod(self.on_shape))
        slots = 2 ** math.ceil(math.log2(max(numel, 1)))
        return self._like([
            self.scheme.bootstrapper.bootstrap(ct, slots) for ct in self.cts])
