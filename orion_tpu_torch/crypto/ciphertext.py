"""Ciphertext / plaintext containers.

Counterpart of `orion_tpu/crypto/ciphertext.py`.  A ciphertext is an int64
tensor (2, level+1, N) in the NTT domain on the scheme's device, with its
level and scale as plain metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class Ciphertext:
    """One RNS-CKKS ciphertext in NTT (evaluation) domain.

    data: int64[2, level+1, N]  (c0, c1 stacked)
    """
    data: torch.Tensor
    level: int = 0
    scale: float = 1.0

    @property
    def c0(self):
        return self.data[0]

    @property
    def c1(self):
        return self.data[1]

    def with_(self, **kw) -> "Ciphertext":
        return replace(self, **kw)


@dataclass(frozen=True)
class Plaintext:
    """Encoded plaintext in NTT domain, with optional Shoup companion.

    data: int64[level+1, N]; shoup: same shape (present iff the plaintext
    will be used as a multiplicand).
    """
    data: torch.Tensor
    shoup: torch.Tensor | None = None
    level: int = 0
    scale: float = 1.0

    def with_(self, **kw) -> "Plaintext":
        return replace(self, **kw)
