"""Elementwise modules: Add, Mult, Bootstrap.

Counterpart of `orion_tpu/nn/operations.py`.  Bootstrap implements the
shift-scale-bootstrap-unscale-unshift recipe with the prescale encoded at
the level just above the modulus floor and scale q_l (errorless rescale,
zeroed unused slots for sparse bootstrapping).  The port runs eagerly, so
orion_tpu's program-sharing signature has no counterpart.
"""

from __future__ import annotations

import math

import numpy as np

from .module import Module, timer, to_tensor


def _clear(x):
    return x if isinstance(x, (int, float)) else to_tensor(x)


class Add(Module):
    def __init__(self):
        super().__init__()
        self.set_depth(0)

    def forward(self, x, y):
        if self.he_mode:
            return x + y
        return _clear(x) + _clear(y)


class Mult(Module):
    def __init__(self):
        super().__init__()
        self.set_depth(1)

    def forward(self, x, y):
        if self.he_mode:
            return x * y
        return _clear(x) * _clear(y)


class Bootstrap(Module):
    """Inserted by the auto-bootstrap placer (never user-constructed).

    The postscale is a power of two, so prescale * postscale is exactly 1
    and the return trip consumes no level."""

    def __init__(self, input_min, input_max, input_level):
        super().__init__()
        self.input_min = float(input_min)
        self.input_max = float(input_max)
        self.input_level = input_level
        self.prescale = 1.0
        self.postscale = 1
        self.constant = 0.0
        self.prescale_ptxt = None
        self.slot_count = None
        self.norm_level = None

    def fit(self):
        center = (self.input_min + self.input_max) / 2
        half_range = (self.input_max - self.input_min) / 2
        self.low = center - self.margin * half_range
        self.high = center + self.margin * half_range
        # residual headroom prescale (a power of two): only when q0 is too
        # narrow for the bootstrapper's integer prescale D to reach the
        # MessageRatio does the module squeeze the message further
        ratio = 1
        if self.scheme is not None and self.scheme.params.boot:
            p = self.scheme.params
            R = int(p.boot.get("MsgRatio", 256))
            q0_bits = sum(p.logq[: p.base_level + 1])
            gap = p.logscale + (R - 1).bit_length() - q0_bits
            ratio = (1 << gap) if gap > 0 else 1
        post = max(1, math.ceil((self.high - self.low) / 2)) * ratio
        self.postscale = 1 << (post - 1).bit_length()
        self.prescale = 1.0 / self.postscale
        self.constant = -(self.low + self.high) / 2

    def compile(self):
        elements = int(np.prod(self.fhe_input_shape))
        ring_slots = self.scheme.ctx.slots
        if elements >= ring_slots:
            # multi-ciphertext tensor: each member bootstraps at the full
            # slot count, so the plaintext grid spans n_cts * slots
            curr_slots = -(-elements // ring_slots) * ring_slots
        else:
            curr_slots = 2 ** math.ceil(math.log2(elements))
        self.slot_count = curr_slots
        self.scheme.bootstrapper.generate_bootstrapper(curr_slots)
        vec = np.zeros(curr_slots)
        vec[:elements] = self.prescale
        # the level just above the modulus floor (mod-drop is free)
        self.norm_level = self.scheme.params.base_level + 1
        ql = self.scheme.encoder.get_moduli_chain()[self.norm_level]
        self.prescale_ptxt = self.scheme.encoder.encode(
            vec, level=self.norm_level, scale=float(ql))
        # shift constants at the default scale: added before the prescale
        # mult, removed after the bootstrap (both at scale Delta)
        shift = np.full(curr_slots, self.constant)
        shift[elements:] = 0.0
        delta = self.scheme.ctx.default_scale
        btp = self.scheme.bootstrapper.get_for_slots(curr_slots)
        self.shift_in_ptxt = self.scheme.encoder.encode(
            shift, level=self.norm_level, scale=delta)
        self.shift_out_ptxt = self.scheme.encoder.encode(
            shift, level=btp.out_level, scale=delta)

    @timer
    def forward(self, x):
        if not self.he_mode:
            return x
        x = x.mod_drop(self.norm_level)
        x = x + self.shift_in_ptxt
        x = x * self.prescale_ptxt
        x = x.bootstrap()
        if self.postscale != 1:
            x = x * self.postscale
        x = x - self.shift_out_ptxt
        return x
