"""Polynomial activations.

Counterpart of `orion_tpu/nn/activation.py`: raw-monomial `Activation`,
`Quad`, Chebyshev-fitted activations (ELU, GELU, SiLU, ...), the composite
minimax `_Sign`, and `ReLU = x * sign(x)` with pre/postscale.  Cleartext
math is torch; the fits are numpy, as orion_tpu's; FHE evaluation goes
through the scheme's poly_evaluator (crypto/polyeval.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .module import Module, Sequential, timer, to_numpy, to_tensor
from .operations import Mult


class Activation(Module):
    """Raw monomial polynomial activation; depth = ceil(log2(#coeffs))."""

    def __init__(self, coeffs):
        super().__init__()
        self.coeffs = list(coeffs)
        self.output_scale = None
        self.set_depth()

    def set_depth(self):
        self.depth = int(math.ceil(math.log2(len(self.coeffs))))

    def set_output_scale(self, output_scale):
        self.output_scale = output_scale

    def compile(self):
        self.poly = self.scheme.poly_evaluator.generate_monomial(self.coeffs)

    @timer
    def forward(self, x):
        if self.he_mode:
            return self.scheme.poly_evaluator.evaluate_polynomial(
                x, self.poly, self.output_scale)
        x = to_tensor(x)
        out = torch.zeros_like(x)
        for coeff in self.coeffs:  # Horner, highest power first
            out = coeff + x * out
        return out


class Quad(Module):
    """x^2; under FHE the output keeps the input's scale."""

    def __init__(self):
        super().__init__()
        self.set_depth(1)

    @timer
    def forward(self, x):
        if not self.he_mode:
            x = to_tensor(x)
            return x * x
        out = x * x
        out.set_scale(x.scale())
        return out


class Chebyshev(Module):
    """Chebyshev-interpolated activation over the fitted input range."""

    def __init__(self, degree, fn, within_composite=False):
        super().__init__()
        self.degree = degree
        self.fn = fn
        self.within_composite = within_composite
        self.coeffs = None
        self.output_scale = None
        self.prescale = 1.0
        self.constant = 0.0

    def fit(self):
        if self.within_composite:
            return
        center = (self.input_min + self.input_max) / 2
        half_range = (self.input_max - self.input_min) / 2
        self.low = center - self.margin * half_range
        self.high = center + self.margin * half_range

        nodes = np.polynomial.chebyshev.chebpts1(self.degree + 1)
        if self.low < -1 or self.high > 1:
            self.prescale = 2 / (self.high - self.low)
            self.constant = -self.prescale * (self.low + self.high) / 2
            evals = (nodes + 1) * (self.high - self.low) / 2 + self.low
        else:
            evals = nodes
        series = np.polynomial.Chebyshev.fit(
            nodes, np.asarray(self.fn(evals)), self.degree)
        self.set_coeffs(series.coef.tolist())
        self.set_depth()

    def set_coeffs(self, coeffs):
        self.coeffs = list(coeffs)

    def set_depth(self):
        self.depth = int(math.ceil(math.log2(self.degree + 1)))
        if self.prescale != 1:
            self.depth += 1  # affine map into [-1,1] costs a level

    def set_output_scale(self, output_scale):
        self.output_scale = output_scale

    def compile(self):
        self.poly = self.scheme.poly_evaluator.generate_chebyshev(self.coeffs)

    @timer
    def forward(self, x):
        if not self.he_mode:
            return torch.as_tensor(
                np.asarray(self.fn(to_numpy(x)), dtype=np.float32))
        if not self.fused:
            if self.prescale != 1:
                x = x * self.prescale
            if self.constant != 0:
                x = x + self.constant
        return self.scheme.poly_evaluator.evaluate_polynomial(
            x, self.poly, self.output_scale)


class ELU(Chebyshev):
    def __init__(self, alpha=1.0, degree=31):
        super().__init__(degree, self.fn)
        self.alpha = alpha

    def fn(self, x):
        return np.where(x > 0, x, self.alpha * (np.exp(np.minimum(x, 0)) - 1))


class Hardshrink(Chebyshev):
    def __init__(self, degree=31, lambd=0.5):
        super().__init__(degree, self.fn)
        self.lambd = lambd

    def fn(self, x):
        return np.where((x > self.lambd) | (x < -self.lambd), x, 0.0)


class GELU(Chebyshev):
    def __init__(self, degree=31):
        super().__init__(degree, self.fn)

    def fn(self, x):
        from scipy.special import erf
        return 0.5 * x * (1 + erf(x / np.sqrt(2.0)))


class SiLU(Chebyshev):
    def __init__(self, degree=31):
        super().__init__(degree, self.fn)

    def fn(self, x):
        return x / (1 + np.exp(-x))


class Sigmoid(Chebyshev):
    def __init__(self, degree=31):
        super().__init__(degree, self.fn)

    def fn(self, x):
        return 1 / (1 + np.exp(-x))


class SELU(Chebyshev):
    def __init__(self, degree=31):
        super().__init__(degree, self.fn)

    def fn(self, x):
        alpha = 1.6732632423543772
        scale = 1.0507009873554805
        return scale * np.where(x > 0, x,
                                alpha * (np.exp(np.minimum(x, 0)) - 1))


class Softplus(Chebyshev):
    def __init__(self, degree=31):
        super().__init__(degree, self.fn)

    def fn(self, x):
        return np.logaddexp(0.0, x)


class Mish(Chebyshev):
    def __init__(self, degree=31):
        super().__init__(degree, self.fn)

    def fn(self, x):
        return x * np.tanh(np.logaddexp(0.0, x))


class _Sign(Module):
    """Composite minimax sign: a chain of Chebyshev polys approximating
    sign, the last one mapped to the step [0, 1], with the output scale
    pinned to q_l for an exact final rescale."""

    def __init__(self, degrees=(15, 15, 27), prec=128, logalpha=6, logerr=12):
        super().__init__()
        self.degrees = list(degrees)
        self.prec = prec
        self.logalpha = logalpha
        self.logerr = logerr
        self.pin_level = None
        acts = []
        for i, degree in enumerate(self.degrees):
            is_last = i == len(self.degrees) - 1
            fn = self.fn2 if is_last else self.fn1
            acts.append(Chebyshev(degree, fn, within_composite=True))
        self.acts = Sequential(*acts)

    def fit(self):
        coeff_sets = self.scheme.poly_evaluator.generate_minimax_sign_coeffs(
            self.degrees, self.prec, self.logalpha, self.logerr)
        for act, coeffs in zip(self.acts, coeff_sets):
            act.set_coeffs(coeffs)
            act.set_depth()

    def fn1(self, x):
        return np.where(x <= 0, -1.0, 1.0)

    def fn2(self, x):
        return np.where(x <= 0, 0.0, 1.0)

    def forward(self, x):
        if self.he_mode:
            last = self.acts[-1]
            # the pinned modulus is the prime the final x*sign(x) rescale
            # divides by: ReLU.mult2's planned level (ReLU passes it in);
            # the min() fallback covers uncompiled use
            pin = self.pin_level
            if pin is None:
                pin = min(x.level(), last.level - last.depth)
            ql = self.scheme.encoder.get_moduli_chain()[pin]
            last.set_output_scale(float(ql))
        for act in self.acts:
            x = act(x)
        return x


class ReLU(Module):
    """x * sign(x) with range pre/postscale."""

    def __init__(self, degrees=(15, 15, 27), prec=128, logalpha=6, logerr=12):
        super().__init__()
        self.degrees = list(degrees)
        self.sign = _Sign(degrees, prec, logalpha, logerr)
        self.mult1 = Mult()
        self.mult2 = Mult()
        self.prescale = 1.0
        self.postscale = 1

    def fit(self):
        self.input_min = self.mult1.input_min
        self.input_max = self.mult1.input_max
        absmax = max(abs(self.input_min), abs(self.input_max)) * self.margin
        if absmax > 1:
            self.postscale = int(math.ceil(absmax))
            self.prescale = 1.0 / self.postscale

    @timer
    def forward(self, x):
        x = self.mult1(x, self.prescale)
        # sign's exact-rescale pin = the level mult2's rescale divides at
        self.sign.pin_level = self.mult2.level
        x = self.mult2(x, self.sign(x))
        x = x * self.postscale  # integer mult, no level consumed
        return x
