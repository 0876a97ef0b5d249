"""Polynomial activations: the port's polyeval, minimax and Chebyshev fits
against orion_tpu's.

* The minimax sign coefficients (numpy and scipy's HiGHS LP in both
  packages) and the Chebyshev fits of SiLU are equal exactly.
* `evaluate_polynomial` on one ciphertext at LogN 8 (a 16-prime chain,
  3 special primes) gives ciphertexts equal to orion_tpu's bit for bit: a
  degree-31 Chebyshev (binary splitting to linear leaves), a degree-63
  Chebyshev in hi-scale chunked Paterson-Stockmeyer mode on a message at
  scale Delta^2, and the (7, 7) minimax sign composite with x * sign(x).
  orion_tpu's side runs every homomorphic op as a jitted program
  (`JittedEvaluator`, cached per op and metadata, so the three
  evaluations share the programs of their common levels): a whole
  evaluation traced into one program costs about twice as much to
  compile on the CPU.
* add_plain, sub_plain and mul_plain with a plaintext above the
  ciphertext's level, and conjugate, equal orion_tpu's bit for bit.
* The port's multi-ciphertext path (4 ciphertexts stacked on a batch axis,
  one circuit) equals 4 single calls.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orion_tpu.crypto as jcrypto
import orion_tpu.nn as jon
import orion_tpu_torch.crypto as tcrypto
import orion_tpu_torch.nn as ton
from orion_tpu.crypto import minimax as jminimax
from orion_tpu.crypto import polyeval as jpoly
from orion_tpu.crypto.ciphertext import Ciphertext as JCt
from orion_tpu.crypto.ciphertext import Plaintext as JPt
from orion_tpu_torch.crypto import minimax as tminimax
from orion_tpu_torch.crypto import polyeval as tpoly
from orion_tpu_torch.crypto.ciphertext import Ciphertext as TCt
from orion_tpu_torch.crypto.ciphertext import Plaintext as TPt
from orion_tpu_torch.runtime.services import PolyEvaluatorService

SEED = 31
CTX = dict(logn=8, logq=[29] + [26] * 15, logp=[29, 29, 29], logscale=26,
           h=64, seed=SEED)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain path at these sizes is many small torch ops: one
    intra-op thread runs them as fast alone and does not spin against the
    other test workers' threads (eight threads each made these tests up
    to 25x slower in a 3-worker run)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("degrees", [(15, 15, 27), (7, 7)])
def test_minimax_sign_coeffs_equal(degrees):
    want = jminimax.generate_minimax_sign_coeffs(list(degrees))
    got = tminimax.generate_minimax_sign_coeffs(list(degrees))
    assert len(got) == len(degrees)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("degree", [31, 127])
def test_silu_chebyshev_fit_equal(degree):
    """The same range, margin and degree give the same Chebyshev series,
    affine prescale and depth."""
    fits = []
    for on in (jon, ton):
        act = on.SiLU(degree=degree)
        on.Module.set_margin(2.0)
        act.input_min, act.input_max = -3.7, 5.2
        act.fit()
        fits.append(act)
    j, t = fits
    assert np.array_equal(np.asarray(t.coeffs), np.asarray(j.coeffs))
    assert (t.prescale, t.constant, t.depth) == (j.prescale, j.constant,
                                                 j.depth)
    assert len(t.coeffs) == degree + 1


_SCHEMES = []


def _encrypt_both(x, level, scale):
    """The same encryption in both packages: equal keys from one seed,
    made once per process, and randomness drawn in step."""
    if not _SCHEMES:
        for crypto, kw in ((jcrypto, {}), (tcrypto, {"device": "cpu"})):
            ctx = crypto.CKKSContext(**CTX, **kw)
            keys = crypto.KeyChest(ctx)
            _SCHEMES.append((crypto.Evaluator(ctx, keys), keys,
                             crypto.Encoder(ctx)))
    out = []
    for (ev, keys, enc), to_dev, ct_cls in zip(
            _SCHEMES, (lambda a: jnp.asarray(a.astype(np.uint32)),
                       torch.as_tensor), (JCt, TCt)):
        pt, s = enc.encode(x, level=level, scale=scale)
        out.append((ev, ct_cls(to_dev(keys.encrypt_rns(pt)), level, s),
                    keys, enc))
    return out


class JittedEvaluator:
    """orion_tpu's Evaluator with every method call jitted: one program per
    (method, ciphertext levels and scales, scalar arguments), compiled
    without most XLA optimizations (a third less compile time; integer
    and IEEE float32 ops give the same bits) and cached per process."""

    _programs: dict = {}

    def __init__(self, ev):
        self._ev = ev

    def __getattr__(self, name):
        fn = getattr(self._ev, name)
        if not callable(fn):
            return fn

        def run(*args, **kw):
            meta = tuple((type(a).__name__, a.level, a.scale)
                         if isinstance(a, (JCt, JPt)) else ("const", a)
                         for a in args)
            key = (id(self._ev), name, meta, tuple(sorted(kw.items())))
            if key not in self._programs:
                def body(datas, _meta=meta):
                    it = iter(datas)
                    real = [a if m[0] == "const" else next(it)
                            for a, m in zip(args, _meta)]
                    return fn(*real, **kw)
                self._programs[key] = jax.jit(body)
            prev = jax.config.read("jax_disable_most_optimizations")
            jax.config.update("jax_disable_most_optimizations", True)
            try:
                return self._programs[key](
                    [a for a in args if isinstance(a, (JCt, JPt))])
            finally:
                jax.config.update("jax_disable_most_optimizations", prev)

        return run


def _sign_coeffs():
    if "sign" not in _SIGN:
        _SIGN["sign"] = tminimax.generate_minimax_sign_coeffs([7, 7])
    return _SIGN["sign"]


_SIGN = {}


def _relu_circuit(pkg):
    """x * sign(x) with the (7, 7) composite, as nn.ReLU runs it: the last
    stage's output pinned to the prime of the final product's rescale."""
    def run(ev, x):
        t = x
        sets = _sign_coeffs()
        # mult2's level: the sign chain's output level (6 levels below)
        pin = x.level - 6
        for i, c in enumerate(sets):
            last = i == len(sets) - 1
            scale = float(ev.ctx.q_primes[pin]) if last else None
            t = pkg.evaluate_polynomial(ev, t, pkg.Polynomial(c, "chebyshev"),
                                        output_scale=scale)
        return ev.mul_relin(ev.mod_drop(x, t.level), t)
    return run


def _cheb(coeffs, hi=False):
    def make(pkg):
        def run(ev, x):
            return pkg.evaluate_polynomial(
                ev, x, pkg.Polynomial(list(coeffs), "chebyshev"),
                hi_scale=hi)
        return run
    return make


RNG = np.random.default_rng(SEED)
SILU31 = np.polynomial.chebyshev.chebinterpolate(
    lambda y: y / (1 + np.exp(-4 * y)), 31)
WAVE63 = np.polynomial.chebyshev.chebinterpolate(
    lambda y: np.sin(3 * y) / 3, 63)
CASES = {
    # name: (circuit maker, message scale, input level, reference fn)
    "chebyshev31": (_cheb(SILU31), 2.0 ** 26, 15,
                    lambda y: y / (1 + np.exp(-4 * y))),
    "hi_scale_chunked63": (_cheb(WAVE63, hi=True), 2.0 ** 52, 15,
                           lambda y: np.sin(3 * y) / 3),
    "sign77_relu": (_relu_circuit, 2.0 ** 26, 15,
                    lambda y: y * np.polynomial.chebyshev.chebval(
                        np.polynomial.chebyshev.chebval(
                            y, _sign_coeffs()[0]), _sign_coeffs()[1])),
}


@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_polynomial_equals_orion_tpu(name):
    make, scale, level, ref = CASES[name]
    x = RNG.uniform(-1, 1, 128)
    (jev, jct, _, _), (tev, tct, tkeys, tenc) = _encrypt_both(x, level,
                                                              scale)
    assert np.array_equal(np.asarray(jct.data).astype(np.int64),
                          tct.data.numpy())
    jout = make(jpoly)(JittedEvaluator(jev), jct)
    tout = make(tpoly)(tev, tct)
    assert (tout.level, tout.scale) == (jout.level, jout.scale)
    assert np.array_equal(np.asarray(jout.data).astype(np.int64),
                          tout.data.numpy())
    got = tenc.decode(tkeys.decrypt_rns(tout.data.numpy()), tout.scale)
    err = np.max(np.abs(got[:128] - ref(x)))
    assert err < 0.01, err


def test_plain_ops_at_mixed_levels_equal_orion_tpu():
    """add_plain, sub_plain and mul_plain with a plaintext encoded above
    the ciphertext's level (sliced to it, as the Bootstrap module's shift
    and prescale are), and conjugate, equal orion_tpu's bit for bit."""
    x = RNG.uniform(-1, 1, 128)
    (jev, jct, _, jenc), (tev, tct, _, tenc) = _encrypt_both(x, 10,
                                                             2.0 ** 26)
    y = RNG.uniform(-1, 1, 128)
    pts = []
    for enc, to_dev, pt_cls in ((jenc, lambda a: jnp.asarray(
            a.astype(np.uint32)), JPt), (tenc, torch.as_tensor, TPt)):
        data, s = enc.encode(y, level=13, scale=2.0 ** 26)
        pts.append(pt_cls(to_dev(data), None, 13, s))
    jpt, tpt = pts
    jev = JittedEvaluator(jev)
    for op in ("add_plain", "sub_plain", "mul_plain"):
        want = getattr(jev, op)(jct, jpt)
        got = getattr(tev, op)(tct, tpt)
        assert (got.level, got.scale) == (want.level, want.scale), op
        assert np.array_equal(np.asarray(want.data).astype(np.int64),
                              got.data.numpy()), op
    want, got = jev.conjugate(jct), tev.conjugate(tct)
    assert np.array_equal(np.asarray(want.data).astype(np.int64),
                          got.data.numpy())


def test_stacked_ciphertexts_equal_single_calls():
    """The poly evaluator's multi-ciphertext path: 4 ciphertexts stacked
    on a batch axis give, item for item, the single-call results."""
    from orion_tpu_torch.runtime.tensors import CipherTensor

    ctx = tcrypto.CKKSContext(**CTX, device="cpu")
    enc, keys = tcrypto.Encoder(ctx), tcrypto.KeyChest(ctx)
    ev = tcrypto.Evaluator(ctx, keys)
    cts = []
    for _ in range(4):
        pt, s = enc.encode(RNG.uniform(-1, 1, ctx.slots), level=12)
        cts.append(TCt(torch.as_tensor(keys.encrypt_rns(pt)), 12, s))

    class _Scheme:
        evaluator = ev

    poly = tpoly.Polynomial(list(SILU31[:16]), "chebyshev")
    out = PolyEvaluatorService(_Scheme()).evaluate_polynomial(
        CipherTensor(_Scheme(), cts, (4 * ctx.slots,)), poly,
        output_scale=float(ctx.q_primes[7]))
    assert len(out.cts) == 4
    for ct, got in zip(cts, out.cts):
        want = tpoly.evaluate_polynomial(ev, ct, poly,
                                         output_scale=float(ctx.q_primes[7]))
        assert (got.level, got.scale) == (want.level, want.scale)
        assert torch.equal(got.data, want.data)
    assert out.cts[0].level == 12 - math.ceil(math.log2(16))
