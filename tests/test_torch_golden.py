"""The golden pipeline (tests/crypto/golden_pipeline.py) on the PyTorch port.

The same fixed-seed chain of homomorphic ops (LogN 10: encrypt, mul_relin,
rotate, mul_plain, scalar affine, conjugate, a second mul_relin) runs
through both packages.  The port's decrypted outputs must reproduce
golden_vectors.npz at 1e-9, as orion_tpu's do, and every raw ciphertext
must equal orion_tpu's bit for bit.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import orion_tpu.crypto as jcrypto
import orion_tpu.crypto.ciphertext as jct
import orion_tpu_torch.crypto as tcrypto
import orion_tpu_torch.crypto.ciphertext as tct

GOLDEN = Path(__file__).parent / "crypto" / "golden_vectors.npz"
SEED = 2024

# (crypto package, ciphertext module, host -> device, device -> host,
# program wrapper, context device keywords): orion_tpu's chain of ops is
# jitted into one program rather than dispatched op by op, which would
# compile every jnp op alone; the port runs its plain path on the CPU
def _jit_unoptimised(fn):
    """jax.jit compiled without most XLA optimizations: a third less
    compile time, and integer and IEEE float32 ops give the same bits."""
    def run(*args):
        prev = jax.config.read("jax_disable_most_optimizations")
        jax.config.update("jax_disable_most_optimizations", True)
        try:
            return jax.jit(fn)(*args)
        finally:
            jax.config.update("jax_disable_most_optimizations", prev)
    return run


JAX = (jcrypto, jct, lambda x: jnp.asarray(np.asarray(x).astype(np.uint32)),
       lambda t: np.asarray(t).astype(np.int64), _jit_unoptimised, {})
PORT = (tcrypto, tct, lambda x: torch.as_tensor(np.asarray(x, np.int64)),
        lambda t: t.numpy(), lambda f: f, {"device": "cpu"})


def run_pipeline(pkg):
    """golden_pipeline.run_pipeline written once for both packages:
    returns ({stage: decrypted vector}, {stage: raw ciphertext})."""
    crypto, ctmod, to_dev, to_host, op, dev = pkg
    ctx = crypto.CKKSContext(logn=10, logq=[29, 26, 26, 26], logp=[29, 29],
                             logscale=26, h=64, seed=SEED, **dev)
    enc = crypto.Encoder(ctx)
    keys = crypto.KeyChest(ctx)
    ev = crypto.Evaluator(ctx, keys)

    rng = np.random.default_rng(SEED)
    a = rng.uniform(-1, 1, ctx.slots)
    b = rng.uniform(-1, 1, ctx.slots)

    def encrypt(v):
        pt, s = enc.encode(v)
        return ctmod.Ciphertext(to_dev(keys.encrypt_rns(pt)), ctx.max_level,
                                s)

    vecs, raws = {}, {}

    def record(name, ct):
        raws[name] = to_host(ct.data)
        raw = keys.decrypt_rns(raws[name])
        vecs[name] = np.asarray(enc.decode(raw, ct.scale), dtype=np.float64)

    def chain(ca, cb, pt):
        prod = ev.mul_relin(ca, cb)
        return {
            "roundtrip": ca,
            "mul_relin": prod,
            "rotate3": ev.rotate(ca, 3),
            "mul_plain": ev.mul_plain(ca, pt),
            "scalar_affine": ev.add_scalar(ev.mul_scalar_float(ca, 0.37),
                                           0.25),
            "conjugate": ev.conjugate(ca),
            "square_of_product": ev.mul_relin(prod, prod),
        }

    ca, cb = encrypt(a), encrypt(b)
    ptd, pts, ptscale = enc.encode(b, level=ctx.max_level, with_shoup=True)
    pt = ctmod.Plaintext(to_dev(ptd), to_dev(pts), ctx.max_level, ptscale)
    for name, ct in op(chain)(ca, cb, pt).items():
        record(name, ct)
    return vecs, raws


@pytest.fixture(scope="module")
def port_run():
    return run_pipeline(PORT)


@pytest.mark.skipif(not GOLDEN.exists(), reason="golden vectors not generated")
def test_port_reproduces_golden_vectors(port_run):
    want = np.load(GOLDEN)
    vecs, _ = port_run
    assert set(want.files) == set(vecs)
    for name in want.files:
        np.testing.assert_allclose(
            vecs[name], want[name], atol=1e-9, rtol=0,
            err_msg=f"golden regression in stage '{name}'")


def test_port_ciphertexts_equal_orion_tpu(port_run):
    _, jraws = run_pipeline(JAX)
    _, traws = port_run
    assert set(jraws) == set(traws)
    for name in jraws:
        assert np.array_equal(jraws[name], traws[name]), name


def run_evaluator_ops(pkg):
    """Evaluator ops off the golden chain, in both packages: add/sub across
    levels, integer and float scalar products, adjust_scale, mul_plain
    without a Shoup companion, and mul_relin's two-step branch (no
    rescale, then an explicit rescale) and at level 0."""
    crypto, ctmod, to_dev, to_host, op, dev = pkg
    ctx = crypto.CKKSContext(logn=8, logq=[29, 26, 26], logp=[29, 29],
                             logscale=26, h=64, seed=SEED + 1, **dev)
    enc = crypto.Encoder(ctx)
    keys = crypto.KeyChest(ctx)
    ev = crypto.Evaluator(ctx, keys)
    rng = np.random.default_rng(SEED + 1)

    def encrypt(level):
        pt, s = enc.encode(rng.uniform(-1, 1, ctx.slots), level=level)
        return ctmod.Ciphertext(to_dev(keys.encrypt_rns(pt)), level, s)

    def ops(ca, cb, c1, pt):
        return {
            "add_sub": ev.sub(ev.add(ca, cb), ca),
            "mul_int": ev.mul_scalar(ca, 3),
            "mul_float": ev.mul_scalar(ca, -0.625),
            "adjust_scale": ev.adjust_scale(ca, 2.0 ** 25),
            "mul_plain_mont": ev.mul_plain(ca, pt),
            "relin_two_step": ev.rescale(ev.mul_relin(ca, cb, rescale=False)),
            "mixed_levels": ev.add(ca.with_(scale=c1.scale), c1),
            "relin_level0": ev.mul_relin(ev.mod_drop(c1, 0),
                                         ev.mod_drop(c1, 0), rescale=False),
        }

    ca, cb = encrypt(2), encrypt(2)
    c1 = encrypt(1)
    ptd, ptscale = enc.encode(rng.uniform(-1, 1, ctx.slots), level=2)
    pt = ctmod.Plaintext(to_dev(ptd), None, 2, ptscale)
    return {k: (to_host(v.data), v.level, v.scale)
            for k, v in op(ops)(ca, cb, c1, pt).items()}


def test_evaluator_ops_equal_orion_tpu():
    want, got = run_evaluator_ops(JAX), run_evaluator_ops(PORT)
    assert set(want) == set(got)
    for name in want:
        (wd, wl, ws), (gd, gl, gs) = want[name], got[name]
        assert (wl, ws) == (gl, gs), name
        assert np.array_equal(wd, gd), name
