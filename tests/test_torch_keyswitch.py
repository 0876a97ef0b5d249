"""Key-switching of the PyTorch port against orion_tpu, bit for bit.

At every level of a LogN-8 chain (3 Q primes, 2 special primes) the same
random ciphertext polynomial (numpy seed) goes through orion_tpu's jnp
functions and the port's: ks_decompose, ks_finish, ks_finish_raw,
mod_drop_rescale and rescale_poly; at the top level also keyswitch and
ks_finish's trimmed and lean key forms (each form is a separate XLA
compile on the orion_tpu side, so they are not repeated per level).  Both key chests are seeded
alike, so their keys are equal.  At the top level the port is also held
against the Pallas entry points
ks_decompose_pallas, ks_finish_pallas and keyswitch_pallas, run in
interpret mode as tests/crypto/test_ks_pallas.py runs them.  On CPU
tensors the port runs the plain versions of its kernels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orion_tpu.crypto import KeyChest as JKeys
from orion_tpu.crypto import keyswitch as jks
from orion_tpu.crypto import ks_pallas
from orion_tpu.crypto.context import CKKSContext as JContext
from orion_tpu_torch.crypto import KeyChest as TKeys
from orion_tpu_torch.crypto import keyswitch as tks
from orion_tpu_torch.crypto.context import CKKSContext as TContext

CHAIN = dict(logn=8, logq=[29, 26, 26], logp=[29, 29], logscale=26, h=64,
             seed=3)


@pytest.fixture(scope="module", autouse=True)
def _unoptimised_xla():
    """orion_tpu's programs compile without most XLA optimizations here: a
    third less compile time, and integer and IEEE float32 ops give the
    same bits (which the comparisons check)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def chain():
    jctx, tctx = JContext(**CHAIN), TContext(**CHAIN, device="cpu")
    return jctx, JKeys(jctx), tctx, TKeys(tctx)


def _poly(ctx, rows, seed):
    rng = np.random.default_rng(seed)
    p = np.array([ctx.primes[i] for i in rows], np.int64)[:, None]
    return rng.integers(0, 1 << 62, (len(rows), ctx.n), dtype=np.int64) % p


def _same(jx, tx):
    return np.array_equal(np.asarray(jx).astype(np.int64), tx.numpy())


def _keys(jkey, tkey, jdl, tdl, trimmed):
    """(jax data, jax shoup, port data, port shoup), full or trimmed."""
    if not trimmed:
        return jkey.data, jkey.shoup, tkey.data, tkey.shoup
    dnum = len(tdl.digits)
    rows = np.array(jdl.ksk_rows)
    return (jkey.data[:dnum][:, :, rows], jkey.shoup[:dnum][:, :, rows],
            tkey.data[:dnum][:, :, tdl.ksk_rows_idx].contiguous(),
            tkey.shoup[:dnum][:, :, tdl.ksk_rows_idx].contiguous())


@pytest.mark.parametrize("level", [0, 1, 2])
def test_keyswitch_chain_bit_exact(chain, level):
    jctx, jkeys, tctx, tkeys = chain
    jdl, tdl = jks.dev_level(jctx, level), tks.dev_level(tctx, level)
    c = _poly(tctx, range(level + 1), seed=10 + level)
    jc, tc = jnp.asarray(c.astype(np.uint32)), torch.as_tensor(c)

    jext, text = jks.ks_decompose(jc, jdl), tks.ks_decompose(tc, tdl)
    assert _same(jext, text)

    rk_j, rk_t = jkeys.relin_key, tkeys.relin_key
    top = level == jctx.max_level
    forms = ([(False, False), (False, True), (True, False), (True, True)]
             if top else [(False, False)])
    for trimmed, lean in forms:
        jk, jsh, tk, tsh = _keys(rk_j, rk_t, jdl, tdl, trimmed)
        got = tks.ks_finish(text, tdl, tk, None if lean else tsh,
                            trimmed=trimmed)
        want = jks.ks_finish(jext, jdl, jk, None if lean else jsh,
                             trimmed=trimmed)
        assert _same(want, got), (trimmed, lean)

    if top:
        assert _same(jks.keyswitch(jc, jdl, rk_j.data, rk_j.shoup),
                     tks.keyswitch(tc, tdl, rk_t.data, rk_t.shoup))
    jraw = jks.ks_finish_raw(jext, jdl, rk_j.data, rk_j.shoup)
    traw = tks.ks_finish_raw(text, tdl, rk_t.data, rk_t.shoup)
    assert _same(jraw, traw)

    if level >= 1:
        # mod_drop_rescale is eager jnp in orion_tpu: jit it for the test
        jdrop = jax.jit(lambda a: jks.mod_drop_rescale(a, jdl))(jraw)
        assert _same(jdrop, tks.mod_drop_rescale(traw, tdl))
        ct = np.stack([c, _poly(tctx, range(level + 1), seed=20 + level)])
        assert _same(jks.rescale_poly(jnp.asarray(ct.astype(np.uint32)), jdl),
                     tks.rescale_poly(torch.as_tensor(ct), tdl))


def test_against_pallas_interpret(chain, monkeypatch):
    """The Pallas entry points (interpret mode, LogN 8, top level)."""
    monkeypatch.setenv("ORION_TPU_FUSED_KS", "1")
    jctx, jkeys, tctx, tkeys = chain
    level = jctx.max_level
    jdl, tdl = jks.dev_level(jctx, level), tks.dev_level(tctx, level)
    c = _poly(tctx, range(level + 1), seed=7)
    jc, tc = jnp.asarray(c.astype(np.uint32)), torch.as_tensor(c)
    rk_j, rk_t = jkeys.relin_key, tkeys.relin_key

    text = tks.ks_decompose(tc, tdl)
    assert _same(ks_pallas.ks_decompose_pallas(jc, jdl), text)
    want = ks_pallas.ks_finish_pallas(jks.ks_decompose(jc, jdl), jdl,
                                      rk_j.data, rk_j.shoup)
    assert _same(want, tks.ks_finish(text, tdl, rk_t.data, rk_t.shoup))
    assert _same(ks_pallas.keyswitch_pallas(jc, jdl, rk_j.data, rk_j.shoup),
                 tks.keyswitch(tc, tdl, rk_t.data, rk_t.shoup))
