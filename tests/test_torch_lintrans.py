"""The naive BSGS oracle (crypto/lintrans.py) and the int8 modular matmul
(crypto/mxu_modmatmul.py) of the port against orion_tpu's.

The three cases of tests/crypto/test_lintrans.py on the same LogN-8
chain: a 9-diagonal transform, diagonal 0 alone (no rotation) and a 2x2
block grid through eval_transform_blocked.  Diagonals and inputs come
from a fresh numpy generator per case, both key chests from the same
seed, and each package runs the same operations in the same order, so
keys and encryptions are equal.  orion_tpu's evaluation runs op by op,
as its own test runs it: here that takes 5 s for the three cases, where
one jitted program per case took 50 s to compile.  The port's output
ciphertexts must equal orion_tpu's bit for bit, and their decryptions
the cleartext matvec.

ModMatmulPlan: Y = W X mod p over orion_tpu's three primes at (m, n) in
{(64, 128), (128, 256)}, equal to orion_tpu's output and to the exact
integer product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.crypto import CKKSContext as JContext
from orion_tpu.crypto import Encoder as JEncoder
from orion_tpu.crypto import Evaluator as JEvaluator
from orion_tpu.crypto import KeyChest as JKeys
from orion_tpu.crypto import lintrans as jlt
from orion_tpu.crypto.ciphertext import Ciphertext as JCiphertext
from orion_tpu.crypto.mxu_modmatmul import ModMatmulPlan as JPlan
from orion_tpu_torch.crypto import CKKSContext as TContext
from orion_tpu_torch.crypto import Encoder as TEncoder
from orion_tpu_torch.crypto import Evaluator as TEvaluator
from orion_tpu_torch.crypto import KeyChest as TKeys
from orion_tpu_torch.crypto import lintrans as tlt
from orion_tpu_torch.crypto.ciphertext import Ciphertext as TCiphertext
from orion_tpu_torch.crypto.mxu_modmatmul import ModMatmulPlan as TPlan

CHAIN = dict(logn=8, logq=[29, 26, 26], logp=[29, 29], logscale=26, h=32)


@pytest.fixture(scope="module", autouse=True)
def _unoptimised_xla():
    """orion_tpu's programs compile without most XLA optimizations: a
    third less compile time, and integer ops give the same bits."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def schemes():
    jctx, tctx = JContext(**CHAIN), TContext(**CHAIN, device="cpu")
    jkeys, tkeys = JKeys(jctx), TKeys(tctx)
    return ((jctx, JEncoder(jctx), jkeys, JEvaluator(jctx, jkeys)),
            (tctx, TEncoder(tctx), tkeys, TEvaluator(tctx, tkeys)))


def _encrypt(pkg, v):
    ctx, enc, keys, _ = pkg
    pt, s = enc.encode(v)
    ct = keys.encrypt_rns(pt)
    if isinstance(ctx, JContext):
        return JCiphertext(jnp.asarray(ct.astype(np.uint32)), ctx.max_level,
                           s)
    return TCiphertext(torch.as_tensor(ct), ctx.max_level, s)


def _decrypt(pkg, ct):
    _, enc, keys, _ = pkg
    raw = keys.decrypt_rns(np.asarray(ct.data).astype(np.int64))
    return enc.decode(raw, ct.scale)


def _matvec_from_diags(diags, v, slots):
    out = np.zeros(slots)
    for d, vec in diags.items():
        out += vec * np.roll(v, -d)  # rot-left by d
    return out


def _run(pkg, lt, grids, vs, num_rows):
    """Encrypt vs, then out_i = rescale(sum_j T[i,j] @ ct_j)."""
    ctx, enc, keys, ev = pkg
    trs = {k: lt.compile_transform(enc, d, ctx.max_level, ctx.slots)
           for k, d in grids.items()}
    cts = [_encrypt(pkg, v) for v in vs]
    # the rotation keys, made in one order in both packages
    for r in sorted(set().union(*(tr.rotations_needed()
                                  for tr in trs.values()))):
        keys.galois_key(ctx.galois_element(r))
    return lt.eval_transform_blocked(ev, trs, cts, num_rows), trs


def _check(schemes, grids, vs, num_rows, want, atol):
    jpkg, tpkg = schemes
    jouts, _ = _run(jpkg, jlt, grids, vs, num_rows)
    touts, trs = _run(tpkg, tlt, grids, vs, num_rows)
    ctx = tpkg[0]
    for j, t, w in zip(jouts, touts, want):
        assert (j.level, j.scale) == (t.level, t.scale)
        assert t.level == ctx.max_level - 1
        assert np.array_equal(np.asarray(j.data).astype(np.int64),
                              t.data.numpy())
        np.testing.assert_allclose(_decrypt(tpkg, t), w, atol=atol)
    return trs


def test_bsgs_matvec(schemes):
    slots = schemes[1][0].slots
    rng = np.random.default_rng(3)
    idxs = sorted(rng.choice(slots, size=9, replace=False))
    diags = {int(d): rng.uniform(-1, 1, slots) for d in idxs}
    v = rng.uniform(-1, 1, slots)
    trs = _check(schemes, {(0, 0): diags}, [v], 1,
                 [_matvec_from_diags(diags, v, slots)], 5e-3)
    tr = trs[(0, 0)]
    # errorless: the plaintexts sit at scale q_l, with Shoup companions
    pt = next(iter(tr.plaintexts.values()))
    assert pt.scale == float(schemes[1][0].q_primes[tr.level])
    assert torch.equal(pt.shoup, (pt.data << 32) // torch.as_tensor(
        schemes[1][0].primes[: tr.level + 1])[:, None])


def test_bsgs_single_diag_zero(schemes):
    """Diagonal 0 only = elementwise product, no rotations at all."""
    slots = schemes[1][0].slots
    rng = np.random.default_rng(4)
    diags = {0: rng.uniform(-1, 1, slots)}
    v = rng.uniform(-1, 1, slots)
    trs = _check(schemes, {(0, 0): diags}, [v], 1, [diags[0] * v], 2e-3)
    assert trs[(0, 0)].rotations_needed() == set()


def test_blocked_transform(schemes):
    """2x2 block grid: out_i = sum_j T[i,j] @ v_j."""
    slots = schemes[1][0].slots
    rng = np.random.default_rng(5)
    grids = {}
    for i in range(2):
        for j in range(2):
            idxs = rng.choice(slots, size=4, replace=False)
            grids[(i, j)] = {int(d): rng.uniform(-1, 1, slots) for d in idxs}
    vs = [rng.uniform(-1, 1, slots) for _ in range(2)]
    want = [sum(_matvec_from_diags(grids[(i, j)], vs[j], slots)
                for j in range(2)) for i in range(2)]
    _check(schemes, grids, vs, 2, want, 5e-3)


@pytest.mark.parametrize("p", [536870909, 67108859, 1073741789])
@pytest.mark.parametrize("m,n", [(64, 128), (128, 256)])
def test_mod_matmul_plan(p, m, n):
    rng = np.random.default_rng(p % 1000 + m)
    W = rng.integers(0, p, (m, m), dtype=np.uint64)
    X = rng.integers(0, p, (m, n), dtype=np.uint64)
    jplan = JPlan(W, p)
    want_j = np.asarray(jax.jit(jplan.__call__)(
        jnp.asarray(X.astype(np.uint32))))
    got = TPlan(W, p, device="cpu")(torch.as_tensor(X.astype(np.int64)))
    exact = (W.astype(object) @ X.astype(object)) % p
    assert np.array_equal(got.numpy(), want_j.astype(np.int64))
    assert np.array_equal(got.numpy(), exact.astype(np.int64))
