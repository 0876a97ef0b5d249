"""The ConjugateInvariant ring of the PyTorch port against orion_tpu.

The CI ring of degree n stores n coefficients, has n real slots, and
routes every NTT through the 2n-degree standard ring
(`orion_tpu_torch/crypto/ntt.py`, `crypto/ref.py` CIHostRing).  On a CI
context at LogN 10, built as tests/crypto/test_ci_ring.py builds it, both
packages must give:

* the same tables: slots = n, primes generated modulo 4n, the orbit maps
  `ci_keep` / `ci_src`, the automorphism permutations, and the identity
  as conjugation element;
* the same transforms, bit for bit: CIHostRing.ntt / intt, and the port's
  plain `ci_ntt` / `ci_intt` (and the ring_ntt / ring_intt seam, which on
  CPU tensors runs them) against orion_tpu's jitted `ntt.ci_ntt` /
  `ci_intt`;
* the same ciphertexts: encryption, mul_relin, the rescale chain,
  rotations, and conjugation as the identity (no key-switch);
* the same key-switch at every level: the port's plain ks_decompose /
  ks_finish / ks_finish_raw and rescale_poly against orion_tpu's jnp
  path, which is the path orion_tpu takes on the CI ring (its Pallas
  key-switch refuses it).

Bootstrapping on the CI ring is refused by both packages' config parsing.
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
from orion_tpu.crypto import keyswitch as jks
from orion_tpu.crypto import ntt as jntt
from orion_tpu.crypto.ciphertext import Ciphertext as JCiphertext
from orion_tpu.runtime.config import parse_config as jparse
from orion_tpu_torch.crypto import CKKSContext as TContext
from orion_tpu_torch.crypto import Encoder as TEncoder
from orion_tpu_torch.crypto import Evaluator as TEvaluator
from orion_tpu_torch.crypto import KeyChest as TKeys
from orion_tpu_torch.crypto import keyswitch as tks
from orion_tpu_torch.crypto import ntt as tntt
from orion_tpu_torch.crypto.ciphertext import Ciphertext as TCiphertext
from orion_tpu_torch.kernels import keyswitch as kks
from orion_tpu_torch.kernels import launch_counts
from orion_tpu_torch.runtime.config import parse_config as tparse

CI = dict(logn=10, logq=[29, 26, 26, 26], logp=[29, 29], logscale=26, h=64,
          ring_type="conjugate_invariant")


@pytest.fixture(scope="module", autouse=True)
def _unoptimised_xla():
    """orion_tpu's programs compile without most XLA optimizations here
    (integer and IEEE float32 ops give the same bits either way)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def pair():
    jctx, tctx = JContext(**CI), TContext(**CI, device="cpu")
    jkeys, tkeys = JKeys(jctx), TKeys(tctx)
    return (jctx, JEncoder(jctx), jkeys, JEvaluator(jctx, jkeys),
            tctx, TEncoder(tctx), tkeys, TEvaluator(tctx, tkeys))


def _same(jx, tx):
    return np.array_equal(np.asarray(jx).astype(np.int64), tx.numpy())


def _same_ct(jct, tct):
    return ((jct.level, jct.scale) == (tct.level, tct.scale)
            and _same(jct.data, tct.data))


def _residues(ctx, shape, seed):
    rng = np.random.default_rng(seed)
    p = np.array(ctx.primes[: shape[-2]], np.int64)[:, None]
    return rng.integers(0, 1 << 62, shape, dtype=np.int64) % p


def _encrypt(pair, v, level=None):
    """The same vector encrypted by both packages (their key chests draw
    alike), as (orion_tpu ciphertext, port ciphertext)."""
    jctx, jenc, jkeys, _, tctx, tenc, tkeys, _ = pair
    lvl = jctx.max_level if level is None else level
    jpt, js = jenc.encode(v, level=lvl)
    tpt, ts = tenc.encode(v, level=lvl)
    jct = JCiphertext(jnp.asarray(jkeys.encrypt_rns(jpt).astype(np.uint32)),
                      lvl, js)
    tct = TCiphertext(torch.as_tensor(tkeys.encrypt_rns(tpt)), lvl, ts)
    return jct, tct


def test_ci_tables_equal_orion_tpu(pair):
    jctx, tctx = pair[0], pair[4]
    assert tctx.slots == tctx.n == 1024 and tctx.lift_n == 2048
    assert (tctx.gal_mod, tctx.q_primes, tctx.p_primes) == (
        jctx.gal_mod, jctx.q_primes, jctx.p_primes)
    assert all(p % (4 * tctx.n) == 1 for p in tctx.primes)
    np.testing.assert_array_equal(tctx.ci_keep, jctx.ci_keep)
    np.testing.assert_array_equal(tctx.ci_src, jctx.ci_src)
    assert tctx.galois_element_conj() == jctx.galois_element_conj() == 1
    for rot in (1, 7, 100, tctx.slots - 1):
        k = tctx.galois_element(rot)
        assert k == jctx.galois_element(rot)
        np.testing.assert_array_equal(tctx.automorphism_perm(k),
                                      jctx.automorphism_perm(k))
    # the kernels' store map inverts ci_keep
    pos = tctx.ci.pos.numpy()
    assert (pos[tctx.ci_keep] == np.arange(tctx.n)).all()
    assert (pos >= 0).sum() == tctx.n


def test_ci_transforms_bit_exact(pair):
    jctx, tctx = pair[0], pair[4]
    a = _residues(tctx, (2, 3, tctx.n), seed=1)
    # host rings
    np.testing.assert_array_equal(tctx.host.ntt(a), jctx.host.ntt(a))
    np.testing.assert_array_equal(tctx.host.intt(a), jctx.host.intt(a))
    # orion_tpu's jnp transforms against the port's plain ones, and the
    # ring seam of the port's level tables (the plain path on the CPU)
    d = jctx.dev
    rows = jnp.arange(3)

    @jax.jit
    def jfwd(x):
        return jntt.ci_ntt(x, d["tw"][rows], d["tw_shoup"][rows],
                           d["p"][rows], d["ci_keep"])

    @jax.jit
    def jinv(x):
        return jntt.ci_intt(x, d["itw"][rows], d["itw_shoup"][rows],
                            d["ninv"][rows], d["ninv_shoup"][rows],
                            d["p"][rows], d["ci_src"], jctx.n)

    ja = jnp.asarray(a.astype(np.uint32))
    rr = tks.dev_level(tctx, 2).q
    ta = torch.as_tensor(a)
    want_f, want_i = jfwd(ja), jinv(ja)
    assert _same(want_f, tntt.ci_ntt(ta, rr.t4, rr.p, rr.ci))
    assert _same(want_i, tntt.ci_intt(ta, rr.t4, rr.ninv, rr.p, rr.ci))
    before = launch_counts()
    assert _same(want_f, tks.ring_ntt(ta, rr))
    assert _same(want_i, tks.ring_intt(ta, rr))
    assert launch_counts() == before
    np.testing.assert_array_equal(tks.ring_intt(tks.ring_ntt(ta, rr), rr), a)


def test_encode_encrypt_decrypt(pair):
    jctx, jenc, jkeys, _, tctx, tenc, tkeys, _ = pair
    rng = np.random.default_rng(2)
    v = rng.normal(size=tctx.slots)
    back = tenc.coeffs_to_slots(tenc.slots_to_coeffs(v))
    np.testing.assert_allclose(back.real, v, atol=1e-9)
    assert np.max(np.abs(back.imag)) < 1e-9       # CI slots are real
    np.testing.assert_array_equal(tenc.encode(v)[0], jenc.encode(v)[0])
    jct, tct = _encrypt(pair, v)
    assert _same_ct(jct, tct)
    dec = tenc.decode(tkeys.decrypt_rns(tct.data.numpy()), tct.scale)
    np.testing.assert_allclose(dec, v, atol=1e-3)


def test_ops_bit_exact(pair):
    jctx, jenc, jkeys, jev, tctx, tenc, tkeys, tev = pair
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, tctx.slots)
    b = rng.uniform(-1, 1, tctx.slots)
    (ja, ta), (jb, tb) = _encrypt(pair, a), _encrypt(pair, b)

    def dec(ct):
        return tenc.decode(tkeys.decrypt_rns(ct.data.numpy()), ct.scale)

    prod = tev.mul_relin(ta, tb)
    assert prod.level == tctx.max_level - 1
    assert _same_ct(jev.mul_relin(ja, jb), prod)
    np.testing.assert_allclose(dec(prod), a * b, atol=1e-3)

    # the rescale chain: two squarings, each rescaling through rescale_poly
    t4 = tev.square(tev.square(ta))
    assert _same_ct(jev.square(jev.square(ja)), t4)
    np.testing.assert_allclose(dec(t4), a ** 4, atol=5e-3)

    for r in (1, 7, 100, tctx.slots - 1):
        got = tev.rotate(ta, r)
        assert _same_ct(jev.rotate(ja, r), got), r
        np.testing.assert_allclose(dec(got), np.roll(a, -r), atol=1e-3)

    assert tev.conjugate(ta) is ta                # no key-switch on real slots
    assert jev.conjugate(ja) is ja


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_keyswitch_plain_equals_jnp(pair, level):
    """orion_tpu's jnp key-switch on the CI ring (its Pallas kernels refuse
    it) against the port's plain versions, level by level."""
    jctx, _, jkeys, _, tctx, _, tkeys, _ = pair
    jdl, tdl = jks.dev_level(jctx, level), tks.dev_level(tctx, level)
    assert tdl.dropdown is None and tdl.ci is not None
    c = _residues(tctx, (level + 1, tctx.n), seed=20 + level)
    jc, tc = jnp.asarray(c.astype(np.uint32)), torch.as_tensor(c)
    jext, text = jks.ks_decompose(jc, jdl), kks.ks_decompose_plain(tc, tdl)
    assert _same(jext, text)
    rk_j, rk_t = jkeys.relin_key, tkeys.relin_key
    assert _same(jks.ks_finish(jext, jdl, rk_j.data, rk_j.shoup),
                 kks.ks_finish_plain(text, tdl, rk_t.data, rk_t.shoup))
    if level == tctx.max_level:
        assert _same(jks.ks_finish_raw(jext, jdl, rk_j.data, rk_j.shoup),
                     kks.ks_inner(text, tdl, rk_t.data, rk_t.shoup))
    if level >= 1:
        two = _residues(tctx, (2, level + 1, tctx.n), seed=30 + level)
        assert _same(jks.rescale_poly(jnp.asarray(two.astype(np.uint32)),
                                      jdl),
                     tks.rescale_poly(torch.as_tensor(two), tdl))


def test_bootstrap_refused_on_ci():
    cfg = {"ckks_params": {"LogN": 10, "LogQ": [29] + [26] * 3,
                           "LogP": [29, 29], "LogScale": 26, "H": 64,
                           "RingType": "ConjugateInvariant"},
           "boot_params": {"LogP": [29]}}
    for parse in (jparse, tparse):
        with pytest.raises(NotImplementedError, match="ConjugateInvariant"):
            parse(cfg)
    del cfg["boot_params"]
    p = tparse(cfg)
    assert p.ring_type == "conjugate_invariant" and p.slots == 1024
