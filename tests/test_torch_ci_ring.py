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

A numpy model of the key-switch kernels' CI forms as the card runs them
(every row split over a cluster of 2^logc CTAs, each coefficient converted
once in the CTA whose slab holds it, its mirror in the 2n lift negated into
the buffer of the CTA that owns it; the inner products of a special row
gathered from the CTAs that hold them) must give the plain key-switch
residue for residue, with every coefficient converted exactly once; at the
card's own split of a 2^13 and 2^14 lift, its transforms on a narrow ring
must give the plain CI transforms.

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
from orion_tpu_torch.crypto.ntt4 import build_t4_tables
from orion_tpu_torch.crypto.primes import generate_primes, primitive_root_2n
from orion_tpu_torch.crypto.ref import PrimeRing, bit_reverse_indices
from orion_tpu_torch.kernels import keyswitch as kks
from orion_tpu_torch.kernels import launch_counts
from orion_tpu_torch.kernels.ntt import pack_twiddles, split_logc
from orion_tpu_torch.runtime.config import parse_config as tparse
from tests.test_torch_ring import _cluster_model

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


# ------------------------------------------------------------------ #
#  The cluster CI key-switch kernels, modelled in numpy              #
# ------------------------------------------------------------------ #

def _np(x):
    return x.detach().cpu().numpy()


def _fwd_lift_model(conv, packed, p, logc, pos, calls):
    """cluster_ntt.cuh `ntt_fwd_lift` over one row: the forward of the 2n
    antisymmetric lift of the n values conv(k), output g stored at CI slot
    pos[g].  CTA c converts the lower half of its slab's columns (inputs
    col + k M, k < C/2) and writes each negation into the mirror buffer of
    the CTA owning input N - g, slot (mk - C/2) W + mc % W; each CTA then
    reads its columns' upper halves from its own buffer.  With one CTA the
    lift is built whole.  conv is called once per CTA and value: `calls`
    counts the conversions of each coefficient.  Only outputs g < n are
    computed (sub-rows k < C/2): the CI ring keeps no other."""
    big = packed.shape[0]
    n, logn = big // 2, big.bit_length() - 1
    assert (pos[n:] < 0).all()
    c_n = 1 << logc
    m, h = big // c_n, c_n // 2
    w = m // c_n
    row = np.empty(big, np.int64)
    if logc == 0:
        k = np.arange(n)
        v = conv(k)
        np.add.at(calls, k, 1)
        row[:n], row[n] = v, 0
        row[big - k[1:]] = (p - v[1:]) % p
    else:
        lo = np.zeros((c_n, w, h), np.int64)      # registers, k < C/2
        mir = np.full((c_n, h * w), -1, np.int64)  # each CTA's buffer
        for c in range(c_n):
            col = c * w + np.arange(w)
            for k in range(h):
                g = col + k * m
                v = conv(g)
                np.add.at(calls, g, 1)
                lo[c, :, k] = v
                has = g > 0                         # input 0: no mirror
                gm = big - g[has]
                mc, mk = gm % m, gm // m
                slot = (mk - h) * w + mc % w
                assert (mir[mc // w, slot] == -1).all()  # written once
                mir[mc // w, slot] = (p - v[has]) % p
        assert mir[0, 0] == -1                      # input n: zero
        mir[0, 0] = 0
        assert (mir >= 0).all()
        for c in range(c_n):
            col = c * w + np.arange(w)
            for k in range(c_n):
                row[col + k * m] = (lo[c, :, k] if k < h
                                    else mir[c, (k - h) * w:(k - h + 1) * w])
    out = _cluster_model(row, packed, p, logn, logc, inverse=False)[:n]
    got = np.full(n, -1, np.int64)
    keep = pos[:n] >= 0
    got[pos[:n][keep]] = out[keep]
    assert (got >= 0).all()
    return got


def _keep_pos(j, logn):
    """modarith.cuh `ci_keep_pos(pow5_mod2n(j))`: the bit reversal of
    (5^j mod 2N - 1) / 2 over logn bits, N = 2^logn."""
    big = 1 << logn
    w = np.array([pow(5, int(x), 2 * big) for x in j], np.int64)
    x = (w - 1) // 2
    return np.array([int(format(int(v), f"0{logn}b")[::-1], 2) for v in x],
                    np.int64)


def _inv_gather_model(acc, packed, p, ninv, logc, src):
    """The CI inverse of `ks_inner_intt_ci` on a special row: CTA c holds
    slots [c SEG, (c + 1) SEG) of the n inner products and stores slot j
    at inputs keep(j) and N - 1 - keep(j) of the cluster's 2n inverse, in
    the CTA whose sub-row holds each; that must be where ci_src gathers it
    from.  With a cluster the slots are pushed by warps of 32 whose slots
    share j mod C/2: each warp's store must land in one CTA.  The first n
    outputs times (2n)^-1 are kept."""
    n = acc.shape[0]
    logn = (2 * n).bit_length() - 1
    m = (2 * n) >> logc
    seg = n >> logc
    h = max(1, (1 << logc) // 2)
    row = np.full(2 * n, -1, np.int64)       # CTA g // M holds input g
    for c in range(1 << logc):
        if logc == 0:
            order = np.arange(seg)
        else:                                # warp wv, lane: slot o
            v = np.arange(seg)
            wv, lane = v >> 5, v & 31
            order = (wv // h) * (32 * h) + lane * h + wv % h
            assert sorted(order) == list(range(seg))
        j = c * seg + order
        g = _keep_pos(j, logn)
        for pos in (g, 2 * n - 1 - g):
            if logc:
                assert (np.ptp((pos // m).reshape(-1, 32), axis=1) == 0).all()
            assert (row[pos] == -1).all()           # stored once
            assert (src[pos] == j).all()            # as ci_src reads it
            row[pos] = acc[j]
    assert (row >= 0).all()
    out = _cluster_model(row, packed, p, logn, logc, inverse=True)
    return out[:n] * ninv % p


def _fbc_one(z, dg, t, pt):
    """fbc_one of modarith.cuh onto row t (prime pt) of a DevDigit's
    targets, over coefficients z (alpha, K): the float32 v-correction
    summed in source order and rounded to nearest even."""
    qi, sp = _np(dg.qhat_inv)[:, 0], _np(dg.src_p)[:, 0]
    sq = _np(dg.src_q_f32)[:, 0]
    cv, dm = _np(dg.conv)[:, t, 0], int(_np(dg.d_mod_t)[t, 0])
    frac = np.zeros(z.shape[1], np.float32)
    acc = np.zeros(z.shape[1], np.int64)
    for m in range(z.shape[0]):
        zq = z[m] * qi[m] % sp[m]
        frac = frac + zq.astype(np.float32) / sq[m]
        acc = (acc + zq * cv[m] % pt) % pt
    v = np.rint(frac).astype(np.int64)
    return (acc - v * dm % pt) % pt


def _ks_cluster_model(c, dl, key, logc):
    """ks_decompose then ks_finish of one poly c (nl, n) with a full-chain
    key, as the CI kernels compute them over clusters of 2^logc CTAs.
    Returns (ext, out, calls): calls[row, k] counts the conversions of
    coefficient k for each forward row (digit and target, then poly and
    Q row)."""
    t, ci = dl.t, dl.ci
    p = _np(t.p)
    twc = _np(pack_twiddles(t.tw, t.tw_shoup, logc))
    itwc = _np(pack_twiddles(t.itw, t.itw_shoup, logc))
    ninv, src, pos = _np(t.ninv), _np(ci.src), _np(ci.pos)
    nl, n_t, n = dl.level + 1, p.shape[0], dl.ring_n
    # launch A: each Q row's inverse, gathered through src from memory
    coeff = np.stack([
        _cluster_model(c[i][src], itwc[i], p[i], (2 * n).bit_length() - 1,
                       logc, inverse=True)[:n] * ninv[i] % p[i]
        for i in range(nl)])
    calls = []
    ext = np.empty((len(dl.digits), n_t, n), np.int64)
    for d, dg in enumerate(dl.digits):
        z = coeff[dg.src_lo:dg.src_hi]
        for r in range(n_t):
            calls.append(np.zeros(n, np.int64))
            ext[d, r] = _fwd_lift_model(
                lambda k: _fbc_one(z[:, k], dg, r, p[r]), twc[r], p[r],
                logc, pos, calls[-1])
    # ks_finish: the inner product, the special rows' gathered inverse,
    # then ModDown onto each Q row
    rows = _np(dl.ksk_rows_idx)
    key = _np(key)
    pinv = _np(dl.pinv_mod_q)[:, 0]
    out = np.empty((2, nl, n), np.int64)
    for q in range(2):
        acc = np.zeros((n_t, n), np.int64)
        for j in range(len(dl.digits)):
            acc = (acc + ext[j] * key[j, q][rows] % p[:, None]) % p[:, None]
        sp = np.stack([_inv_gather_model(acc[r], itwc[r], p[r], ninv[r],
                                         logc, src)
                       for r in range(nl, n_t)])
        for i in range(nl):
            calls.append(np.zeros(n, np.int64))
            lift = _fwd_lift_model(
                lambda k: _fbc_one(sp[:, k], dl.moddown, i, p[i]), twc[i],
                p[i], logc, pos, calls[-1])
            out[q, i] = (acc[i] - lift) % p[i] * pinv[i] % p[i]
    return ext, out, np.stack(calls)


@pytest.mark.parametrize("logc", [0, 1, 2, 3])
def test_ci_keyswitch_cluster_model(pair, logc):
    """The CI key-switch kernels' maps, modelled at 1, 2, 4 and 8 CTAs per
    row of the 2^11 lift (the card splits it over 2: split_logc(11)), give
    the plain ks_decompose and ks_finish residue for residue, converting
    each coefficient once per row; the plain path equals orion_tpu's
    jitted jnp key-switch on the same input."""
    jctx, _, jkeys, _, tctx, _, tkeys, _ = pair
    level = tctx.max_level
    tdl, jdl = tks.dev_level(tctx, level), jks.dev_level(jctx, level)
    c = _residues(tctx, (level + 1, tctx.n), seed=40 + logc)
    rk = tkeys.relin_key
    ext, out, calls = _ks_cluster_model(c, tdl, rk.data, logc)
    assert (calls == 1).all()
    text = kks.ks_decompose_plain(torch.as_tensor(c), tdl)
    tout = kks.ks_finish_plain(text, tdl, rk.data, rk.shoup)
    np.testing.assert_array_equal(ext, text.numpy())
    np.testing.assert_array_equal(out, tout.numpy())
    jext = jks.ks_decompose(jnp.asarray(c.astype(np.uint32)), jdl)
    assert _same(jext, text)
    assert _same(jks.ks_finish(jext, jdl, jkeys.relin_key.data,
                               jkeys.relin_key.shoup), tout)


def _ci_maps(logn):
    """keep, src and pos of a CI ring whose lift has 2^logn points, as
    the port's context builds them (crypto/context.py)."""
    big = 1 << logn
    gal = 2 * big
    brev = bit_reverse_indices(big)
    rot = np.array([pow(5, j, gal) for j in range(big // 2)], np.int64)
    slot = {int(e): j for j, e in enumerate(rot)}
    exps = (2 * brev + 1) % gal
    src = np.array([slot.get(int(e), slot.get(gal - int(e), -1))
                    for e in exps], np.int64)
    keep = brev[(rot - 1) // 2]
    pos = np.full(big, -1, np.int64)
    pos[keep] = np.arange(big // 2)
    return keep, src, pos


@pytest.mark.parametrize("logn", [13, 14])
def test_ci_lift_maps_at_the_card_split(logn):
    """At the card's own split of a 2^13 and a 2^14 lift (8 CTAs per row),
    on a narrow ring of two primes: the lift model converting each value
    once and the gathered inverse give the plain CI transforms."""
    big = 1 << logn
    primes = generate_primes([29, 26], 2 * big)
    rings = [PrimeRing(q, big, primitive_root_2n(q, 2 * big))
             for q in primes]
    tw = np.stack([r.tw for r in rings]).astype(np.int64)
    itw = np.stack([r.itw for r in rings]).astype(np.int64)
    pcol = np.asarray(primes, np.int64)[:, None]
    t4 = {k: torch.as_tensor(v.astype(np.int64)) for k, v in build_t4_tables(
        tw.astype(np.uint32), itw.astype(np.uint32),
        [r.psi for r in rings], primes, logn).items()}
    keep, src, pos = _ci_maps(logn)
    ci = tntt.CIMap(big // 2, torch.as_tensor(keep), torch.as_tensor(src),
                    torch.as_tensor(pos))
    logc = split_logc(logn)
    assert logc == 3
    twc = _np(pack_twiddles(torch.as_tensor(tw),
                            torch.as_tensor((tw << 32) // pcol), logc))
    itwc = _np(pack_twiddles(torch.as_tensor(itw),
                             torch.as_tensor((itw << 32) // pcol), logc))
    rng = np.random.default_rng(logn)
    a = rng.integers(0, 1 << 62, (2, big // 2), dtype=np.int64) % pcol
    p_t = torch.as_tensor(pcol[:, 0])
    ninv = [r.ninv for r in rings]
    want_f = tntt.ci_ntt(torch.as_tensor(a), t4, p_t, ci).numpy()
    want_i = tntt.ci_intt(torch.as_tensor(a), t4,
                          torch.as_tensor(np.asarray(ninv, np.int64)), p_t,
                          ci).numpy()
    for r, q in enumerate(primes):
        calls = np.zeros(big // 2, np.int64)
        got = _fwd_lift_model(lambda k: a[r][k], twc[r], q, logc, pos,
                              calls)
        assert (calls == 1).all()
        np.testing.assert_array_equal(got, want_f[r])
        np.testing.assert_array_equal(
            _inv_gather_model(a[r], itwc[r], q, ninv[r], logc, src),
            want_i[r])
