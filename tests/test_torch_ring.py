"""Ring core of the PyTorch port against orion_tpu: modular arithmetic, the
four-step NTT, the ring_ntt / ring_intt seam and the context's tables.

Both packages get the same random residues (numpy seed) for the primes of
configs/mlp.yml generated at LogN 8 and 10; integer arithmetic is exact, so
every comparison is bit-exact.  On CPU tensors the port's seam runs the
plain PyTorch version of its kernels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orion_tpu.crypto import modops as jmod
from orion_tpu.crypto import ntt4 as jntt4
from orion_tpu.crypto.context import CKKSContext as JContext
from orion_tpu.crypto.keyswitch import dev_level as jdev_level
from orion_tpu.crypto.keyswitch import ring_intt as jring_intt
from orion_tpu.crypto.keyswitch import ring_ntt as jring_ntt
from orion_tpu_torch import native
from orion_tpu_torch.crypto import modops as tmod
from orion_tpu_torch.crypto.context import CKKSContext as TContext
from orion_tpu_torch.crypto.keyswitch import dev_level as tdev_level
from orion_tpu_torch.crypto.keyswitch import ring_intt, ring_ntt
from orion_tpu_torch.crypto.ntt4 import build_t4_tables, intt4, ntt4
from orion_tpu_torch.crypto.primes import generate_primes, primitive_root_2n
from orion_tpu_torch.crypto.ref import PrimeRing
from orion_tpu_torch.kernels import launch_counts
from orion_tpu_torch.kernels.ntt import _passes, pack_twiddles, split_logc

LOGQ = [29, 26, 26, 26, 26, 26]   # configs/mlp.yml
LOGP = [29, 29]


def _contexts(logn):
    kw = dict(logn=logn, logq=LOGQ, logp=LOGP, logscale=26, h=64, seed=5)
    return JContext(**kw), TContext(**kw, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _unoptimised_xla():
    """orion_tpu's transforms compile without most XLA optimizations here
    (less compile time; integer ops give the same bits)."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module", params=[8, 10])
def ctxs(request):
    return _contexts(request.param)


def _residues(rng, shape, primes):
    p = np.asarray(primes, np.int64).reshape(-1, 1)
    return rng.integers(0, 1 << 62, size=shape, dtype=np.int64) % p


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


def _same(jx, tx):
    return np.array_equal(np.asarray(jx).astype(np.int64), tx.numpy())


def test_modops_bit_exact(ctxs):
    jctx, tctx = ctxs
    rng = np.random.default_rng(0)
    primes = tctx.primes
    n = 4096
    a = _residues(rng, (len(primes), n), primes)
    b = _residues(rng, (len(primes), n), primes)
    p = np.asarray(primes, np.int64)[:, None]
    pinv = np.asarray(tctx.dev["pinv"])[:, None]
    rmod = np.asarray(tctx.dev["r_mod"])[:, None]
    rsh = np.asarray(tctx.dev["r_shoup"])[:, None]
    b_sh = np.stack([(b[i].astype(object) << 32) // primes[i]
                     for i in range(len(primes))]).astype(np.int64)
    J = dict(a=_j(a), b=_j(b), p=_j(p), pinv=_j(pinv), rm=_j(rmod),
             rs=_j(rsh), bsh=_j(b_sh))
    T = dict(a=_t(a), b=_t(b), p=_t(p), pinv=_t(pinv), rm=_t(rmod),
             rs=_t(rsh), bsh=_t(b_sh))
    cases = {
        "add": lambda m, d: m.add_mod(d["a"], d["b"], d["p"]),
        "sub": lambda m, d: m.sub_mod(d["a"], d["b"], d["p"]),
        "neg": lambda m, d: m.neg_mod(d["a"], d["p"]),
        "shoup": lambda m, d: m.shoup_mul(d["a"], d["b"], d["bsh"], d["p"]),
        "mont": lambda m, d: m.mont_mul(d["a"], d["b"], d["p"], d["pinv"]),
        "to_mont": lambda m, d: m.to_mont(d["a"], d["rm"], d["rs"], d["p"]),
        "mul_mod": lambda m, d: m.mul_mod(d["a"], d["b"], d["p"], d["pinv"],
                                          d["rm"], d["rs"]),
    }
    for name, fn in cases.items():
        assert _same(fn(jmod, J), fn(tmod, T)), name


def test_context_tables_equal(ctxs):
    jctx, tctx = ctxs
    assert jctx.primes == tctx.primes and jctx.psis == tctx.psis
    for k in ("p", "pinv", "tw", "tw_shoup", "itw", "itw_shoup", "r_mod",
              "r_shoup", "ninv", "ninv_shoup"):
        assert _same(jctx.dev[k], tctx.dev[k]), k
    for level in range(jctx.n_q):
        jl, tl = jctx.ks_tables[level], tctx.ks_tables[level]
        for dj, dt in zip(jl.digits + [jl.moddown], tl.digits + [tl.moddown]):
            assert dj.src_idx == dt.src_idx
            for f in ("qhat_inv", "conv", "d_mod_t", "src_q"):
                assert np.array_equal(getattr(dj, f), getattr(dt, f)), f
    for k in (5, 25, 2 * jctx.n - 1):
        assert np.array_equal(jctx.automorphism_perm(k),
                              tctx.automorphism_perm(k))
        assert jctx.galois_element(k) == tctx.galois_element(k)


def test_ntt4_bit_exact(ctxs):
    jctx, tctx = ctxs
    rng = np.random.default_rng(1)
    a = _residues(rng, (2, tctx.n_all, tctx.n), tctx.primes)
    jt4 = {k[3:]: jctx.dev[k] for k in jctx.t4_keys}
    tt4 = {k[3:]: tctx.dev[k] for k in tctx.t4_keys}
    # jitted: eager jnp would compile every stage's ops one by one
    jf = jax.jit(jntt4.ntt4)(_j(a), jt4, jctx.dev["p"])
    tf = ntt4(_t(a), tt4, tctx.dev["p"])
    assert _same(jf, tf)
    ji = jax.jit(jntt4.intt4)(jf, jt4, jctx.dev["ninv"],
                              jctx.dev["ninv_shoup"], jctx.dev["p"])
    ti = intt4(tf, tt4, tctx.dev["ninv"], tctx.dev["p"])
    assert _same(ji, ti)
    assert np.array_equal(ti.numpy(), a)


@pytest.mark.parametrize("level", [0, 5])
def test_ring_seam_bit_exact(ctxs, level):
    """ring_ntt / ring_intt on the level's Q rows and on its extended rows,
    against orion_tpu's dispatch on the CPU (the jnp four-step path)."""
    jctx, tctx = ctxs
    jdl, tdl = jdev_level(jctx, level), tdev_level(tctx, level)
    rng = np.random.default_rng(2 + level)
    before = launch_counts()
    for rows, rr, jt in (
            (list(range(level + 1)), tdl.q,
             (jdl.q_tw, jdl.q_tw_shoup, jdl.q_itw, jdl.q_itw_shoup,
              jdl.q_ninv, jdl.q_ninv_shoup, jdl.q_p, jdl.q_t4)),
            (list(jdl.ksk_rows), tdl.t,
             (jdl.t_tw, jdl.t_tw_shoup, None, None, None, None, jdl.t_p,
              jdl.t_t4))):
        primes = [tctx.primes[i] for i in rows]
        a = _residues(rng, (2, len(rows), tctx.n), primes)
        jf = jax.jit(lambda x: jring_ntt(x, jt[0], jt[1], jt[6], jdl,
                                         jt[7]))(_j(a))
        tf = ring_ntt(_t(a), rr)
        assert _same(jf, tf)
        if jt[2] is not None:
            ji = jax.jit(lambda x: jring_intt(x, *jt[2:7], jdl, jt[7]))(
                _j(a))
            assert _same(ji, ring_intt(_t(a), rr))
        assert np.array_equal(ring_intt(tf, rr).numpy(), a)
    # CPU tensors take the plain path: no kernel was launched
    assert launch_counts() == before


def _core_model(x, packed, p, logn, inverse):
    """The CUDA transform core's pass structure (kernels/csrc/modarith.cuh)
    in numpy: per pass over stages [a, a+s), groups of 2^s residues at
    stride 2^(logn-a-s), butterflied with twiddles read from the packed
    table at the core's offsets."""
    x = x.copy()
    w_all, w_sh_all = packed & 0xFFFFFFFF, (packed >> 32) & 0xFFFFFFFF
    assert np.array_equal(w_sh_all, (w_all << 32) // p)  # Shoup companions
    order = _passes(logn)[::-1] if inverse else _passes(logn)
    for a, s in order:
        g = 1 << (logn - a - s)
        hi = np.arange(1 << a)[:, None, None]
        idx = (hi << (logn - a)) + np.arange(g)[None, :, None] \
            + (np.arange(1 << s) * g)[None, None, :]
        r = x[idx]
        for u in (range(s - 1, -1, -1) if inverse else range(s)):
            hs = 1 << (s - 1 - u)
            for j in range(1 << s):
                if j & hs:
                    continue
                w = w_all[(1 << a) + hi[:, :, 0] * ((1 << s) - 1)
                          + (1 << u) - 1 + (j >> (s - u))]
                lo_, hi_ = r[..., j].copy(), r[..., j + hs].copy()
                if inverse:
                    r[..., j] = (lo_ + hi_) % p
                    r[..., j + hs] = (lo_ - hi_) % p * w % p
                else:
                    v = hi_ * w % p
                    r[..., j] = (lo_ + v) % p
                    r[..., j + hs] = (lo_ - v) % p
        x[idx] = r
    return x


def _cluster_model(x, packed, p, logn, logc, inverse):
    """The cluster transform (kernels/csrc/cluster_ntt.cuh) in numpy: the
    row as 2^logc sub-rows of M; the forward runs the first logc stages on
    the columns (values i + k*M) with the cross twiddles at slots k*M, then
    each sub-row k through the core model with its segment of the packed
    table; the inverse runs the sub-rows first, then the columns."""
    if logc == 0:
        return _core_model(x, packed, p, logn, inverse)
    c, m = 1 << logc, 1 << (logn - logc)
    w_all = packed & 0xFFFFFFFF
    x = x.copy().reshape(c, m)

    def cross(stages):
        for st in stages:
            hs = c >> (st + 1)
            for k in range(c):
                if k & hs:
                    continue
                w = w_all[((1 << st) + (k >> (logc - st))) * m]
                a, b = x[k].copy(), x[k + hs].copy()
                if inverse:
                    x[k], x[k + hs] = (a + b) % p, (a - b) % p * w % p
                else:
                    v = b * w % p
                    x[k], x[k + hs] = (a + v) % p, (a - v) % p

    if not inverse:
        cross(range(logc))
    for k in range(c):
        x[k] = _core_model(x[k], packed[k * m:(k + 1) * m], p, logn - logc,
                           inverse)
    if inverse:
        cross(range(logc - 1, -1, -1))
    return x.reshape(-1)


def _check_packed(tw, tw_sh, itw, itw_sh, ninv, primes, t4, logn, logcs):
    """Each split's packed tables, walked in the cluster's order, give
    ntt4's forward and inverse residue for residue."""
    rng = np.random.default_rng(4 + logn)
    a = _residues(rng, (len(primes), 1 << logn), primes)
    want = ntt4(_t(a), t4, _t(primes)).numpy()
    for logc in logcs:
        twp = pack_twiddles(tw, tw_sh, logc).numpy()
        itwp = pack_twiddles(itw, itw_sh, logc).numpy()
        for r, p in enumerate(primes):
            got = _cluster_model(a[r], twp[r], p, logn, logc, inverse=False)
            assert np.array_equal(got, want[r]), logc
            back = _cluster_model(got, itwp[r], p, logn, logc, inverse=True)
            assert np.array_equal(back * int(ninv[r]) % p, a[r]), logc


def test_packed_twiddles_drive_the_core_model(ctxs):
    """The packed tables the kernels read, walked in the CUDA core's pass
    order, give ntt4's forward and inverse transforms residue for residue
    (before the inverse's n^-1 scale); so do the tables of a row split
    over 2, 4 and 8 CTAs, walked in the cluster's order."""
    _, tctx = ctxs
    d = tctx.dev
    rows = [0, tctx.n_all - 1]
    t4 = {k[3:]: d[k][rows] for k in tctx.t4_keys}
    _check_packed(d["tw"][rows], d["tw_shoup"][rows], d["itw"][rows],
                  d["itw_shoup"][rows], d["ninv"][rows].numpy(),
                  [tctx.primes[i] for i in rows], t4, tctx.logn,
                  (0, 1, 2, 3))


@pytest.mark.parametrize("logn", [8, 9, 13, 14])
def test_cluster_twiddles_drive_the_cluster_model(logn):
    """At the ring sizes of the tests and of the card (LogN 13, 14: 8 CTAs
    per row), the tables packed for the kernels' own split, walked in the
    cluster's order, give ntt4's transforms for two primes."""
    n = 1 << logn
    primes = generate_primes([29, 26], 2 * n)
    rings = [PrimeRing(p, n, primitive_root_2n(p, 2 * n)) for p in primes]
    tw = np.stack([r.tw for r in rings]).astype(np.uint32)
    itw = np.stack([r.itw for r in rings]).astype(np.uint32)
    t4 = {k: _t(v) for k, v in build_t4_tables(
        tw, itw, [r.psi for r in rings], primes, logn).items()}
    p = np.asarray(primes, np.int64)[:, None]
    tw64, itw64 = tw.astype(np.int64), itw.astype(np.int64)
    logcs = (split_logc(logn),) if logn > 10 else (0, 1, 2, 3)
    _check_packed(_t(tw64), _t((tw64 << 32) // p), _t(itw64),
                  _t((itw64 << 32) // p), [r.ninv for r in rings], primes,
                  t4, logn, logcs)


def test_host_ntt_native_matches_numpy(monkeypatch):
    """The host NTT gives the same bits through the g++ kernel and through
    its numpy fallback."""
    _, tctx = _contexts(9)
    rng = np.random.default_rng(3)
    a = _residues(rng, (3, tctx.n_all, tctx.n), tctx.primes)
    fast = tctx.host.ntt(a.copy())
    back = tctx.host.intt(fast.copy())
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert np.array_equal(tctx.host.ntt(a.copy()), fast)
    assert np.array_equal(tctx.host.intt(fast.copy()), back)
    assert np.array_equal(back, a)
