"""The standard ring's key-switch kernels hoist the digit-invariant half of
every fast basis conversion (orion_tpu_torch/kernels/csrc/hoist.cuh): each
source coefficient's zq = z * qhat_inv mod q is stored once as uint32,
each (digit, coefficient)'s v = round(sum_m f32(zq_m) / f32(q_m)) once as
one byte, and the loops over the target rows read them.  The CUDA kernels
run only on the card; this file models them in numpy on the CPU, walking
their grids and byte layouts as the sources do, and holds the model bit
for bit against orion_tpu's `fbc` (jitted) and the port's plain `fbc`:

  - ks_decompose.cu: launch A (`ntt_inv_zq`, one thread-block cluster per
    (Q row, poly), CTA c of the split inverse storing outputs k M + c W +
    col, its store giving zq through the folded constant n^-1 qhat_inv)
    into the coefficient scratch, the pass `hoist_digits` (one thread per
    (coefficient, digit, poly), v from the digit's zq in source order),
    then launch B's target half (`fbc_ntt_digits`);
  - ks_finish.cu: launch A's grid (`ks_inner_intt`, the special rows' zq
    in the special rows' part of the work buffer), `hoist_digits` over the
    special rows (v behind their zq), then `moddown_rows`' target half onto
    the Q rows;
  - the limb-sharded entries' pass (`hoist_digits` from int64
    coefficients, zq included) into the scratch the wrappers leave behind
    their outputs (`hoist_bytes`), which must hold the bytes the unsharded
    layout holds.

The model asserts that v <= alpha and that every zq and every v is written
exactly once, within the scratch, and that the wrappers' folded constants
give zq.  Levels: configs/mlp.yml 0-5, configs/lenet.yml 7 (4 digits),
configs/resnet.yml 1, 17 and 43 (alpha 6, up to 8 digits, an unequal last
digit), at the configs' LogN 13.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from orion_tpu.crypto import keyswitch as jks
from orion_tpu.crypto.context import CKKSContext as JContext
from orion_tpu_torch.crypto import keyswitch as tks
from orion_tpu_torch.crypto.context import CKKSContext as TContext
from orion_tpu_torch.kernels import keyswitch as kks
from orion_tpu_torch.runtime.config import parse_config

CONFIGS = Path(__file__).parent.parent / "configs"
CASES = ([("mlp", lv) for lv in range(6)] + [("lenet", 7)]
         + [("resnet", lv) for lv in (1, 17, 43)])
HOIST_T = 256    # hoist.cuh: threads per block of hoist_digits
POLYS = 2        # polys per ks_decompose call in the model


@pytest.fixture(scope="module", autouse=True)
def _unoptimised_xla():
    """orion_tpu's fbc compiles without most XLA optimizations here:
    integer and IEEE float32 ops give the same bits."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


_CTX = {}


def _contexts(tag):
    """(orion_tpu context, port context on the CPU) of a config."""
    if tag not in _CTX:
        with open(CONFIGS / f"{tag}.yml") as f:
            p = parse_config(yaml.safe_load(f))
        kw = dict(logn=p.logn, logq=p.split_logq, logp=p.logp,
                  logscale=p.logscale, h=p.h, seed=p.seed)
        _CTX[tag] = JContext(**kw), TContext(**kw, device="cpu")
    return _CTX[tag]


_JFBC = jax.jit(jks.fbc)


class Scratch:
    """A device buffer of `nbytes`, with a count of the writes to each
    byte."""

    def __init__(self, nbytes):
        self.buf = np.zeros(nbytes, np.uint8)
        self.writes = np.zeros(nbytes, np.int32)

    def put(self, off, vals):
        raw = np.ascontiguousarray(vals).view(np.uint8)
        assert 0 <= off and off + raw.size <= self.buf.size
        self.buf[off:off + raw.size] = raw
        self.writes[off:off + raw.size] += 1

    def u32(self, off, count):
        return self.buf[off:off + 4 * count].view(np.uint32).astype(np.int64)

    def u8(self, off, count):
        return self.buf[off:off + count].astype(np.int64)


def _tables(dg):
    """A port DevDigit's conversion tables as numpy."""
    return dict(qi=dg.qhat_inv[:, 0].numpy(), sp=dg.src_p[:, 0].numpy(),
                sq=dg.src_q_f32[:, 0].numpy(), conv=dg.conv[:, :, 0].numpy(),
                dmod=dg.d_mod_t[:, 0].numpy())


def _zq(z, tb, m):
    """Row m's zq (uint32) and float32 quotients (fbc_quot)."""
    zq = (z * tb["qi"][m] % tb["sp"][m]).astype(np.uint32)
    return zq, zq.astype(np.float32) / np.float32(tb["sq"][m])


def _target(zq, v, tb, pt):
    """fbc_target onto the target primes pt (n_t,): sum_m zq_m conv_m -
    v dmod mod pt, from zq (alpha, n) and v (n,)."""
    pt = pt[:, None]
    acc = np.zeros((pt.shape[0], zq.shape[1]), np.int64)
    for m in range(zq.shape[0]):
        acc = (acc + zq[m][None] * tb["conv"][m][:, None] % pt) % pt
    return (acc - v[None] * tb["dmod"][:, None] % pt) % pt


def hoist_digits_model(sc, zq_base, v_base, polys, n, zq_poly, v_poly,
                       tbs, lo, alpha, src=None, src_poly=0):
    """hoist_digits over grid (n / HOIST_T, digits, polys) on scratch sc:
    thread c of block (x, d, b) takes digit d's rows r = lo_d.. of poly b,
    zq at byte zq_base + 4 * (b * zq_poly + r * n + c), stored first from
    src (flat int64, row r of poly b at b * src_poly + r * n) when given,
    read otherwise; v at byte v_base + b * v_poly + d * n + c."""
    assert n % HOIST_T == 0
    for b in range(polys):
        for d, tb in enumerate(tbs):
            frac = np.zeros(n, np.float32)
            for m in range(alpha[d]):
                r = lo[d] + m
                at = zq_base + 4 * (b * zq_poly + r * n)
                if src is None:
                    zq = sc.u32(at, n).astype(np.uint32)
                else:
                    z = src[b * src_poly + r * n:b * src_poly + (r + 1) * n]
                    zq = _zq(z, tb, m)[0]
                    sc.put(at, zq)
                frac = frac + zq.astype(np.float32) / np.float32(tb["sq"][m])
            v = np.rint(frac)
            assert v.max() <= alpha[d]
            sc.put(v_base + b * v_poly + d * n, v.astype(np.uint8))


def decompose_model(coeff, tdl):
    """ks_decompose.cu's conversion of coeff (B, nl, n), coefficients of
    the Q rows: launch A into the coefficient scratch, the pass, launch
    B's target half.  Returns the converted digits (B, dnum, n_t, n)
    before their forward NTT and the scratch."""
    b_, nl, n = coeff.shape
    tbs = [_tables(dg) for dg in tdl.digits]
    lo = [dg.src_lo for dg in tdl.digits]
    alpha = [dg.src_hi - dg.src_lo for dg in tdl.digits]
    dnum, amax = len(tbs), max(alpha)
    assert amax <= kks.MAX_ALPHA
    assert lo == [sum(alpha[:d]) for d in range(dnum)] and sum(alpha) == nl
    t_p = tdl.t.p.numpy()
    sc = Scratch(8 * b_ * nl * n)           # the (B, nl, n) int64 scratch
    v_base = 4 * b_ * nl * n
    # launch A: cluster (row, b) of C CTAs (cluster_ntt.cuh Split): CTA c
    # stores outputs k * M + c * W + col, col < W = M / C, k < C
    logc = kks.split_logc(n.bit_length() - 1)
    c_, m_ = 1 << logc, n >> logc
    w_ = m_ // c_ if c_ > 1 else n
    digit_of = [(d, m) for d in range(dnum) for m in range(alpha[d])]
    for b in range(b_):
        for row in range(nl):
            d, m = digit_of[row]
            assert tbs[d]["sp"][m] == t_p[row]   # the kernel's modulus
            zq = _zq(coeff[b, row], tbs[d], m)[0]
            base = 4 * (b * nl + row) * n
            for cta in range(c_):
                for k in range(c_ if c_ > 1 else 1):
                    at = k * m_ + cta * w_ if c_ > 1 else 0
                    sc.put(base + 4 * at, zq[at:at + w_])
    # the pass, from the stored zq
    hoist_digits_model(sc, 0, v_base, b_, n, nl * n, dnum * n, tbs, lo,
                       alpha)
    used = kks.hoist_bytes(b_, nl, dnum, n)
    assert used == v_base + b_ * dnum * n <= sc.buf.size
    assert (sc.writes[:used] == 1).all() and not sc.writes[used:].any()
    # launch B: block (t, d, b), all t at once
    out = np.empty((b_, dnum, t_p.shape[0], n), np.int64)
    for b in range(b_):
        for d in range(dnum):
            zq = np.stack([sc.u32(4 * (b * nl + lo[d] + m) * n, n)
                           for m in range(alpha[d])])
            out[b, d] = _target(zq, sc.u8(v_base + (b * dnum + d) * n, n),
                                tbs[d], t_p)
    return out, sc


def moddown_model(work_sp, tdl):
    """ks_finish.cu's ModDown conversion of the special rows work_sp (P,
    n_sp, n), coefficients, of P = 2K polys: launch A's grid (n_t, P) into
    the work buffer (P, n_t, n), the pass over the special rows, launch B's
    target half onto the Q rows.  Returns (P, nl, n) and the special rows'
    part of each poly's work buffer."""
    polys, n_sp, n = work_sp.shape
    nl = tdl.level + 1
    n_t = nl + n_sp
    assert n_sp <= kks.MAX_ALPHA
    tb = _tables(tdl.moddown)
    assert (tb["sp"] == tdl.t.p.numpy()[nl:]).all()
    sc = Scratch(8 * polys * n_t * n)       # work (K, 2, n_t, n) int64
    zq_base = 8 * nl * n                    # poly 0's special rows
    for k in range(polys):
        for t in range(n_t):
            if t < nl:                      # a Q row, int64 as it is
                sc.put(8 * (k * n_t + t) * n, np.zeros(n, np.int64))
            else:                           # a special row's zq
                m = t - nl
                sc.put(zq_base + 4 * (2 * k * n_t * n + m * n),
                       _zq(work_sp[k, m], tb, m)[0])
    v_base = zq_base + 4 * n_sp * n
    hoist_digits_model(sc, zq_base, v_base, polys, n, 2 * n_t * n,
                       8 * n_t * n, [tb], [0], [n_sp])
    assert (sc.writes <= 1).all()
    out, regions = [], []
    used = 4 * n_sp * n + n
    assert used <= 8 * n_sp * n
    for k in range(polys):
        at = 8 * (k * n_t + nl) * n
        region = sc.writes[at:at + 8 * n_sp * n]
        assert (region[:used] == 1).all() and not region[used:].any()
        zq = np.stack([sc.u32(at + 4 * m * n, n) for m in range(n_sp)])
        out.append(_target(zq, sc.u8(at + 4 * n_sp * n, n), tb,
                           tdl.q.p.numpy()))
        regions.append(sc.buf[at:at + used].copy())
    return np.stack(out), regions


def _residues(rng, shape, p):
    return rng.integers(0, 1 << 62, shape, dtype=np.int64) % p[:, None]


@pytest.mark.parametrize("tag,level", CASES)
def test_hoisted_decompose_equals_fbc(tag, level):
    """ks_decompose's hoisted conversion, its cluster map and the sharded
    prologue's scratch, against orion_tpu's jitted fbc and the port's
    plain fbc for every digit of two polys."""
    jctx, tctx = _contexts(tag)
    jdl, tdl = jks.dev_level(jctx, level), tks.dev_level(tctx, level)
    nl, n = level + 1, tctx.n
    rng = np.random.default_rng(100 + level)
    coeff = np.stack([_residues(rng, (nl, n), tdl.q.p.numpy())
                      for _ in range(POLYS)])
    got, sc = decompose_model(coeff, tdl)
    jt = jdl.t_p[:, None]
    for b in range(POLYS):
        for d, (jdg, tdg) in enumerate(zip(jdl.digits, tdl.digits)):
            z = coeff[b, tdg.src_lo:tdg.src_hi]
            want = np.asarray(_JFBC(z.astype(np.uint32), jdg, jt))
            assert np.array_equal(want.astype(np.int64), got[b, d])
            plain = kks.fbc(torch.from_numpy(z), tdg, tdl.t.p[:, None])
            assert np.array_equal(plain.numpy(), got[b, d])
    # orion_ks_convert's pass over the same coefficients, zq included,
    # into the scratch behind ext: the same bytes
    dnum = len(tdl.digits)
    pro = Scratch(kks.hoist_bytes(POLYS, nl, dnum, n))
    hoist_digits_model(pro, 0, 4 * POLYS * nl * n, POLYS, n, nl * n,
                       dnum * n, [_tables(dg) for dg in tdl.digits],
                       [dg.src_lo for dg in tdl.digits],
                       [dg.src_hi - dg.src_lo for dg in tdl.digits],
                       src=coeff.reshape(-1), src_poly=nl * n)
    assert (pro.writes == 1).all()
    assert np.array_equal(pro.buf, sc.buf[:pro.buf.size])
    # the wrapper's launch A constants give zq: x * zs = (x * n^-1) * qhat_inv
    d = kks._digit_stack(tdl)
    p = tdl.q.p.numpy()
    x = _residues(rng, (nl, 64), p)
    ninv = tdl.t.ninv.numpy()[:nl, None]
    qi = np.concatenate([_tables(dg)["qi"] for dg in tdl.digits])[:, None]
    assert np.array_equal(x * d["zs"].numpy()[:, None] % p[:, None],
                          (x * ninv % p[:, None]) * qi % p[:, None])
    assert np.array_equal(d["zs_sh"].numpy(),
                          (d["zs"].numpy() << 32) // p)


@pytest.mark.parametrize("tag,level", CASES)
def test_hoisted_moddown_equals_fbc(tag, level):
    """ModDown's hoisted conversion of the special rows onto the Q rows
    (ks_finish's launch A clusters, moddown_rows' target half) and the
    sharded prologue's, against orion_tpu's jitted fbc and the port's
    plain fbc."""
    jctx, tctx = _contexts(tag)
    jdl, tdl = jks.dev_level(jctx, level), tks.dev_level(tctx, level)
    n, n_sp = tctx.n, tdl.s.p.shape[0]
    rng = np.random.default_rng(200 + level)
    items = 2
    work_sp = np.stack([_residues(rng, (n_sp, n), tdl.s.p.numpy())
                        for _ in range(2 * items)])
    got, regions = moddown_model(work_sp, tdl)
    for k in range(2 * items):
        want = np.asarray(_JFBC(work_sp[k].astype(np.uint32), jdl.moddown,
                                jdl.q_p[:, None]))
        assert np.array_equal(want.astype(np.int64), got[k])
        plain = kks.fbc(torch.from_numpy(work_sp[k]), tdl.moddown,
                        tdl.q.p[:, None])
        assert np.array_equal(plain.numpy(), got[k])
    # orion_ks_moddown's pass: work (K, 2, nl + n_sp, n) with the summed
    # special rows behind the Q rows; zq (2K, n_sp, n), then v (2K, n),
    # behind the output
    nl = level + 1
    full = np.zeros((2 * items, nl + n_sp, n), np.int64)
    full[:, nl:] = work_sp
    pro = Scratch(kks.hoist_bytes(2 * items, n_sp, 1, n))
    zq_bytes = 4 * 2 * items * n_sp * n
    hoist_digits_model(pro, 0, zq_bytes, 2 * items, n, n_sp * n, n,
                       [_tables(tdl.moddown)], [0], [n_sp],
                       src=full.reshape(-1)[nl * n:],
                       src_poly=(nl + n_sp) * n)
    assert (pro.writes == 1).all()
    for k, region in enumerate(regions):
        assert np.array_equal(region[:4 * n_sp * n],
                              pro.buf[4 * k * n_sp * n:4 * (k + 1) * n_sp * n])
        assert np.array_equal(region[4 * n_sp * n:],
                              pro.buf[zq_bytes + k * n:zq_bytes + (k + 1) * n])
    # the wrapper's constants of the special rows' inverse give zq
    tables = kks._finish_tables(tdl)
    zs, zs_sh = tables[-2].numpy(), tables[-1].numpy()
    sp = tdl.s.p.numpy()
    x = _residues(rng, (n_sp, 64), sp)
    ninv = tdl.t.ninv.numpy()[nl:, None]
    qi = _tables(tdl.moddown)["qi"][:, None]
    assert np.array_equal(x * zs[:, None] % sp[:, None],
                          (x * ninv % sp[:, None]) * qi % sp[:, None])
    assert np.array_equal(zs_sh, (zs << 32) // sp)
