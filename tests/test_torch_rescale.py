"""rescale_poly's launch B (orion_tpu_torch/kernels/csrc/ntt.cu
`rescale_lift_ntt`) as the card runs it, modelled in numpy on the CPU.

The CUDA kernel runs only on the card.  Two of its choices are checked
here against the plain versions and orion_tpu:

  - the centered lift reduces x mod q_j as a Shoup product by one,
    x - umulhi(x, floor(2^32 / q_j)) * q_j less q_j once more where that is
    >= q_j (`kernels/rescale.py` `one_shoup`), which must equal x % q_j for
    every x < 2^32 and every prime of configs/mlp.yml, lenet.yml,
    resnet.yml and lola.yml;
  - its grid: one cluster per (poly g, target row j), in row-major order
    over any leading batch shape.  The model walks the clusters, lifts the
    poly's last limb as the kernel does, transforms the row with the plain
    forward NTT and subtracts and scales with Shoup's product from the
    value of c the thread fetched for that output; every output row must be
    written by exactly one cluster.  From launch A's z it must equal
    `rescale_lift_ntt_plain` at every level of configs/mlp.yml (LogN 13)
    and, after launch A, orion_tpu's jitted `rescale_poly` at its top
    level (orion_tpu's level tables and program cost about 4 s a level at
    LogN 13) and on a LogN-10 chain over one ciphertext, a stack of 3
    polys and a single poly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from orion_tpu.crypto import keyswitch as jks
from orion_tpu.crypto.context import CKKSContext as JContext
from orion_tpu_torch.crypto import keyswitch as tks
from orion_tpu_torch.crypto.context import CKKSContext as TContext
from orion_tpu_torch.kernels import rescale as krs
from orion_tpu_torch.kernels.ntt import ntt_fwd_plain
from orion_tpu_torch.runtime.config import parse_config

CONFIGS = Path(__file__).parent.parent / "configs"
NARROW = dict(logn=10, logq=[29, 26, 26], logp=[29, 29], logscale=26, h=64,
              seed=3)
SAMPLES = 1 << 16


@pytest.fixture(scope="module", autouse=True)
def _unoptimised_xla():
    """orion_tpu's rescale_poly compiles without most XLA optimizations
    here: its integer ops give the same bits."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


def _kwargs(tag):
    with open(CONFIGS / f"{tag}.yml") as f:
        p = parse_config(yaml.safe_load(f))
    return dict(logn=p.logn, logq=p.split_logq, logp=p.logp,
                logscale=p.logscale, h=p.h, ring_type=p.ring_type,
                seed=p.seed)


_CTX = {}


def _contexts(name):
    """(orion_tpu context, port context on the CPU) of a config or of the
    narrow chain."""
    if name not in _CTX:
        kw = NARROW if name == "narrow" else _kwargs(name)
        _CTX[name] = JContext(**kw), TContext(**kw, device="cpu")
    return _CTX[name]


def shoup_mul(a, w, w_sh, p):
    """modarith.cuh shoup_mul on uint64 arrays of uint32 values: exact
    for a < 2^32, w < p < 2^31."""
    q = (a * w_sh) >> np.uint64(32)
    r = a * w - q * p
    return np.where(r >= p, r - p, r)


@pytest.mark.parametrize("tag", ["mlp", "lenet", "resnet", "lola"])
def test_one_shoup_reduces_like_mod(tag):
    ctx = TContext(**_kwargs(tag), device="cpu")
    primes = torch.tensor(ctx.primes, dtype=torch.int64)
    consts = krs.one_shoup(primes).numpy().astype(np.uint64)
    rng = np.random.default_rng(17)
    for p, c in zip(primes.numpy().astype(np.uint64), consts):
        half = (p + np.uint64(1)) // np.uint64(2)
        edges = np.array([0, p - 1, p, half - 1, half, (1 << 32) - 1],
                         np.uint64)
        x = np.concatenate([edges, rng.integers(0, 1 << 32, SAMPLES,
                                                dtype=np.uint64)])
        got = shoup_mul(x, np.uint64(1), c, p)
        assert np.array_equal(got, x % p), f"prime {p}"


def launch_b_model(c, z, tdl):
    """rescale_lift_ntt over c (..., l+1, N) from launch A's z (groups, 1,
    N), cluster by cluster: cluster (g, j) = divmod(row, l) takes poly g's
    z row and c row j and writes output row (g, j)."""
    lvl = tdl.level
    n = c.shape[-1]
    a = c.reshape(-1, lvl + 1, n).numpy().astype(np.uint64)
    zz = z[:, 0].numpy().astype(np.uint32).astype(np.uint64)
    groups = a.shape[0]
    col = {k: v[:, 0].numpy().astype(np.uint64) for k, v in (
        ("qm", tdl.qlast_mod_t), ("sc", tdl.qlast_inv),
        ("sc_sh", tdl.qlast_inv_shoup))}
    p = tdl.q.p.numpy().astype(np.uint64)
    osh = krs.one_shoup(tdl.q.p).numpy().astype(np.uint64)
    half = np.uint64(tdl.qlast_half)
    out = np.zeros((groups * lvl, n), np.uint64)
    writes = np.zeros(groups * lvl, np.int64)
    for row in range(groups * lvl):
        g, j = divmod(row, lvl)
        pj, x = p[j], zz[g]
        lift = shoup_mul(x, np.uint64(1), osh[j], pj)
        lift = (lift + pj - np.where(x >= half, col["qm"][j], 0)) % pj
        y = ntt_fwd_plain(torch.as_tensor(lift.astype(np.int64))[None],
                          tdl.q.rows(j, j + 1))[0].numpy()
        pre = a[g, j]                  # fetched before the transform
        diff = (pre + pj - y.astype(np.uint64)) % pj
        out[row] = shoup_mul(diff, col["sc"][j], col["sc_sh"][j], pj)
        writes[row] += 1
    assert (writes == 1).all(), "an output row not written exactly once"
    return torch.as_tensor(out.astype(np.int64).reshape(
        c.shape[:-2] + (lvl, n)))


def _check(name, level, batch, reference=True):
    jctx, tctx = _contexts(name)
    tdl = tks.dev_level(tctx, level)
    rng = np.random.default_rng(40 + level + len(batch))
    p = np.array(tctx.primes[:level + 1], np.int64)[:, None]
    c = rng.integers(0, 1 << 62, batch + (level + 1, tctx.n),
                     dtype=np.int64) % p
    tc = torch.as_tensor(c)
    z = krs.divisor_intt_plain(tc, tdl, drop=False)
    groups = z.shape[0]
    want = krs.rescale_lift_ntt_plain(tc, z, tdl)
    assert torch.equal(launch_b_model(tc, z, tdl), want)
    if not reference:
        return
    flat = c.reshape(-1, level + 1, tctx.n).astype(np.uint32)
    jout = jks.rescale_poly(jnp.asarray(flat), jks.dev_level(jctx, level))
    assert np.array_equal(np.asarray(jout).astype(np.int64),
                          want.reshape(groups, level, tctx.n).numpy())


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_launch_b_grid_at_mlp_levels(level):
    """One ciphertext (2 polys) at each level of configs/mlp.yml, against
    orion_tpu at the top level."""
    _check("mlp", level, (2,), reference=level == 5)


@pytest.mark.parametrize("batch", [(2,), (3,), ()],
                         ids=["ciphertext", "stack_of_3", "single_poly"])
def test_launch_b_grid_narrow(batch):
    """A LogN-10 chain at its top level: one ciphertext, a stack of 3
    polys (an odd count), a single poly."""
    _check("narrow", 2, batch)
