"""Encrypted LoLA and the narrow MLP on the ConjugateInvariant ring,
through both packages.

tests/configs/mlp.yml (the config orion_tpu's own tests/models/test_lola.py
and test_mlp.py load: RingType ConjugateInvariant, 6 Q + 2 special primes)
changed to LogN 10 (H 64): 1024 real slots, enough for LoLA's 980 hidden
values.  The nets are models/lola.py's LoLA at full width (conv 1->5 k2 s2,
BatchNorm2d, Quad, 980-100, BatchNorm1d, Quad, 100-10) on a 28x28 input,
and tests/test_torch_mlp.py's narrow MLP on an 8x8 input.  Weights and
non-trivial BN statistics are drawn from a numpy seed onto the orion_tpu
net and carried across with `load_jax_params`.  Both packages run
init_scheme -> fit -> compile -> encrypt -> he forward -> decrypt,
orion_tpu one jitted program per module, the port its plain path on
device="cpu".

Checks: cleartext outputs within 1e-5, output ciphertexts equal bit for
bit, MAE vs cleartext < 0.005.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import orion_tpu as jorion
import orion_tpu.models as jmodels
import orion_tpu.nn as jon
import orion_tpu_torch as torion
import orion_tpu_torch.models as tmodels
import orion_tpu_torch.nn as ton
from orion_tpu_torch.kernels import launch_counts
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.utils import ArrayLoader, mae

from .test_torch_mlp import narrow_mlp, plain, run_flow, seed_jax_net, shared

CONFIG = Path(__file__).parent / "configs" / "mlp.yml"

NETS = {
    "lola": (jmodels.LoLA, tmodels.LoLA, (1, 28, 28), 21),
    "mlp": (lambda: narrow_mlp(jon), lambda: narrow_mlp(ton), (1, 8, 8), 22),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops on the plain path: one intra-op thread (see
    tests/test_torch_resnet.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flows(name):
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    assert cfg["ckks_params"]["RingType"] == "ConjugateInvariant"
    cfg["ckks_params"]["LogN"] = 10
    cfg["ckks_params"]["H"] = 64
    jmake, tmake, shape, seed = NETS[name]
    rng = np.random.default_rng(seed)
    jnet = jmake()
    params = seed_jax_net(jnet, rng)
    x_fit = rng.uniform(0, 1, (32,) + shape).astype(np.float32)
    loader = ArrayLoader(x_fit, np.zeros(len(x_fit)), batch_size=1)
    x = rng.uniform(0, 1, (1,) + shape).astype(np.float32)

    tnet = tmake()
    load_jax_params(tnet, params)
    before = launch_counts()
    port = run_flow(torion, tnet, cfg, loader, x, device="cpu")
    assert launch_counts() == before   # the plain path launches nothing
    assert torion.scheme.ctx.slots == 1024
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jax_run = run_flow(jorion, jnet, cfg, loader, x, module_jit=True)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
    return plain(jax_run), plain(port)


@pytest.fixture(scope="module", params=sorted(NETS))
def runs(request, tmp_path_factory):
    return shared(tmp_path_factory, f"lola_{request.param}",
                  lambda: _flows(request.param))


def test_cleartext_outputs_agree(runs):
    (jclear, _, _), (tclear, _, _) = runs
    np.testing.assert_allclose(tclear, jclear, atol=1e-5, rtol=0)


def test_output_ciphertexts_equal(runs):
    (_, jout, jdec), (_, tout, tdec) = runs
    assert len(jout.cts) == len(tout.cts)
    for a, b in zip(jout.cts, tout.cts):
        assert (a.level, a.scale) == (b.level, b.scale)
        assert np.array_equal(np.asarray(a.data).astype(np.int64),
                              b.data.numpy())
    np.testing.assert_allclose(np.asarray(tdec, np.float64),
                               np.asarray(jdec, np.float64), atol=1e-9,
                               rtol=0)


def test_mae_vs_cleartext(runs):
    _, (tclear, _, tdec) = runs
    flat = tclear.reshape(-1)
    assert mae(flat, np.asarray(tdec).reshape(-1)[: flat.size]) < 0.005
