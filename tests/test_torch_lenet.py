"""The LeNet slice end to end: an encrypted conv net through both packages.

A LeNet-shaped net built from each package's `nn` modules (Conv2d -> BN2d
-> Quad -> Conv2d -> BN2d -> Quad -> Flatten -> Linear -> BN1d -> Quad ->
Linear) at narrow channels on configs/lenet.yml changed to LogN 9 (H 64).
The chain keeps its 8 Q primes, so the input enters at level 7 and the
key-switches at levels 6-7 run with 4 digits (unequal at level 6).  A
1x16x16 input through conv1 (1 -> 8, k5, pad 2, stride 2) gives an
8x8x8 output at gap 2, 512 slots: two ciphertexts at LogN 9, a 2x1
block grid for conv1 and a 1x2 grid for conv2.

Weights and non-trivial BN statistics are drawn from a numpy seed onto the
orion_tpu net and carried across with `load_jax_params`; both packages run
init_scheme -> fit -> compile -> encrypt -> he forward -> decrypt, as
tests/test_torch_mlp.py runs the MLP.

Checks: cleartext outputs within 1e-5, output ciphertexts equal bit for
bit (so decrypted outputs agree to 1e-9), MAE vs cleartext < 0.005, and
the plain path launches no kernel.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import yaml

import orion_tpu as jorion
import orion_tpu.nn as jon
import orion_tpu_torch as torion
import orion_tpu_torch.nn as ton
from orion_tpu_torch.kernels import launch_counts
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.utils import ArrayLoader, mae

from .test_torch_mlp import plain, run_flow, seed_jax_net, shared

CONFIG = Path(__file__).parent.parent / "configs" / "lenet.yml"


def narrow_lenet(on):
    class NarrowLeNet(on.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = on.Conv2d(1, 8, kernel_size=5, padding=2, stride=2)
            self.bn1 = on.BatchNorm2d(8)
            self.act1 = on.Quad()
            self.conv2 = on.Conv2d(8, 16, kernel_size=5, padding=2, stride=2)
            self.bn2 = on.BatchNorm2d(16)
            self.act2 = on.Quad()
            self.flatten = on.Flatten()
            self.fc1 = on.Linear(16 * 4 * 4, 32)
            self.bn3 = on.BatchNorm1d(32)
            self.act3 = on.Quad()
            self.fc2 = on.Linear(32, 10)

        def forward(self, x):
            x = self.act1(self.bn1(self.conv1(x)))
            x = self.act2(self.bn2(self.conv2(x)))
            x = self.flatten(x)
            x = self.act3(self.bn3(self.fc1(x)))
            return self.fc2(x)

    return NarrowLeNet()


def _runs():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["ckks_params"]["LogN"] = 9
    cfg["ckks_params"]["H"] = 64
    rng = np.random.default_rng(12)
    jnet = narrow_lenet(jon)
    params = seed_jax_net(jnet, rng)
    # the conv weights drawn at the MLP test's 0.3 scale are divided by
    # sqrt(fan-in), so the activations stay near unit size through the Quads
    for name in ("conv1", "conv2"):
        w = getattr(jnet, name).weight
        w.data = (w.data / np.sqrt(np.prod(w.data.shape[1:]))
                  ).astype(np.float32)
        params[f"{name}.weight"] = w.data
    x_fit = rng.uniform(0, 1, (16, 1, 16, 16)).astype(np.float32)
    loader = ArrayLoader(x_fit, np.zeros(len(x_fit)), batch_size=1)
    x = rng.uniform(0, 1, (1, 1, 16, 16)).astype(np.float32)

    tnet = narrow_lenet(ton)
    load_jax_params(tnet, params)
    before = launch_counts()
    port = run_flow(torion, tnet, cfg, loader, x, device="cpu")
    assert launch_counts() == before   # the plain path launches nothing
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jax_run = run_flow(jorion, jnet, cfg, loader, x, module_jit=True)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
    shapes = SimpleNamespace(
        level=tnet.conv1.level, grid1=sorted(tnet.conv1.compiled),
        grid2=sorted(tnet.conv2.compiled),
        fhe_output_shape=tnet.conv1.fhe_output_shape,
        output_gap=tnet.conv2.output_gap)
    return plain(jax_run), plain(port), shapes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared(tmp_path_factory, "lenet", _runs)


def test_shapes_of_the_slice(runs):
    """The input enters at level 7, conv1's output spans two ciphertexts
    in a 2x1 block grid and conv2 reads them in a 1x2 grid."""
    _, (_, tout, _), shapes = runs
    assert shapes.level == 7
    assert shapes.grid1 == [(0, 0), (1, 0)]
    assert shapes.grid2 == [(0, 0), (0, 1)]
    assert shapes.fhe_output_shape == (1, 2, 16, 16)
    assert shapes.output_gap == 4
    assert tout.cts[0].level == 0


def test_cleartext_outputs_agree(runs):
    (jclear, _, _), (tclear, _, _), _ = runs
    np.testing.assert_allclose(tclear, jclear, atol=1e-5, rtol=0)


def test_output_ciphertexts_equal(runs):
    (_, jout, jdec), (_, tout, tdec), _ = runs
    assert len(jout.cts) == len(tout.cts)
    for a, b in zip(jout.cts, tout.cts):
        assert (a.level, a.scale) == (b.level, b.scale)
        assert np.array_equal(np.asarray(a.data).astype(np.int64),
                              b.data.numpy())
    np.testing.assert_allclose(np.asarray(tdec, np.float64),
                               np.asarray(jdec, np.float64), atol=1e-9,
                               rtol=0)


def test_mae_vs_cleartext(runs):
    _, (tclear, _, tdec), _ = runs
    flat = tclear.reshape(-1)
    assert mae(flat, np.asarray(tdec).reshape(-1)[: flat.size]) < 0.005
