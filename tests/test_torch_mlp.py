"""The slice end to end: an encrypted MLP through both packages.

The MLP of models/mlp.py at narrow widths (Flatten -> Linear(64,32) -> BN
-> Quad -> Linear(32,32) -> BN -> Quad -> Linear(32,10)) on
configs/mlp.yml changed to LogN 10 (H 64).  Weights and non-trivial BN
statistics are drawn from a numpy seed onto the orion_tpu net and carried
across with `load_jax_params`.  Both packages run init_scheme -> fit ->
compile -> encrypt -> he forward -> decrypt; orion_tpu's forward runs one
jitted program per module (`runtime/jit.enable_module_jit`), as its model
tests run it, compiled ahead in a thread pool (`aot_precompile_forward`),
and the port runs its plain path on device="cpu".

Checks: cleartext outputs within 1e-5 (float32 matmuls sum in another
order), output ciphertexts equal bit for bit (so decrypted outputs agree
to 1e-9), MAE vs cleartext < 0.005.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

import orion_tpu as jorion
import orion_tpu.nn as jon
import orion_tpu_torch as torion
import orion_tpu_torch.nn as ton
from orion_tpu.runtime.jit import aot_precompile_forward, enable_module_jit
from orion_tpu_torch.kernels import launch_counts
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.utils import ArrayLoader, mae

CONFIG = Path(__file__).parent.parent / "configs" / "mlp.yml"


def narrow_mlp(on):
    class NarrowMLP(on.Module):
        def __init__(self):
            super().__init__()
            self.flatten = on.Flatten()
            self.fc1 = on.Linear(64, 32)
            self.bn1 = on.BatchNorm1d(32)
            self.act1 = on.Quad()
            self.fc2 = on.Linear(32, 32)
            self.bn2 = on.BatchNorm1d(32)
            self.act2 = on.Quad()
            self.fc3 = on.Linear(32, 10)

        def forward(self, x):
            x = self.flatten(x)
            x = self.act1(self.bn1(self.fc1(x)))
            x = self.act2(self.bn2(self.fc2(x)))
            return self.fc3(x)

    return NarrowMLP()


def _seed_jax_net(net, rng):
    """Random weights and BN statistics on the orion_tpu net; returns them
    as the numpy dict load_jax_params takes."""
    params = {}
    for name, m in net.named_modules():
        for attr in ("weight", "bias"):
            p = getattr(m, attr, None)
            if p is not None and hasattr(p, "data"):
                p.data = (rng.standard_normal(p.data.shape) * 0.3
                          ).astype(np.float32)
                params[f"{name}.{attr}"] = p.data
        if hasattr(m, "running_mean"):
            m.running_mean = rng.uniform(
                -0.2, 0.2, m.num_features).astype(np.float32)
            m.running_var = rng.uniform(
                0.5, 1.5, m.num_features).astype(np.float32)
            params[f"{name}.running_mean"] = m.running_mean
            params[f"{name}.running_var"] = m.running_var
    return params


def _run(orion, net, cfg, loader, x, module_jit=False, **kw):
    scheme = orion.init_scheme(cfg, **kw)
    net.eval()
    clear = net(x)
    orion.fit(net, loader)
    level = orion.compile(net)
    ct = orion.encrypt(orion.encode(x, level))
    net.he()
    if module_jit:
        enable_module_jit(scheme)
        aot_precompile_forward(net, scheme, ct, workers=4)
    out = net(ct)
    return np.asarray(clear, dtype=np.float64), out, out.decrypt().decode()


@pytest.fixture(scope="module")
def runs():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["ckks_params"]["LogN"] = 10
    cfg["ckks_params"]["H"] = 64
    rng = np.random.default_rng(11)
    jnet = narrow_mlp(jon)
    params = _seed_jax_net(jnet, rng)
    x_fit = rng.uniform(0, 1, (32, 1, 8, 8)).astype(np.float32)
    loader = ArrayLoader(x_fit, np.zeros(len(x_fit)), batch_size=1)
    x = rng.uniform(0, 1, (1, 1, 8, 8)).astype(np.float32)

    tnet = narrow_mlp(ton)
    load_jax_params(tnet, params)
    before = launch_counts()
    port = _run(torion, tnet, cfg, loader, x, device="cpu")
    assert launch_counts() == before   # the plain path launches nothing
    # orion_tpu's programs compile without most XLA optimizations (a third
    # less compile time; integer and IEEE float32 ops give the same bits
    # either way, as the comparison checks)
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jax_run = _run(jorion, jnet, cfg, loader, x, module_jit=True)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
    return jax_run, port


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
