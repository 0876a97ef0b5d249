"""Batched serving: B encrypted queries through one forward
(`orion_tpu_torch.runtime.jit.make_batched_forward`), on the CPU.

* orion_tpu's own case (tests/models/test_batched_forward.py: `SmallNet`,
  Linear 16-16, Quad, Linear 16-4, LogN 8): the port's batched forward at
  B = 4 gives exactly the output ciphertexts of orion_tpu's
  `make_batched_forward` (one vmapped XLA program) and of the port's
  serial forwards of the same queries, within MAE 0.005 of cleartext.
* A conv net with a bootstrap (two conv blocks with BatchNorm2d and Quad,
  a linear head; the solver places one bootstrap at LogN 8): the batched
  forward at B = 2 runs the transforms, the rescales and the bootstrap
  over the stacked queries, and equals the serial forwards bit for bit.
  Serial forwards of the port equal orion_tpu's (test_torch_resnet.py,
  test_torch_bootstrap.py), and so does the port's bootstrap of two
  stacked queries (test_torch_bootstrap.py).  orion_tpu's forward of this
  net is not run here: its per-module compiles take about two minutes on
  the CPU.
* Queries at different levels are refused.
"""

import jax
import numpy as np
import pytest
import torch

import orion_tpu as jorion
import orion_tpu.nn as jon
import orion_tpu_torch as torion
import orion_tpu_torch.nn as ton
from orion_tpu.runtime.jit import make_batched_forward as jbatched
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.runtime.jit import (make_batched_forward,
                                         make_jitted_forward)
from orion_tpu_torch.utils import ArrayLoader, mae

from .test_torch_mlp import seed_jax_net

SMALL_CONFIG = {
    "ckks_params": {"LogN": 8, "LogQ": [29, 26, 26, 26], "LogP": [29, 29],
                    "LogScale": 26, "H": 64, "RingType": "Standard"},
    "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True},
}

BOOT_CONFIG = {
    "ckks_params": {"LogN": 8, "LogQ": [29, 26, 26, 26], "LogP": [29, 29],
                    "LogScale": 26, "H": 64, "RingType": "Standard"},
    "boot_params": {"CtSLevels": 3, "StCLevels": 3, "ModDegree": 255,
                    "K": 15},
    "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops on the plain path: one intra-op thread (see
    tests/test_torch_resnet.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def small_net(on):
    class SmallNet(on.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = on.Linear(16, 16)
            self.act = on.Quad()
            self.fc2 = on.Linear(16, 4)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    return SmallNet()


def conv_boot_net(on):
    class ConvBootNet(on.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = on.Conv2d(1, 2, 3, padding=1)
            self.bn0 = on.BatchNorm2d(2)
            self.act0 = on.Quad()
            self.conv1 = on.Conv2d(2, 2, 3, padding=1)
            self.bn1 = on.BatchNorm2d(2)
            self.act1 = on.Quad()
            self.flatten = on.Flatten()
            self.fc = on.Linear(2 * 8 * 8, 4)

        def forward(self, x):
            x = self.act0(self.bn0(self.conv0(x)))
            x = self.act1(self.bn1(self.conv1(x)))
            return self.fc(self.flatten(x))

    return ConvBootNet()


def assert_equal_cts(a, b):
    assert len(a.cts) == len(b.cts)
    for x, y in zip(a.cts, b.cts):
        assert (x.level, x.scale) == (y.level, y.scale)
        assert torch.equal(torch.as_tensor(np.asarray(x.data)).to(
            torch.int64), y.data)


def test_batched_forward_equals_orion_tpu_and_serial():
    rng = np.random.default_rng(3)
    data = rng.uniform(-1, 1, (64, 16)).astype(np.float32)
    loader = ArrayLoader(data, np.zeros(len(data)), batch_size=1)
    B = 4
    queries = [data[i:i + 1] for i in range(B)]
    jnet = small_net(jon)
    params = seed_jax_net(jnet, np.random.default_rng(5))
    tnet = small_net(ton)
    load_jax_params(tnet, params)

    outs = {}
    for tag, orion, net, kw in (("port", torion, tnet, {"device": "cpu"}),
                                ("orion_tpu", jorion, jnet, {})):
        scheme = orion.init_scheme(SMALL_CONFIG, **kw)
        net.eval()
        orion.fit(net, loader)
        level = orion.compile(net)
        net.he()
        cts = [orion.encrypt(orion.encode(q, level)) for q in queries]
        if tag == "port":
            port_cts = cts
            outs[tag] = make_batched_forward(net, scheme)(cts)
            serial = make_jitted_forward(net, scheme)
            outs["serial"] = [serial(ct) for ct in cts]
        else:
            for a, b in zip(cts, port_cts):
                assert_equal_cts(a, b)
            prev = jax.config.read("jax_disable_most_optimizations")
            jax.config.update("jax_disable_most_optimizations", True)
            try:
                outs[tag] = jbatched(net, scheme)(cts)
            finally:
                jax.config.update("jax_disable_most_optimizations", prev)
    assert len(outs["port"]) == B
    tnet.eval()
    for q, port, jout, serial in zip(queries, outs["port"],
                                     outs["orion_tpu"], outs["serial"]):
        assert_equal_cts(jout, port)
        assert_equal_cts(serial, port)
        clear = tnet(q).numpy().reshape(-1)
        got = np.asarray(port.decrypt().decode()).reshape(-1)
        assert mae(clear, got[: clear.size]) < 0.005


def test_batched_bootstrap_equals_serial():
    torion.init_scheme(BOOT_CONFIG, device="cpu")
    net = conv_boot_net(ton)
    rng = np.random.default_rng(1)
    data = rng.uniform(0, 1, (32, 1, 8, 8)).astype(np.float32)
    net.eval()
    clear = [net(data[i:i + 1]).numpy().reshape(-1) for i in range(2)]
    torion.fit(net, ArrayLoader(data, np.zeros(len(data)), batch_size=1))
    level = torion.compile(net)
    placed = [n for n, m in net.named_modules()
              if getattr(m, "post_bootstrap", None) is not None]
    assert placed, "the solver should place a bootstrap"
    net.he()
    cts = [torion.encrypt(torion.encode(data[i:i + 1], level))
           for i in range(2)]
    batched = make_batched_forward(net, torion.scheme)(cts)
    for ct, out, c in zip(cts, batched, clear):
        assert_equal_cts(net(ct), out)
        fhe = out.decrypt().decode().reshape(-1)
        assert mae(c, fhe[: c.size]) < 0.005


def test_mismatched_query_level_raises():
    scheme = torion.init_scheme(SMALL_CONFIG, device="cpu")
    net = small_net(ton)
    data = np.random.default_rng(3).uniform(-1, 1, (8, 16)).astype(
        np.float32)
    net.eval()
    torion.fit(net, ArrayLoader(data, np.zeros(len(data)), batch_size=1))
    level = torion.compile(net)
    net.he()
    run = make_batched_forward(net, scheme)
    good = torion.encrypt(torion.encode(data[:1], level))
    low = torion.encrypt(torion.encode(data[1:2], level - 1))
    with pytest.raises(ValueError, match="levels, scales and shape"):
        run([good, low])
    with pytest.raises(ValueError, match="no queries"):
        run([])
