"""The port's VGG, AlexNet and YOLOv1 against orion_tpu, on the CPU.

* `YOLOv1` at toy size (tests/models/test_yolo_compile.py: `TinyBackbone`,
  width 4, SiLU degree 7, a 16-unit fc, LogN 12) gives S*S*(5B+C)
  outputs equal to orion_tpu's, and fits and compiles as far as the
  solver's plan: every head conv packed, the stride-2 conv doubling the
  gap, bootstraps placed; leaf by leaf, its levels and placed bootstraps
  equal orion_tpu's on the same weights.
* A narrow AlexNet (the `AlexNet` blocks at widths 8/24/48/32/32 and a
  128-unit classifier, configs/alexnet.yml at LogN 10) is placed by both
  solvers, fit and solve only: the same levels and bootstraps.  Under the
  reference's CPU latency fit, which the port used before, the port
  placed one bootstrap fewer here, as it did on the full AlexNet (5
  against orion_tpu's 6) and VGG-11 (10 against 11).
* `TinyVGG` (tests/models/test_vgg_tiny.py: two conv blocks with SiLU(15),
  pooling, adaptive pooling and a linear head, LogN 11, no bootstrap), on
  the weights a fresh process draws from the shared generator seed, runs
  encrypted through both packages: output ciphertexts equal bit for bit,
  within MAE 0.05 of the exact net.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

import orion_tpu as jorion
import orion_tpu.compiler.level_dag as jlevel_dag
import orion_tpu.nn as jon
import orion_tpu_torch as torion
import orion_tpu_torch.compiler.level_dag as tlevel_dag
import orion_tpu_torch.nn as ton
from orion_tpu.models import alexnet as jalexnet
from orion_tpu.models.yolo import YOLOv1 as JYOLOv1
from orion_tpu_torch.models import alexnet as talexnet
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.models.yolo import YOLOv1 as TYOLOv1
from orion_tpu_torch.utils import ArrayLoader, mae

from .test_torch_mlp import seed_jax_net


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops on the plain path: one intra-op thread (see
    tests/test_torch_resnet.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


YOLO_CONFIG = {
    "ckks_params": {"LogN": 12, "LogQ": [29] + [26] * 9, "LogP": [29, 29],
                    "LogScale": 26, "H": 64, "RingType": "Standard"},
    "boot_params": {"CtSLevels": 3, "StCLevels": 3, "ModDegree": 255,
                    "K": 15},
    "orion": {"margin": 2, "embedding_method": "hybrid", "backend": "tpu",
              "fuse_modules": True, "io_mode": "stream"},
}
WIDTH = 4


def tiny_backbone(on):
    """Stands in for ResNet-34: `width` channels at 14x14, so the head's
    stride-2 conv lands on the 7x7 grid; it has the avgpool, flatten and
    linear attributes YOLOv1 strips."""

    class TinyBackbone(on.Module):
        def __init__(self, width):
            super().__init__()
            self.conv = on.Conv2d(1, width, 3, padding=1)
            self.act = on.Quad()
            self.avgpool = on.AvgPool2d(14)
            self.flatten = on.Flatten()
            self.linear = on.Linear(width, 10)

        def forward(self, x):
            x = self.act(self.conv(x))
            x = self.avgpool(x)
            x = self.flatten(x)
            return self.linear(x)

    return TinyBackbone(WIDTH)


def test_yolo_fit_compile_equals_orion_tpu():
    rng = np.random.default_rng(0)
    data = rng.uniform(-1, 1, (8, 1, 14, 14)).astype(np.float32)
    loader = ArrayLoader(data, np.zeros(len(data)), batch_size=1)
    kw = dict(num_bboxes=2, num_classes=20, width=WIDTH, act_degree=7,
              fc_dim=16)
    jnet = JYOLOv1(tiny_backbone(jon), **kw)
    tnet = TYOLOv1(tiny_backbone(ton), **kw)
    load_jax_params(tnet, seed_jax_net(jnet, np.random.default_rng(4)))

    jnet.eval()
    tnet.eval()
    out = tnet(data[:1]).numpy().reshape(-1)
    S, B, C = tnet.feature_size, tnet.num_bboxes, tnet.num_classes
    assert out.size == S * S * (5 * B + C)
    np.testing.assert_allclose(out, np.asarray(jnet(data[:1])).reshape(-1),
                               atol=1e-5, rtol=0)

    plans = []
    for orion, level_dag, net, dev in (
            (jorion, jlevel_dag, jnet, {}),
            (torion, tlevel_dag, tnet, {"device": "cpu"})):
        orion.init_scheme(YOLO_CONFIG, **dev)
        orion.fit(net, loader)
        plans.append(_solve(orion, level_dag, net))
    assert plans[1][2], "expected bootstrap placement in the YOLO head"
    assert plans[1] == plans[0]

    # every head conv packed; the stride-2 conv doubled the gap
    convs = [m for m in tnet.conv_layers.modules()
             if isinstance(m, ton.Conv2d)]
    assert len(convs) == 4
    assert all(c.diagonals for c in convs)
    assert convs[1].output_gap == 2 * convs[1].input_gap


class _Solved(Exception):
    pass


def _solve(orion, level_dag, net):
    """compile() of `net` as far as the solver's plan: fusing, packing,
    level assignment and bootstrap placement, without the keys and
    encodings that follow (at LogN 12 the port's host key generation
    alone takes tens of seconds).  Returns the plan: the input level,
    every leaf's level and the bootstraps placed (host -> bootstrap input
    level)."""
    real = level_dag.BootstrapSolver.solve
    plan = {}

    def solve(self):
        out = real(self)
        plan["plan"] = (out[0], {n: m.level for n, m in net.named_modules()
                                 if m.is_leaf()}, dict(self.bootstraps))
        raise _Solved()

    level_dag.BootstrapSolver.solve = solve
    try:
        orion.compile(net)
    except _Solved:
        pass
    finally:
        level_dag.BootstrapSolver.solve = real
    return plan["plan"]


def narrow_alexnet(on, alexnet):
    class NarrowAlexNet(on.Module):
        cfg = [8, "M", 24, "M", 48, 32, 32, "A"]

        def __init__(self):
            super().__init__()
            layers, ci = [], 3
            for x in self.cfg:
                if x == "M":
                    layers.append(on.AvgPool2d(kernel_size=2, stride=2))
                elif x == "A":
                    layers.append(on.AdaptiveAvgPool2d((2, 2)))
                else:
                    layers.append(alexnet.ConvBlock(ci, x, 3, 1, 1))
                    ci = x
            self.features = on.Sequential(*layers)
            self.flatten = on.Flatten()
            self.classifier = on.Sequential(
                alexnet.LinearBlock(ci * 4, 128),
                alexnet.LinearBlock(128, 128),
                on.Linear(128, 10))

        def forward(self, x):
            return self.classifier(self.flatten(self.features(x)))

    return NarrowAlexNet()


def test_narrow_alexnet_placement_equals_orion_tpu():
    with open("configs/alexnet.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["ckks_params"]["LogN"] = 10
    rng = np.random.default_rng(6)
    data = rng.uniform(0, 1, (16, 3, 32, 32)).astype(np.float32)
    loader = ArrayLoader(data, np.zeros(len(data)), batch_size=1)
    jnet = narrow_alexnet(jon, jalexnet)
    tnet = narrow_alexnet(ton, talexnet)
    load_jax_params(tnet, seed_jax_net(jnet, rng))
    plans = []
    for orion, level_dag, net, dev in (
            (jorion, jlevel_dag, jnet, {}),
            (torion, tlevel_dag, tnet, {"device": "cpu"})):
        orion.init_scheme(cfg, **dev)
        orion.fit(net, loader)
        plans.append(_solve(orion, level_dag, net))
    assert len(plans[0][2]) == 5
    assert plans[1] == plans[0]


TINY_VGG_CONFIG = {
    "ckks_params": {"LogN": 11, "LogQ": [29] + [26] * 19, "LogP": [29, 29],
                    "LogScale": 26, "H": 64, "RingType": "Standard"},
    "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True,
              "embedding_method": "hybrid"},
}


class TinyVGG(ton.Module):
    def __init__(self):
        super().__init__()
        self.features = ton.Sequential(
            ton.Conv2d(3, 4, kernel_size=3, padding=1),
            ton.BatchNorm2d(4),
            ton.SiLU(degree=15),
            ton.AvgPool2d(kernel_size=2, stride=2),
            ton.Conv2d(4, 8, kernel_size=3, padding=1),
            ton.BatchNorm2d(8),
            ton.SiLU(degree=15),
            ton.AdaptiveAvgPool2d(output_size=2),
        )
        self.flatten = ton.Flatten()
        self.classifier = ton.Linear(8 * 2 * 2, 4)

    def forward(self, x):
        out = self.features(x)
        out = self.flatten(out)
        return self.classifier(out)


def _first_draw_params():
    """orion_tpu's `TinyVGG` with the weights a fresh process draws for it:
    a new `np.random.default_rng(2024)` (the module-level generator both
    packages seed, `nn/linear.py`) in build order.  Returns the net and its
    parameters as numpy arrays, for `load_jax_params`."""
    from orion_tpu.nn import linear as jlinear

    from .models.test_vgg_tiny import TinyVGG as JTinyVGG

    saved = jlinear._WEIGHT_RNG
    jlinear._WEIGHT_RNG = np.random.default_rng(2024)
    try:
        jnet = JTinyVGG()
    finally:
        jlinear._WEIGHT_RNG = saved
    params = {}
    for name, m in jnet.named_modules():
        for attr in ("weight", "bias"):
            p = getattr(m, attr, None)
            if p is not None and hasattr(p, "data"):
                params[f"{name}.{attr}"] = np.asarray(p.data)
        if hasattr(m, "running_mean"):
            params[f"{name}.running_mean"] = np.asarray(m.running_mean)
            params[f"{name}.running_var"] = np.asarray(m.running_var)
    return jnet, params


def test_tiny_vgg_encrypted():
    """`TinyVGG` on the weights a fresh process draws (which the test got
    when run alone, and on which the port's output was 0.0107 from the
    fitted-polynomial net), through both packages: the port on its plain
    path, orion_tpu one jitted program per module.  The output ciphertexts
    are equal bit for bit, so the error is the circuit's on these weights
    and not the port's; it must stay within 0.05 of the exact net.  Both
    packages' errors against the fitted-polynomial and the exact net are
    printed."""
    from orion_tpu.runtime.jit import aot_precompile_forward, enable_module_jit

    jnet, params = _first_draw_params()
    net = TinyVGG()
    load_jax_params(net, params)
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 1, (32, 3, 8, 8)).astype(np.float32)
    inp = data[:1]
    loader = ArrayLoader(data, np.zeros(len(data)), batch_size=1)
    outs = {}
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        for tag, orion, on, m, kw in (("port", torion, ton, net,
                                       {"device": "cpu"}),
                                      ("orion_tpu", jorion, jon, jnet, {})):
            scheme = orion.init_scheme(TINY_VGG_CONFIG, **kw)
            m.eval()
            out_exact = np.asarray(m(inp), np.float64).reshape(-1)
            orion.fit(m, loader)
            # the cleartext net with the fitted Chebyshev series in place
            # of SiLU: what the circuit evaluates
            acts = [a for a in m.modules() if isinstance(a, on.Chebyshev)]
            saved = [a.fn for a in acts]
            for a in acts:
                a.fn = _chebyshev_clear_fn(a)
            out_poly = np.asarray(m(inp), np.float64).reshape(-1)
            for a, fn in zip(acts, saved):
                a.fn = fn
            level = orion.compile(m)
            ct = orion.encrypt(orion.encode(inp, level))
            m.he()
            if tag == "orion_tpu":
                enable_module_jit(scheme)
                aot_precompile_forward(m, scheme, ct, workers=4)
            out = m(ct)
            fhe = np.asarray(out.decrypt().decode(), np.float64).reshape(-1)
            outs[tag] = (out, fhe[: out_exact.size], out_exact, out_poly)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
    (tout, tfhe, texact, tpoly), (jout, jfhe, jexact, jpoly) = (
        outs["port"], outs["orion_tpu"])
    np.testing.assert_allclose(texact, jexact, atol=1e-5, rtol=0)
    assert len(tout.cts) == len(jout.cts)
    for a, b in zip(jout.cts, tout.cts):
        assert (a.level, a.scale) == (b.level, b.scale)
        assert np.array_equal(np.asarray(a.data).astype(np.int64),
                              b.data.numpy())
    np.testing.assert_allclose(tfhe, jfhe, atol=1e-9, rtol=0)
    for tag, (_, fhe, exact, poly) in outs.items():
        print(f"TinyVGG {tag}: MAE vs the fitted-polynomial net "
              f"{mae(poly, fhe):.4e}, vs the exact net {mae(exact, fhe):.4e}")
        assert mae(exact, fhe) < 0.05


def _chebyshev_clear_fn(act):
    coeffs = np.asarray(act.coeffs)

    def fn(x):
        x = np.asarray(x)
        t = x * act.prescale + act.constant if act.prescale != 1 else x
        return np.polynomial.chebyshev.chebval(t, coeffs)
    return fn


def test_lenet_places_no_bootstrap_without_boot_params(monkeypatch):
    """configs/lenet.yml provisions no bootstrapping.  Under orion_tpu's
    latency fit a bootstrap is cheap enough to pay for itself on the
    full-width LeNet, and orion_tpu's solver places one after conv2, which
    its compile cannot build.  The port's solver places bootstraps only
    where the config has `boot_params`: its plan is the one orion_tpu's
    solver gives with bootstrapping ruled out."""
    import orion_tpu.models as jmodels
    import orion_tpu_torch.models as tmodels

    with open("configs/lenet.yml") as f:
        cfg = yaml.safe_load(f)
    assert "boot_params" not in cfg
    data = np.random.default_rng(8).uniform(0, 1, (16, 1, 28, 28)).astype(
        np.float32)
    loader = ArrayLoader(data, np.zeros(len(data)), batch_size=1)
    plans = {}
    for tag, orion, level_dag, net, dev in (
            ("orion_tpu", jorion, jlevel_dag, jmodels.LeNet(), {}),
            ("orion_tpu, no bootstrap", jorion, jlevel_dag, jmodels.LeNet(),
             {}),
            ("port", torion, tlevel_dag, tmodels.LeNet(), {"device": "cpu"})):
        orion.init_scheme(cfg, **dev)
        orion.fit(net, loader)
        with monkeypatch.context() as m:
            if tag == "orion_tpu, no bootstrap":
                m.setattr(jlevel_dag, "boot_latency",
                          lambda *a: float("inf"))
            plans[tag] = _solve(orion, level_dag, net)
    assert plans["orion_tpu"][2], "orion_tpu's fit places a bootstrap"
    assert not plans["port"][2]
    assert plans["port"] == plans["orion_tpu, no bootstrap"]
