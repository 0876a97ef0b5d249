"""Residual nets with bootstraps: the port's placement against orion_tpu's,
and an encrypted residual forward on the port's CPU path.

* orion_tpu's `ResNetMini` (tests/models/test_tiny_resnet_compile.py: a
  conv stem, one stride-2 BasicBlock with its conv shortcut, minimax ReLU
  (7, 7), LogN 10, l_eff 6) is built in both packages with the same
  weights (`load_jax_params`) and compiled.  Both solvers assign every
  leaf the same level and place the same bootstraps after the same
  modules at the same levels.  orion_tpu's solver reads the latency fit
  it ships (`compiler/latency_tpu.json`) and the port carries the same
  constants; the comparison is made with them, and again with the port's
  solver given the reference's CPU fit, under which the plan is the
  same.
* configs/resnet.yml parses to the same split moduli, circuit primes,
  special primes and bootstrap knobs in both packages, and the contexts
  built from it (LogN 13, 44 + 6 primes) have equal primes and equal
  per-level key-switch and rescale tables.
* `TinyResNet2` (tests/models/test_residual_bootstrap.py: a residual block
  with Quad activations, LogN 9, l_eff 3) runs encrypted through the
  port's entry points on the CPU, with bootstraps placed mid-network, and
  decrypts within MAE 0.005 of cleartext.
"""

from pathlib import Path

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
from orion_tpu.crypto.context import CKKSContext as JContext
from orion_tpu.models import resnet as jresnet
from orion_tpu.runtime.config import parse_config as jparse
from orion_tpu_torch.crypto.context import CKKSContext as TContext
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.models import resnet as tresnet
from orion_tpu_torch.runtime.config import parse_config as tparse
from orion_tpu_torch.utils import ArrayLoader, mae

from .test_torch_mlp import seed_jax_net

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain path at these sizes is many small torch ops: one
    intra-op thread runs them as fast alone and does not spin against the
    other test workers' threads (eight threads each made these tests up
    to 25x slower in a 3-worker run)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MINI_CONFIG = {
    "ckks_params": {"LogN": 10, "LogQ": [29, 26, 26, 26, 26, 26, 26],
                    "LogP": [29, 29], "LogScale": 26, "H": 128,
                    "RingType": "Standard"},
    "boot_params": {"CtSLevels": 3, "StCLevels": 3, "ModDegree": 255,
                    "K": 15},
    "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True},
}

TINY_CONFIG = {
    "ckks_params": {"LogN": 9, "LogQ": [29, 26, 26, 26], "LogP": [29, 29],
                    "LogScale": 26, "H": 64, "RingType": "Standard"},
    "boot_params": {"CtSLevels": 3, "StCLevels": 3, "ModDegree": 255,
                    "K": 15},
    "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True},
}


def resnet_mini(on, resnet):
    class ResNetMini(on.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = on.Conv2d(1, 4, kernel_size=3, padding=1,
                                   bias=False)
            self.bn1 = on.BatchNorm2d(4)
            self.act = on.ReLU(degrees=[7, 7])
            self.block = resnet.BasicBlock(4, 8, stride=2)
            self.flatten = on.Flatten()
            self.fc = on.Linear(8 * 4 * 4, 4)

        def forward(self, x):
            x = self.act(self.bn1(self.conv1(x)))
            x = self.block(x)
            return self.fc(self.flatten(x))

    return ResNetMini()


def tiny_resnet2(on):
    class TinyResNet2(on.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = on.Conv2d(1, 2, 3, padding=1)
            self.bn0 = on.BatchNorm2d(2)
            self.act0 = on.Quad()
            self.conv1 = on.Conv2d(2, 2, 3, padding=1)
            self.bn1 = on.BatchNorm2d(2)
            self.act1 = on.Quad()
            self.conv2 = on.Conv2d(2, 2, 3, padding=1)
            self.bn2 = on.BatchNorm2d(2)
            self.add = on.Add()
            self.act2 = on.Quad()
            self.flatten = on.Flatten()
            self.fc = on.Linear(2 * 8 * 8, 4)

        def forward(self, x):
            x = self.act0(self.bn0(self.conv0(x)))
            y = self.act1(self.bn1(self.conv1(x)))
            y = self.bn2(self.conv2(y))
            y = self.add(y, x)
            y = self.act2(y)
            return self.fc(self.flatten(y))

    return TinyResNet2()


def _plan(net):
    """Every leaf's level, and (host, bootstrap input level, postscale,
    slot count) of every placed bootstrap."""
    levels, boots = {}, {}
    for name, m in net.named_modules():
        if name.endswith("post_bootstrap"):
            continue
        if m.is_leaf():
            levels[name] = m.level
        pb = getattr(m, "post_bootstrap", None)
        if pb is not None:
            boots[name] = (pb.input_level, pb.postscale, pb.slot_count)
    return levels, boots


@pytest.fixture(scope="module")
def mini_plans():
    rng = np.random.default_rng(3)
    jnet = resnet_mini(jon, jresnet)
    params = seed_jax_net(jnet, rng)
    data = rng.uniform(-1, 1, (16, 1, 8, 8)).astype(np.float32)
    loader = ArrayLoader(data, np.zeros(len(data)), batch_size=1)
    jorion.init_scheme(MINI_CONFIG)
    jorion.fit(jnet, loader)
    j_in = jorion.compile(jnet)
    plans = {"orion_tpu": (j_in, _plan(jnet))}
    fits = {"tpu_fit": (jlevel_dag.LT_ALPHA, jlevel_dag.BOOT_A,
                        jlevel_dag.BOOT_B, jlevel_dag.BOOT_C),
            # the reference's CPU/Lattigo fit
            "cpu_fit": (0.001, 3.41, 0.18, 4.81)}
    saved = (tlevel_dag.LT_ALPHA, tlevel_dag.BOOT_A, tlevel_dag.BOOT_B,
             tlevel_dag.BOOT_C)
    for tag, consts in fits.items():
        (tlevel_dag.LT_ALPHA, tlevel_dag.BOOT_A, tlevel_dag.BOOT_B,
         tlevel_dag.BOOT_C) = consts
        try:
            tnet = resnet_mini(ton, tresnet)
            load_jax_params(tnet, params)
            torion.init_scheme(MINI_CONFIG, device="cpu")
            torion.fit(tnet, loader)
            plans[tag] = (torion.compile(tnet), _plan(tnet))
        finally:
            (tlevel_dag.LT_ALPHA, tlevel_dag.BOOT_A, tlevel_dag.BOOT_B,
             tlevel_dag.BOOT_C) = saved
    return plans


@pytest.mark.parametrize("fit", ["tpu_fit", "cpu_fit"])
def test_resnet_mini_placement_equals_orion_tpu(mini_plans, fit):
    j_in, (j_levels, j_boots) = mini_plans["orion_tpu"]
    t_in, (t_levels, t_boots) = mini_plans[fit]
    assert j_boots, "the chain is too short: bootstraps must be placed"
    assert t_in == j_in
    assert t_levels == j_levels
    assert t_boots == j_boots


def test_tiny_resnet2_encrypted_mae():
    torion.init_scheme(TINY_CONFIG, device="cpu")
    net = tiny_resnet2(ton)
    rng = np.random.default_rng(1)
    data = rng.uniform(0, 1, (32, 1, 8, 8)).astype(np.float32)
    inp = data[:1]
    net.eval()
    clear = net(inp).numpy().reshape(-1)
    torion.fit(net, ArrayLoader(data, np.zeros(len(data)), batch_size=1))
    level = torion.compile(net)
    placed = [n for n, m in net.named_modules()
              if getattr(m, "post_bootstrap", None) is not None]
    assert placed, "the solver should place at least one bootstrap"
    net.he()
    out = net(torion.encrypt(torion.encode(inp, level)))
    fhe = out.decrypt().decode().reshape(-1)
    assert mae(clear, fhe[: clear.size]) < 0.005


def test_resnet_config_split_equals_orion_tpu():
    with open(Path(__file__).parent.parent / "configs" / "resnet.yml") as f:
        cfg = yaml.safe_load(f)
    j, t = jparse(cfg), tparse(cfg)
    for attr in ("logn", "split_logq", "logp", "base_level", "boot",
                 "l_eff", "max_level", "logscale", "h", "io_mode"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (len(t.split_logq), len(t.logp), t.base_level) == (44, 6, 1)
    kw = dict(logn=t.logn, logq=t.split_logq, logp=t.logp,
              logscale=t.logscale, h=t.h, seed=t.seed)
    jctx, tctx = JContext(**kw), TContext(**kw, device="cpu")
    assert (tctx.q_primes, tctx.p_primes) == (jctx.q_primes, jctx.p_primes)
    for level in range(tctx.n_q):
        a, b = tctx.ks_tables[level], jctx.ks_tables[level]
        pairs = [(a.moddown, b.moddown)] + list(zip(a.digits, b.digits))
        if level:
            pairs.append((a.dropdown, b.dropdown))
        assert len(a.digits) == len(b.digits) == -(-(level + 1) // 6)
        for x, y in pairs:
            assert x.src_idx == y.src_idx
            for f in ("qhat_inv", "conv", "d_mod_t", "src_q"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), f
        for f in ("pinv_mod_q", "qlast_mod_t", "qlast_inv", "dqinv_mod_q",
                  "p_mod_q"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), (level, f)


def test_early_key_freeing_changes_no_bit(monkeypatch):
    """Compile frees each packed rotation key as soon as no module still
    to compile asks for it (not all at the end of compile).  Against a
    compile that frees them only at its end: the same keys made, the same
    key packs and kept keys, the same encrypted input, bit for bit, and
    fewer keys held at once."""
    from orion_tpu_torch.crypto.keys import KeyChest
    from orion_tpu_torch.runtime.scheme import Scheme

    real_key, real_free = KeyChest.galois_key, Scheme._free_packed_keys
    data = np.random.default_rng(1).uniform(0, 1, (8, 1, 8, 8)).astype(
        np.float32)
    runs = []
    for at_end in (False, True):
        held = []

        def galois_key(self, k):
            out = real_key(self, k)
            held.append(len(self.galois_keys))
            return out

        def free(self, keep, pending):
            return 0 if at_end and pending else real_free(self, keep,
                                                          pending)

        with monkeypatch.context() as m:
            m.setattr(KeyChest, "galois_key", galois_key)
            m.setattr(Scheme, "_free_packed_keys", free)
            scheme = torion.init_scheme(TINY_CONFIG, device="cpu")
            net = tiny_resnet2(ton)
            torion.fit(net, ArrayLoader(data, np.zeros(8), batch_size=1))
            level = torion.compile(net)
        ct = torion.encrypt(torion.encode(data[:1], level))
        packs = {k: p.ksk for k, p in scheme.evaluator._key_packs.items()}
        kept = {k: v.data for k, v in scheme.keys.galois_keys.items()}
        runs.append((max(held), packs, kept, ct.cts[0].data))
    (early, packs, kept, ct), (late, packs2, kept2, ct2) = runs
    assert early < late
    assert packs.keys() == packs2.keys() and kept.keys() == kept2.keys()
    assert all(torch.equal(packs[k], packs2[k]) for k in packs)
    assert all(torch.equal(kept[k], kept2[k]) for k in kept)
    assert torch.equal(ct, ct2)
