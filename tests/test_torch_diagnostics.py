"""The noise profiler (orion_tpu_torch/diagnostics.py) against orion_tpu's
(orion_tpu/diagnostics.py).

A narrow conv net without bootstrap (Conv2d with stride 2, so its output
sits at gap 2, BatchNorm2d, Quad, Flatten, Linear) on a LogN-9 chain of
4 Q primes.  Weights and BatchNorm statistics come from
an explicit numpy draw onto orion_tpu's net and cross with
`load_jax_params`.  Both packages fit, compile and profile one input:
orion_tpu under its per-module jit (`enable_module_jit`), the port on
device="cpu".  The keys and the encryption come from the same seed, so
the encrypted stages are equal ciphertexts.

Checks: the same records (names, kinds, planned and ciphertext levels,
scale bits) in the same order, every error within 1e-9 of orion_tpu's
plus 2^-22 of the stage's magnitude (the clear forwards are float32
sums in another order),
a final error under the MAE bound, `write_noise_report` with orion_tpu's
keys, and a profiled forward whose output equals an unprofiled forward's
on the same ciphertext bit for bit.
"""

import numpy as np
import pytest

import orion_tpu as jorion
import orion_tpu.nn as jon
import orion_tpu_torch as torion
import orion_tpu_torch.nn as ton
from orion_tpu.diagnostics import noise_profile as jprofile
from orion_tpu.diagnostics import write_noise_report as jreport
from orion_tpu.runtime.jit import aot_precompile_forward, enable_module_jit
from orion_tpu_torch.diagnostics import noise_profile as tprofile
from orion_tpu_torch.diagnostics import write_noise_report as treport
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.utils import ArrayLoader

from .test_torch_mlp import seed_jax_net

CONFIG = {
    "ckks_params": {"LogN": 9, "LogQ": [29, 26, 26, 26],
                    "LogP": [29, 29], "LogScale": 26, "H": 64,
                    "RingType": "Standard"},
    "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True,
              "io_mode": "none"},
}


def tiny_conv_net(on):
    class TinyConvNet(on.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = on.Conv2d(1, 2, 3, padding=1, stride=2)
            self.bn0 = on.BatchNorm2d(2)
            self.act0 = on.Quad()
            self.flatten = on.Flatten()
            self.fc = on.Linear(2 * 4 * 4, 4)

        def forward(self, x):
            x = self.act0(self.bn0(self.conv0(x)))
            return self.fc(self.flatten(x))

    return TinyConvNet()


def seeded_nets(seed=3):
    """orion_tpu's and the port's TinyConvNet with the same explicit
    weights, the fit data and one input."""
    rng = np.random.default_rng(seed)
    jnet = tiny_conv_net(jon)
    params = seed_jax_net(jnet, rng)
    for name in ("conv0",):
        w = getattr(jnet, name).weight
        w.data = (w.data / np.sqrt(np.prod(w.data.shape[1:]))
                  ).astype(np.float32)
        params[f"{name}.weight"] = w.data
    tnet = tiny_conv_net(ton)
    load_jax_params(tnet, params)
    data = rng.uniform(0, 1, (16, 1, 8, 8)).astype(np.float32)
    return jnet, tnet, data


def _loader(data):
    return ArrayLoader(data, np.zeros(len(data)), batch_size=1)


@pytest.fixture(scope="module")
def compiled():
    """Both nets fitted and compiled."""
    jnet, tnet, data = seeded_nets()
    jscheme = jorion.init_scheme(CONFIG)
    jnet.eval()
    jorion.fit(jnet, _loader(data))
    jlevel = jorion.compile(jnet)

    tscheme = torion.init_scheme(CONFIG, device="cpu")
    tnet.eval()
    torion.fit(tnet, _loader(data))
    tlevel = torion.compile(tnet)
    return (jnet, jscheme, jlevel), (tnet, tscheme, tlevel), data[:1]


@pytest.fixture(scope="module")
def profiles(compiled):
    (jnet, jscheme, jlevel), (tnet, tscheme, tlevel), inp = compiled
    # orion_tpu's module programs, compiled ahead in a thread pool and
    # reused by its profile
    enable_module_jit(jscheme)
    try:
        jnet.he()
        aot_precompile_forward(jnet, jscheme, jscheme.encrypt(
            jscheme.encode(inp, jlevel)), workers=4)
        jrec = jprofile(jnet, jscheme, inp, jlevel)
    finally:
        jscheme.module_runner = None
    # the port encrypts once more too, so both profiles encrypt with the
    # same draws
    tscheme.encrypt(tscheme.encode(inp, tlevel))
    trec = tprofile(tnet, tscheme, inp, tlevel)
    return jrec, trec, (tnet, tscheme, inp, tlevel)


def test_same_plan(compiled):
    """Both packages place the stages at the same levels and layouts."""
    (jnet, _, jlevel), (tnet, _, tlevel), _ = compiled
    assert jlevel == tlevel
    for (name, j), (_, t) in zip(jnet.named_modules(),
                                 tnet.named_modules()):
        assert (j.level, j.output_gap if hasattr(j, "output_gap") else 1) \
            == (t.level, t.output_gap if hasattr(t, "output_gap") else 1), \
            name


def test_records_equal_orion_tpu(profiles):
    jrec, trec, _ = profiles
    keys = ("name", "kind", "level_in_plan", "ct_level", "scale_bits")
    assert [tuple(r[k] for k in keys) for r in trec] == \
        [tuple(r[k] for k in keys) for r in jrec]
    assert [r["name"] for r in trec] == ["conv0", "bn0", "act0", "flatten",
                                         "fc"]
    for t, j in zip(trec, jrec):
        # the decryptions are equal; the clear values are float32 sums in
        # another order (XLA's against PyTorch's), a few float32 roundings
        # of the stage's magnitude apart
        tol = 1e-9 + 2 ** -22 * j["clear_absmax"]
        for k in ("max_err", "rms_err", "clear_absmax"):
            assert abs(t[k] - j[k]) <= tol, (t["name"], k, t[k], j[k])
        assert np.isfinite(t["max_err"])
        # bn0 is fused into conv0, so conv0's ciphertext holds conv + BN
        # while its clear record is the conv alone (in both packages); from
        # bn0 on the stages compare like with like
        if t["name"] != "conv0":
            assert t["max_err"] < 1e-2, t
    # conv0's stride-2 output sits at gap 2: compared through mux_slots
    assert tnet_gap(profiles) == 2


def tnet_gap(profiles):
    return profiles[2][0].conv0.output_gap


def test_report_has_orion_tpu_keys(profiles, tmp_path):
    jrec, trec, _ = profiles
    t = treport(trec, str(tmp_path / "t.json"), meta={"model": "tiny"})
    j = jreport(jrec, str(tmp_path / "j.json"), meta={"model": "tiny"})
    assert list(t) == list(j)
    assert t["stages"] == len(trec) and t["bootstraps"] == 0
    assert t["worst_stage"]["name"] == j["worst_stage"]["name"]
    assert t["final_max_err"] < 0.005


def test_profiled_forward_changes_no_bit(profiles):
    _, _, (tnet, tscheme, inp, level) = profiles
    ct = tscheme.encrypt(tscheme.encode(inp, level))
    tnet.he()
    want = tnet(ct)
    seen = []
    forward = tnet.forward

    def recorded(x):
        seen.append(forward(x))
        return seen[-1]

    tnet.forward = recorded
    try:
        tprofile(tnet, tscheme, inp, level, ctxt=ct)
    finally:
        del tnet.forward
    assert len(seen) == 2           # the clear pass, then the encrypted
    got = seen[-1]
    assert len(got.cts) == len(want.cts)
    for a, b in zip(got.cts, want.cts):
        assert (a.level, a.scale) == (b.level, b.scale)
        assert a.data.equal(b.data)
