"""Bootstrapping: the port's homomorphic DFT tables, ModRaise and circuit
against orion_tpu's.

* `homdft`'s CtS and StC stage matrices and their generalised diagonals
  (3 groups, n = 128) equal orion_tpu's exactly.
* `mod_raise` is bit-exact against orion_tpu's, jitted.
* A full bootstrap with the full-band split-q0 parameters of
  tests/crypto/test_bootstrap.py (LogN 9, LogQ [55, 26], MsgRatio 512,
  ModDegree 255) on the port's CPU path decrypts within that test's 1e-4.
* The bootstrapped ciphertext equals orion_tpu's bit for bit, phase by
  phase, for the full-slot circuit and the sparse one over half the
  slots: orion_tpu's whole jitted bootstrap costs more than 60 s to
  compile on the CPU, so each phase (ModRaise, the CtS chain and the u/v
  extraction; EvalMod and the recombination; the StC chain) runs as
  orion_tpu's own jitted phase program (`runtime/jit.PhaseRunner`) on the
  port's input to that phase, and must give the port's output.  These
  cases use the same parameters at LogN 8 with ModDegree 15 (EvalMod of
  depth 8 in hi-scale mode, where 255 would take 17 levels): the
  bootstrap is then too coarse to decrypt well, but every step of the
  circuit runs, and the chunked hi-scale evaluation of degree >= 32 is
  held against orion_tpu in tests/test_torch_polyeval.py.
* Two queries stacked on a leading axis go through one bootstrap of the
  port, and each equals orion_tpu's bootstrap of that query alone, for
  both circuits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orion_tpu.crypto.homdft as jhomdft
import orion_tpu_torch.crypto.homdft as thomdft
from orion_tpu.crypto.ciphertext import Ciphertext as JCt
from orion_tpu.runtime.jit import enable_module_jit
from orion_tpu.runtime.scheme import Scheme as JScheme
from orion_tpu_torch.runtime.scheme import Scheme as TScheme


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


def _config(logn, mod_degree):
    return {
        "ckks_params": {"LogN": logn, "LogQ": [55, 26], "LogP": [30, 30],
                        "LogScale": 26, "H": 64, "RingType": "Standard"},
        "boot_params": {"CtSLevels": 3, "StCLevels": 3,
                        "ModDegree": mod_degree, "K": 15, "MsgRatio": 512},
        "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True},
    }


@pytest.mark.parametrize("which", ["cts", "stc"])
def test_homdft_tables_equal(which):
    scale = 0.5 if which == "cts" else 1.0
    want = getattr(jhomdft, f"{which}_matrices")(128, 3, scale)
    got = getattr(thomdft, f"{which}_matrices")(128, 3, scale)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert np.array_equal(a.toarray(), b.toarray())
        da, db = thomdft.matrix_diagonals(a), jhomdft.matrix_diagonals(b)
        assert sorted(da) == sorted(db)
        for d in da:
            assert np.array_equal(da[d], db[d])


def _to_jax(ct):
    return JCt(jnp.asarray(ct.data.numpy().astype(np.uint32)), ct.level,
               ct.scale)


def _equal(jct, tct):
    return ((jct.level, jct.scale) == (tct.level, tct.scale)
            and np.array_equal(np.asarray(jct.data).astype(np.int64),
                               tct.data.numpy()))


def _phases(slots_div):
    """Both packages' bootstrapper for ctx.slots // slots_div slots on one
    config and seed, the port's run of one bootstrap recorded phase by
    phase, and orion_tpu's jitted phase runner."""
    cfg = _config(8, 15)
    jsch = JScheme().init_scheme(cfg)
    tsch = TScheme().init_scheme(cfg, device="cpu")
    slots = tsch.ctx.slots // slots_div
    jbtp = jsch.bootstrapper.generate_bootstrapper(slots)
    tbtp = tsch.bootstrapper.generate_bootstrapper(slots)
    assert tbtp.slots == jbtp.slots == slots
    enable_module_jit(jsch)
    x = np.zeros(tsch.ctx.slots)
    x[:slots] = np.random.default_rng(5).uniform(-1, 1, slots)
    cts = []
    for sch in (jsch, tsch):
        pt = sch.encoder.encode(x, level=sch.params.base_level)
        cts.append(sch.encryptor.encrypt(pt).cts[0])
    assert np.array_equal(np.asarray(cts[0].data).astype(np.int64),
                          cts[1].data.numpy())
    rec = {"in": cts[1]}
    # a second query for the batched bootstrap
    x2 = np.zeros(tsch.ctx.slots)
    x2[:slots] = np.random.default_rng(6).uniform(-1, 1, slots)
    rec["in2"] = tsch.encryptor.encrypt(
        tsch.encoder.encode(x2, level=tsch.params.base_level)).cts[0]
    t = rec["pre"] = tbtp._pre(cts[1])
    rec["cts"] = []
    for tr in tbtp.cts_transforms:
        t = tbtp._one_chain(t, tr)
        rec["cts"].append(t)
    rec["u"], rec["v"] = tbtp._extract(t)
    rec["evalmod"] = []
    for c in (rec["u"], rec["v"]):
        rec["evalmod"].append(tbtp._evalmod(c))
    a0 = rec["recombine"] = tbtp._recombine(*rec["evalmod"])
    rec["stc"] = []
    for tr in tbtp.stc_transforms:
        a0 = tbtp._one_chain(a0, tr)
        rec["stc"].append(a0)
    out = rec["out"] = tbtp.bootstrap(cts[1])
    assert torch.equal(out.data, rec["stc"][-1].data)
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield jsch, jbtp, tbtp, rec
    jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module")
def phases():
    """The full-slot circuit's phases (see `_phases`)."""
    yield from _phases(1)


@pytest.fixture(scope="module")
def half_phases():
    """The sparse circuit over half the slots (VGG-11's last stage on
    configs/vgg.yml): a subring trace after ModRaise, half-size CtS and
    StC, the output replicated twice."""
    yield from _phases(2)


def _run(jsch, jbtp, name, fn, *cts):
    # tagged as orion_tpu's own bootstrap tags its phase programs, which
    # it then reuses (test_batched_bootstrap_equals_orion_tpu)
    tag = ("btp", jbtp.slots) + (name if isinstance(name, tuple) else
                                 (name,))
    return jsch.phase_runner.run(tag, jbtp._phase_swaps(), fn,
                                 *[_to_jax(c) for c in cts])


def test_mod_raise_equals_orion_tpu(phases):
    jsch, jbtp, tbtp, rec = phases
    got = tbtp.mod_raise(rec["in"])
    want = _run(jsch, jbtp, "raise", jbtp.mod_raise, rec["in"])
    assert got.level == tbtp.top
    assert _equal(want, got)


def test_fullband_bootstrap_error():
    """tests/crypto/test_bootstrap.py::test_fullband_bootstrap on the
    port's CPU path: x in [-1, 1], max error below 1e-4 at the top of the
    user chain."""
    sch = TScheme().init_scheme(_config(9, 255), device="cpu")
    btp = sch.bootstrapper.generate_bootstrapper(sch.ctx.slots)
    x = np.random.default_rng(23).uniform(-1.0, 1.0, sch.ctx.slots)
    ct = sch.encryptor.encrypt(
        sch.encoder.encode(x, level=sch.params.base_level)).cts[0]
    out = btp.bootstrap(ct)
    assert out.level == sch.params.base_level + sch.params.l_eff
    raw = sch.keys.decrypt_rns(out.data.numpy())
    err = float(np.max(np.abs(sch.enc.decode(raw, out.scale) - x)))
    assert err < 1e-4, err


@pytest.mark.parametrize("phase,slots", [
    pytest.param(phase, slots,
                 id=phase if slots == "full" else f"{phase}-half_slots")
    for slots in ("full", "half")
    for phase in ("raise_cts_extract", "evalmod", "stc")])
def test_bootstrap_phases_equal_orion_tpu(request, phase, slots):
    jsch, jbtp, tbtp, rec = request.getfixturevalue(
        "phases" if slots == "full" else "half_phases")
    if phase == "raise_cts_extract":
        assert _equal(_run(jsch, jbtp, "pre", jbtp._pre, rec["in"]),
                      rec["pre"])
        src = [rec["pre"]] + rec["cts"][:-1]
        for i, (tr, c, want) in enumerate(zip(jbtp.cts_transforms, src,
                                              rec["cts"])):
            got = _run(jsch, jbtp, ("cts", i),
                       lambda c, _tr=tr: jbtp._one_chain(c, _tr), c)
            assert _equal(got, want), f"CtS stage {i}"
        u, v = _run(jsch, jbtp, "extract", jbtp._extract, rec["cts"][-1])
        assert _equal(u, rec["u"]) and _equal(v, rec["v"])
    elif phase == "evalmod":
        for c, want in zip((rec["u"], rec["v"]), rec["evalmod"]):
            assert _equal(_run(jsch, jbtp, "evalmod", jbtp._evalmod, c),
                          want)
        got = _run(jsch, jbtp, "recombine", jbtp._recombine,
                   *rec["evalmod"])
        assert _equal(got, rec["recombine"])
    else:
        src = [rec["recombine"]] + rec["stc"][:-1]
        for i, (tr, c, want) in enumerate(zip(jbtp.stc_transforms, src,
                                              rec["stc"])):
            got = _run(jsch, jbtp, ("stc", i),
                       lambda c, _tr=tr: jbtp._one_chain(c, _tr), c)
            assert _equal(got, want), f"StC stage {i}"


def test_evalmod_pair_equals_single_calls(phases):
    """The port's bootstrap evaluates EvalMod once over u and v stacked on
    a batch axis: item for item the single calls."""
    _, _, tbtp, rec = phases
    u, v = rec["u"], rec["v"]
    pair = tbtp._evalmod(u.with_(data=torch.stack([u.data, v.data])))
    for i, want in enumerate(rec["evalmod"]):
        assert (pair.level, pair.scale) == (want.level, want.scale)
        assert torch.equal(pair.data[i], want.data)


@pytest.mark.parametrize("slots", ["full", "half"])
def test_batched_bootstrap_equals_orion_tpu(request, slots):
    """Two queries stacked on a leading axis, data (2, 2, L, N), through
    one bootstrap of the port: ModRaise (and the subring trace of the
    half-slot circuit), the CtS and StC chains and EvalMod over the query
    axis.  Each query's output equals orion_tpu's bootstrap of that query
    alone bit for bit (its jitted phase programs, which the phase tests
    above compiled), and the first query's equals the port's single
    bootstrap of it."""
    jsch, jbtp, tbtp, rec = request.getfixturevalue(
        "phases" if slots == "full" else "half_phases")
    queries = (rec["in"], rec["in2"])
    out = tbtp.bootstrap(
        rec["in"].with_(data=torch.stack([q.data for q in queries])))
    assert out.data.shape[0] == len(queries)
    single = rec["out"]
    assert (out.level, out.scale) == (single.level, single.scale)
    assert torch.equal(out.data[0], single.data)
    for i, q in enumerate(queries):
        assert _equal(jbtp.bootstrap(_to_jax(q)),
                      out.with_(data=out.data[i])), f"query {i}"


def _flow(cfg, net, data):
    """fit -> compile -> encrypt -> forward -> decrypt on the port's CPU
    path; returns the net's cleartext and decrypted outputs."""
    import orion_tpu_torch as torion
    from orion_tpu_torch.utils import ArrayLoader

    scheme = torion.init_scheme(cfg, device="cpu")
    inp = data[:1]
    net.eval()
    clear = net(inp).numpy().reshape(-1)
    torion.fit(net, ArrayLoader(data, np.zeros(len(data)), batch_size=1))
    level = torion.compile(net)
    net.he()
    out = net(torion.encrypt(torion.encode(inp, level)))
    return scheme, clear, out.decrypt().decode().reshape(-1)[: clear.size]


def test_non_pow2_multict_bootstrap():
    """tests/models/test_multict_bootstrap.py on the port: a hidden width
    of 3 * slots makes a 3-ciphertext tensor, whose bootstrap's plaintext
    grid spans exactly 3 * slots (AlexNet's 12-ciphertext tensors on
    configs/alexnet.yml take the same path); MAE < 0.005."""
    import orion_tpu_torch.nn as on
    from orion_tpu_torch.utils import mae

    cfg = {
        "ckks_params": {"LogN": 9, "LogQ": [29, 26, 26, 26],
                        "LogP": [29, 29], "LogScale": 26, "H": 64,
                        "RingType": "Standard"},
        "boot_params": {"CtSLevels": 3, "StCLevels": 3, "ModDegree": 255,
                        "K": 15},
        "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True,
                  "io_mode": "stream"},
    }

    class WideDeep(on.Module):
        def __init__(self):
            super().__init__()
            self.flatten = on.Flatten()
            self.fc1 = on.Linear(16, 768)
            self.act1 = on.Quad()
            self.fc2 = on.Linear(768, 8)
            self.act2 = on.Quad()
            self.fc3 = on.Linear(8, 4)

        def forward(self, x):
            x = self.act1(self.fc1(self.flatten(x)))
            x = self.act2(self.fc2(x))
            return self.fc3(x)

    net = WideDeep()
    data = np.random.default_rng(2).uniform(-1, 1, (16, 16)).astype(
        np.float32)
    scheme, clear, fhe = _flow(cfg, net, data)
    slots = scheme.ctx.slots
    multict = [m.post_bootstrap for m in net.modules()
               if getattr(m, "post_bootstrap", None) is not None
               and int(np.prod(m.post_bootstrap.fhe_input_shape)) > slots]
    assert multict, "expected a bootstrap on a multi-ciphertext tensor"
    n_cts = -(-int(np.prod(multict[0].fhe_input_shape)) // slots)
    assert n_cts == 3
    assert multict[0].slot_count == n_cts * slots
    assert mae(clear, fhe) < 0.005


def test_post_bootstrap_scale_alignment():
    """tests/models/test_post_bootstrap_scale.py on the port: a ReLU whose
    minimax sign chain is deeper than the modulus chain (l_eff 8) gets a
    bootstrap inside the sign chain, and the refreshed ciphertext runs
    above the planned levels of the modules after it.  No scale mismatch,
    MAE < 0.005."""
    import orion_tpu_torch.nn as on
    from orion_tpu_torch.utils import mae

    cfg = {
        "ckks_params": {"LogN": 9, "LogQ": [29] + [26] * 8,
                        "LogP": [29, 29], "LogScale": 26, "H": 64,
                        "RingType": "Standard"},
        "boot_params": {"CtSLevels": 3, "StCLevels": 3, "ModDegree": 255,
                        "K": 15},
        "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True,
                  "io_mode": "stream"},
    }

    class TinyReLUNet(on.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = on.Linear(16, 16)
            self.act = on.ReLU()
            self.fc2 = on.Linear(16, 4)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    net = TinyReLUNet()
    data = np.random.default_rng(0).uniform(-1, 1, (64, 16)).astype(
        np.float32)
    _, clear, fhe = _flow(cfg, net, data)
    placed = [name for name, m in net.named_modules()
              if getattr(m, "post_bootstrap", None) is not None]
    assert any("sign.acts" in name for name in placed), placed
    assert mae(clear, fhe) < 0.005
