"""Device buffers and io_mode: stream (orion_tpu_torch/runtime/buffers.py)
against orion_tpu's (orion_tpu/runtime/buffers.py).

The narrow conv net of tests/test_torch_diagnostics.py (a stride-2 conv
whose Linear reads a gap-2 layout, BatchNorm fused, Quad, Flatten) on its
LogN-9 chain, compiled by both packages from the same weights.

Checks: for every leaf module the port's `collect_swappables` lists the
buffers orion_tpu's lists, in the same order, with the same residue
shapes and `pin_device` flags; orion_tpu's lists also hold the Shoup
companions of the diagonals (`pts_shoup`) and the four-step transform's
Shoup and stacked tables (`t4_*_sh`, `t4_rowstack`, `t4_lanestack`),
which the port does not keep, and the comparison leaves those out.
`hbm_report` has the same module keys.  With io_mode: stream on
device="cpu", compile spills every buffer that is not pinned into a
separate host tensor; forwards with a promotion budget of 0, of part of
the buffers and of all of them give the output ciphertexts of io_mode:
none bit for bit; promotion follows the modules' first-touch order and
stays under the budget.
"""

import pytest

import orion_tpu as jorion
import orion_tpu_torch.nn as ton
from orion_tpu.runtime import buffers as jbuffers
from orion_tpu_torch.runtime import buffers as tbuffers
from orion_tpu_torch.runtime.scheme import Scheme

from .test_torch_diagnostics import (CONFIG, _loader, seeded_nets,
                                     tiny_conv_net)

STREAM = {**CONFIG, "orion": {**CONFIG["orion"], "io_mode": "stream"}}


def port_flow(cfg, tnet, data):
    """A fresh port scheme on the CPU: fit, compile, one encryption of the
    first image (the first draw after the keys, so every flow gets the
    same ciphertext)."""
    scheme = Scheme().init_scheme(cfg, device="cpu")
    tnet.eval()
    scheme.fit(tnet, _loader(data))
    level = scheme.compile(tnet)
    ct = scheme.encrypt(scheme.encode(data[:1], level))
    tnet.he()
    return scheme, ct


@pytest.fixture(scope="module")
def compiled():
    jnet, tnet, data = seeded_nets()
    jscheme = jorion.init_scheme(CONFIG)
    jnet.eval()
    jorion.fit(jnet, _loader(data))
    jorion.compile(jnet)
    tscheme, ct = port_flow(CONFIG, tnet, data)
    out = tnet(ct)
    return (jnet, jscheme), (tnet, tscheme), out, data


def stream_flow(compiled):
    """The compiled net's weights in a fresh port net, through a fresh
    scheme with io_mode: stream."""
    _, (tnet, _), _, data = compiled
    net = tiny_conv_net(ton)
    net.load_state_dict(tnet.state_dict())
    scheme, ct = port_flow(STREAM, net, data)
    return net, scheme, ct


def _leaves(net):
    return [(n, m) for n, m in net.named_modules() if m.is_leaf()]


def test_swappables_equal_orion_tpu(compiled):
    (jnet, jscheme), (tnet, tscheme), _, _ = compiled
    jleaves, tleaves = _leaves(jnet), _leaves(tnet)
    assert [n for n, _ in jleaves] == [n for n, _ in tleaves]
    for (name, jm), (_, tm) in zip(jleaves, tleaves):
        companions = {id(tr.pts_shoup)
                      for tr in getattr(jm, "compiled", {}).values()}
        companions |= {id(jscheme.ctx.dev[k]) for k in jscheme.ctx.t4_keys
                       if k not in tscheme.ctx.t4_keys}
        want = [(tuple(v.shape), sw.pin_device)
                for sw in jbuffers.collect_swappables(jscheme, jm)
                for v in [sw.getter()] if id(v) not in companions]
        got = [(tuple(sw.getter().shape), sw.pin_device)
               for sw in tbuffers.collect_swappables(tscheme, tm)]
        assert got == want, name
    assert any(len(getattr(m, "compiled", {})) for _, m in tleaves)
    assert any(getattr(m, "_pack_keys", ()) for _, m in tleaves)

    jrep = jbuffers.hbm_report(jscheme, jnet)
    trep = tbuffers.hbm_report(tscheme, tnet)
    assert list(trep["per_module"]) == list(jrep["per_module"])
    assert trep["total"] == sum(trep["per_module"].values()) > 0


def _same_cts(a, b):
    return len(a.cts) == len(b.cts) and all(
        (x.level, x.scale) == (y.level, y.scale) and x.data.equal(y.data)
        for x, y in zip(a.cts, b.cts))


def test_stream_spills_and_equals_none(compiled):
    want = compiled[2]
    net, scheme, ct = stream_flow(compiled)
    runner = scheme.module_runner
    assert isinstance(runner, tbuffers.StreamRunner)

    # every buffer that is not pinned was spilled into its own host tensor
    spilled = {}
    for _, m in _leaves(net):
        for sw in tbuffers.collect_swappables(scheme, m):
            v = sw.getter()
            assert runner.is_spilled(v) != sw.pin_device
            if not sw.pin_device:
                spilled[id(v)] = v
    assert set(spilled) == set(runner.host)
    assert len({v.data_ptr() for v in spilled.values()}) == len(spilled)
    assert scheme.spilled_bytes == sum(v.nbytes for v in spilled.values())

    runner.budget = 0
    out = net(ct)
    assert _same_cts(out, want)
    assert runner.promoted == [] and set(runner.host) == set(spilled)
    assert runner.uploaded_bytes >= scheme.spilled_bytes


def test_promotion_budget(compiled):
    want = compiled[2]
    net, scheme, ct = stream_flow(compiled)
    runner = scheme.module_runner
    order = [n for n, _ in _leaves(net)]

    runner.budget = scheme.spilled_bytes // 2
    assert _same_cts(net(ct), want)
    assert runner.promoted and runner.resident_bytes <= runner.budget
    assert runner.resident_bytes == sum(b for _, b in runner.promoted)
    pos = [order.index(n) for n, _ in runner.promoted]
    assert pos == sorted(pos)          # first-touch (execution) order
    assert runner.host                 # the rest still streams

    runner.budget = float("inf")
    assert _same_cts(net(ct), want)
    assert not runner.host and \
        runner.resident_bytes == scheme.spilled_bytes
    runner.uploaded_bytes = 0
    assert _same_cts(net(ct), want)
    assert runner.uploaded_bytes == 0
