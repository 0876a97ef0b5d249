"""Conv2d and BatchNorm2d of the PyTorch port against orion_tpu.

Packing is numpy in both packages, so it must agree exactly: for a strided
ungrouped and a strided grouped conv, each at input gap 1 and gap 2, the
sparse conv matrix, the packed diagonals and the conv bias vector are
equal, and so are the BatchNorm2d vectors at both gaps.  The layers are
plain namespaces carrying the attributes fit gives a layer, with weights
from a numpy seed.  The cleartext forwards (torch conv2d against
lax.conv_general_dilated) agree within 1e-5.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import orion_tpu.nn as jon
import orion_tpu_torch.nn as ton
from orion_tpu.compiler import packing as jpack
from orion_tpu_torch.compiler import packing as tpack

SLOTS = 128
CASES = [(groups, gap) for groups in (1, 2) for gap in (1, 2)]


def _conv_layer(groups, gap, rng):
    """A stride-2 3x3 conv, 4 -> 8 channels, over a 4-channel 8x8 input
    that sits at `gap` in its FHE grid; the attributes fit would set."""
    ci, co, k, s, pad, h = 4, 8, 3, 2, 1, 8
    tconv = ton.Conv2d(ci, co, k, stride=s, padding=pad, groups=groups)
    jconv = jon.Conv2d(ci, co, k, stride=s, padding=pad, groups=groups)
    ho = (h + 2 * pad - k) // s + 1
    in_shape, out_shape = (1, ci, h, h), (1, co, ho, ho)
    fhe_in = (1, math.ceil(ci / gap ** 2), h * gap, h * gap)
    shapes = [m.compute_fhe_output_shape(
        input_gap=gap, input_shape=in_shape, clear_output_shape=out_shape)
        for m in (tconv, jconv)]
    assert tuple(shapes[0]) == tuple(shapes[1])
    return SimpleNamespace(
        in_channels=ci, groups=groups, padding=(pad, pad), dilation=(1, 1),
        input_gap=gap, output_gap=tconv.compute_fhe_output_gap(input_gap=gap),
        input_shape=in_shape, output_shape=out_shape, fhe_input_shape=fhe_in,
        fhe_output_shape=tuple(shapes[0]),
        on_weight=rng.standard_normal((co, ci // groups, k, k)
                                      ).astype(np.float32),
        on_bias=rng.standard_normal(co).astype(np.float32),
        scheme=SimpleNamespace(params=SimpleNamespace(
            slots=SLOTS, embedding_method="hybrid")))


@pytest.mark.parametrize("groups,gap", CASES)
def test_conv_packing_equal(groups, gap):
    layer = _conv_layer(groups, gap, np.random.default_rng(10 * groups + gap))
    if groups > 1:
        weight = tpack.grouped_weight(layer)
        assert np.array_equal(weight, jpack.grouped_weight(layer))
    else:
        weight = layer.on_weight.astype(np.float64)
    tmat, jmat = tpack.conv_matrix(layer, weight), jpack.conv_matrix(layer,
                                                                     weight)
    assert tmat.shape == jmat.shape and (tmat != jmat).nnz == 0
    assert tmat.nnz > 0

    (tdiag, trot), (jdiag, jrot) = (tpack.pack_conv2d(layer, False),
                                    jpack.pack_conv2d(layer, False))
    assert trot == jrot
    assert sorted(tdiag) == sorted(jdiag)
    for key in jdiag:
        assert sorted(tdiag[key]) == sorted(jdiag[key])
        for d, vec in jdiag[key].items():
            assert np.array_equal(tdiag[key][d], vec)

    assert np.array_equal(tpack.construct_conv2d_bias(layer),
                          jpack.construct_conv2d_bias(layer))


@pytest.mark.parametrize("gap", [1, 2])
def test_bn2d_packing_equal(gap):
    rng = np.random.default_rng(gap)
    c, h = 8, 4
    bn = SimpleNamespace(
        input_shape=(1, c, h, h), input_gap=gap,
        fhe_input_shape=(1, math.ceil(c / gap ** 2), h * gap, h * gap),
        on_running_mean=rng.uniform(-0.2, 0.2, c).astype(np.float32),
        on_running_var=rng.uniform(0.5, 1.5, c).astype(np.float32),
        on_weight=rng.standard_normal(c).astype(np.float32),
        on_bias=rng.standard_normal(c).astype(np.float32),
        eps=1e-5, affine=True)
    for got, want in zip(tpack.pack_bn2d(bn), jpack.pack_bn2d(bn)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("groups", [1, 2])
def test_cleartext_forwards_agree(groups):
    rng = np.random.default_rng(5 + groups)
    jconv = jon.Conv2d(4, 8, 5, stride=2, padding=2, groups=groups)
    tconv = ton.Conv2d(4, 8, 5, stride=2, padding=2, groups=groups)
    jbn, tbn = jon.BatchNorm2d(8), ton.BatchNorm2d(8)
    w = rng.standard_normal(jconv.weight.data.shape).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    jconv.weight.data, jconv.bias.data = w, b
    stats = {"running_mean": rng.uniform(-0.2, 0.2, 8),
             "running_var": rng.uniform(0.5, 1.5, 8),
             "weight": rng.standard_normal(8), "bias": rng.standard_normal(8)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    jbn.running_mean, jbn.running_var = (stats["running_mean"],
                                         stats["running_var"])
    jbn.weight.data, jbn.bias.data = stats["weight"], stats["bias"]
    tconv.load_state_dict({"weight": torch.from_numpy(w),
                           "bias": torch.from_numpy(b)})
    tbn.load_state_dict({k: torch.from_numpy(v) for k, v in stats.items()})
    for m in (jconv, tconv, jbn, tbn):
        m.eval()

    x = rng.uniform(0, 1, (2, 4, 12, 12)).astype(np.float32)
    jout, tout = jconv(x), tconv(x)
    assert tuple(tout.shape) == (2, 8, 6, 6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tbn(tout).numpy(),
                               np.asarray(jbn(np.asarray(jout))), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", ["LeNet", "LoLA"])
def test_models_cleartext_agree(name):
    """The port's LeNet and LoLA carry orion_tpu's weights (OIHW convs,
    BatchNorm2d statistics) through load_jax_params and give its
    cleartext outputs."""
    import orion_tpu.models as jmodels
    import orion_tpu_torch.models as tmodels

    rng = np.random.default_rng(3)
    jnet, tnet = getattr(jmodels, name)(), getattr(tmodels, name)()
    params = {}
    for mname, m in jnet.named_modules():
        for attr in ("weight", "bias"):
            p = getattr(m, attr, None)
            if p is not None and hasattr(p, "data"):
                params[f"{mname}.{attr}"] = p.data
        if hasattr(m, "running_mean"):
            m.running_mean = rng.uniform(-0.2, 0.2, m.num_features
                                         ).astype(np.float32)
            m.running_var = rng.uniform(0.5, 1.5, m.num_features
                                        ).astype(np.float32)
            params[f"{mname}.running_mean"] = m.running_mean
            params[f"{mname}.running_var"] = m.running_var
    tmodels.load_jax_params(tnet, params)
    jnet.eval()
    tnet.eval()
    x = rng.uniform(0, 1, (2, 1, 28, 28)).astype(np.float32)
    want = np.asarray(jnet(x))
    assert want.shape == (2, 10)
    np.testing.assert_allclose(tnet(x).numpy(), want, atol=1e-5, rtol=0)
