"""The port's counterpart of orion_tpu's PallasNTT, bit for bit.

As tests/crypto/test_ntt_pallas.py runs orion_tpu's: at LogN 8, on limb
rows [0, 1], the port's `PallasNTT.ntt` equals orion_tpu's `PallasNTT.ntt`
(interpret mode) and `crypto/ntt.py` `ntt`; its `intt` equals orion_tpu's
`PallasNTT.intt`, and the round trip is the identity.  On CPU tensors the
port runs the plain versions of the `ntt_fwd` / `ntt_inv` kernels.
"""

import numpy as np
import pytest
import torch

from orion_tpu.crypto import CKKSContext as JContext
from orion_tpu.crypto.keyswitch import dev_level
from orion_tpu.crypto.ntt import ntt as jntt
from orion_tpu.crypto.ntt_pallas import PallasNTT as JPallasNTT
from orion_tpu_torch.crypto.context import CKKSContext as TContext
from orion_tpu_torch.crypto.ntt_pallas import PallasNTT

CHAIN = dict(logn=8, logq=[29, 26], logp=[29], logscale=26, h=32)
ROWS = [0, 1]


@pytest.fixture(scope="module")
def setup():
    jctx, tctx = JContext(**CHAIN), TContext(**CHAIN, device="cpu")
    rng = np.random.default_rng(9)
    a = np.stack([rng.integers(0, jctx.primes[i], jctx.n) for i in ROWS])
    return jctx, tctx, a


def test_ntt_matches(setup):
    jctx, tctx, a = setup
    got = PallasNTT(tctx).ntt(torch.as_tensor(a), ROWS).numpy()
    ja = a.astype(np.uint32)
    want = np.asarray(JPallasNTT(jctx).ntt(ja, ROWS)).astype(np.int64)
    assert np.array_equal(got, want)
    dl = dev_level(jctx, jctx.max_level)
    assert np.array_equal(got, np.asarray(
        jntt(ja, dl.q_tw, dl.q_tw_shoup, dl.q_p)).astype(np.int64))


def test_intt_matches_and_round_trips(setup):
    jctx, tctx, a = setup
    tpn = PallasNTT(tctx)
    fwd = tpn.ntt(torch.as_tensor(a), ROWS)
    back = tpn.intt(fwd, ROWS).numpy()
    assert np.array_equal(back, a)
    want = np.asarray(JPallasNTT(jctx).intt(
        fwd.numpy().astype(np.uint32), ROWS)).astype(np.int64)
    assert np.array_equal(back, want)
