"""The cleartext trainer of the port (orion_tpu_torch/train.py) against
orion_tpu's (orion_tpu/train.py).

Two nets: orion_tpu's `TinyNet` of tests/test_train.py (Flatten, Linear,
BatchNorm1d, ReLU, Linear) and a narrow conv net with Conv2d,
BatchNorm2d, AvgPool2d, SiLU, Add, Flatten and Linear.  Weights come from
explicit numpy draws onto orion_tpu's net and cross with
`load_jax_params`; both trainers take 2 SGD steps (momentum 0.9, weight
decay 5e-4) on the same batches, the port on device="cpu".

Checks: parameters and BatchNorm running statistics after the steps
agree within 1e-5 relative to each tensor's largest entry (float32 sums
in another order: orion_tpu's XLA convolutions against PyTorch's); a
checkpoint written by either package loads in the other and gives the
same forward; the functional forward before training equals the
module's own cleartext forward; the loss decreases (orion_tpu's
test_loss_decreases, run through the port).
"""

import numpy as np
import pytest
import torch

import orion_tpu.nn as jon
import orion_tpu.train as jtrain
import orion_tpu_torch.nn as ton
import orion_tpu_torch.train as ttrain
from orion_tpu_torch.models import load_jax_params

from .test_torch_mlp import seed_jax_net

# relative to each tensor's largest entry: float32 sums in another order
RTOL = 1e-5


def tiny_net(on):
    """orion_tpu's TinyNet (tests/test_train.py)."""
    class TinyNet(on.Module):
        def __init__(self):
            super().__init__()
            self.flatten = on.Flatten()
            self.fc1 = on.Linear(8, 8)
            self.bn1 = on.BatchNorm1d(8)
            self.act1 = on.ReLU()
            self.fc2 = on.Linear(8, 3)

        def forward(self, x):
            x = self.flatten(x)
            x = self.act1(self.bn1(self.fc1(x)))
            return self.fc2(x)

    return TinyNet()


def conv_net(on):
    class ConvNet(on.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = on.Conv2d(2, 4, 3, padding=1)
            self.bn1 = on.BatchNorm2d(4)
            self.act1 = on.SiLU(degree=7)
            self.pool = on.AvgPool2d(2)
            self.conv2 = on.Conv2d(4, 4, 3, padding=1, stride=1)
            self.add = on.Add()
            self.flatten = on.Flatten()
            self.fc = on.Linear(4 * 4 * 4, 5)

        def forward(self, x):
            x = self.pool(self.act1(self.bn1(self.conv1(x))))
            x = self.add(x, self.conv2(x))
            return self.fc(self.flatten(x))

    return ConvNet()


def loader(rng, shape, classes, n_batches=2, batch=16):
    w = rng.normal(size=(int(np.prod(shape)), classes))
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(batch,) + shape).astype(np.float32)
        y = np.argmax(x.reshape(batch, -1) @ w, axis=-1).astype(np.int64)
        out.append((x, y))
    return out


def both(build, seed):
    rng = np.random.default_rng(seed)
    jnet = build(jon)
    params = seed_jax_net(jnet, rng)
    tnet = build(ton)
    load_jax_params(tnet, params)
    return jnet, tnet, rng


def assert_close(a, b, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-30)
    err = float(np.max(np.abs(a - b))) / scale
    assert err <= RTOL, (what, err)


def assert_nets_agree(jnet, tnet):
    for name, m in jnet.named_modules():
        tm = dict(tnet.named_modules())[name]
        for attr in ("weight", "bias"):
            p = getattr(m, attr, None)
            if p is not None and hasattr(p, "data"):
                assert_close(getattr(tm, attr).detach().numpy(), p.data,
                             f"{name}.{attr}")
        if hasattr(m, "running_mean"):
            assert_close(tm.running_mean.numpy(), m.running_mean,
                         f"{name}.running_mean")
            assert_close(tm.running_var.numpy(), m.running_var,
                         f"{name}.running_var")


@pytest.mark.parametrize("build,shape,classes", [
    (tiny_net, (8,), 3), (conv_net, (2, 8, 8), 5)],
    ids=["TinyNet", "ConvNet"])
def test_two_steps_equal_orion_tpu(build, shape, classes):
    jnet, tnet, rng = both(build, 21)
    data = loader(rng, shape, classes)
    # the functional forward before training is the module's own forward
    apply, params, state, _ = ttrain.build_functional(tnet, data[0][0],
                                                      device="cpu")
    tnet.eval()
    want = tnet(data[0][0]).numpy()
    got = apply(params, state, data[0][0], train=False)[0]
    assert_close(got.detach().numpy(), want, "functional forward")

    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    jtrain.train(jnet, data, epochs=1, lr=0.05, log_every=0)
    ttrain.train(tnet, data, epochs=1, lr=0.05, log_every=0, device="cpu")
    assert_nets_agree(jnet, tnet)
    # the steps moved every weight and running statistic
    after = tnet.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items()
               if not k.startswith("pool.")), before.keys()


def test_checkpoints_cross_both_ways(tmp_path):
    jnet, tnet, rng = both(tiny_net, 5)
    data = loader(rng, (8,), 3)
    jtrain.train(jnet, data, epochs=1, log_every=0)
    ttrain.train(tnet, data, epochs=1, log_every=0, device="cpu")
    sample = data[0][0]
    japply, jparams, jstate, _ = jtrain.build_functional(jnet, sample)
    tapply, tparams, tstate, tmods = ttrain.build_functional(
        tnet, sample, device="cpu")

    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jtrain.save_checkpoint(jparams, jpath)
    ttrain.save_checkpoint(tparams, tpath)
    # orion_tpu's checkpoint into the port, the port's into orion_tpu
    from_j = ttrain.load_checkpoint(jpath)
    from_t = jtrain.load_checkpoint(tpath)
    assert set(from_j) == set(tparams) and set(from_t) == set(jparams)
    for name in tparams:
        assert set(from_j[name]) == set(tparams[name])
        for k in tparams[name]:
            assert_close(from_j[name][k], tparams[name][k].detach().numpy(),
                         f"{name}/{k}")
            assert_close(from_t[name][k], np.asarray(jparams[name][k]),
                         f"{name}/{k}")

    fresh = tiny_net(ton)
    fapply, fparams, fstate, fmods = ttrain.build_functional(
        fresh, sample, device="cpu")
    ttrain.write_back(fresh, from_j, tstate, fmods)
    fapply, fparams, fstate, _ = ttrain.build_functional(
        fresh, sample, device="cpu")
    out, _ = fapply(fparams, fstate, sample)
    jout, _ = japply(jparams, jstate, sample, train=False)
    assert_close(out.detach().numpy(), np.asarray(jout), "forward")


def test_loss_decreases():
    """orion_tpu's test_loss_decreases through the port's trainer."""
    rng = np.random.default_rng(7)
    net = tiny_net(ton)
    data = loader(rng, (8,), 3, n_batches=8, batch=32)
    sample = data[0][0]

    def loss_of():
        apply, params, state, _ = ttrain.build_functional(net, sample,
                                                          device="cpu")
        with torch.no_grad():
            return float(np.mean([
                torch.nn.functional.cross_entropy(
                    apply(params, state, x)[0], torch.as_tensor(y))
                for x, y in data]))

    before = loss_of()
    ttrain.train(net, data, epochs=2, lr=0.05, log_every=0, device="cpu")
    assert loss_of() < before


def test_unsupported_leaf_raises():
    class Bare(ton.Module):
        def forward(self, x):
            return x

    class Net(ton.Module):
        def __init__(self):
            super().__init__()
            self.odd = Bare()

        def forward(self, x):
            return self.odd(x)

    with pytest.raises(NotImplementedError):
        ttrain.build_functional(Net(), np.zeros((2, 3), np.float32),
                                device="cpu")
