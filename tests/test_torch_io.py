"""Key and diagonal I/O (`io_mode: save` / `load`, `runtime/io.py`) and
the example scripts, on the CPU.

The narrow MLP of tests/test_torch_mlp.py on configs/mlp.yml at LogN 10
(H 64), on weights drawn from a numpy seed and carried across to the port:

* the port compiles it with `io_mode: save`, encrypts an input and runs
  the forward; a fresh scheme with `io_mode: load` compiles it again
  from the archives (no key generated, no layer packed) and its forward
  of the same ciphertext equals the saved run's bit for bit;
* orion_tpu compiles the same net with `io_mode: save` to HDF5 files:
  every dataset and attribute there equals the member of the same name in
  the port's numpy archives (`P@A` for the attribute A of P), and the
  port writes nothing else;
* a secret key saved under other parameters, rotation keys of another
  secret key and diagonals saved under other parameters are refused with
  orion_tpu's messages.

And `python -m orion_tpu_torch.examples.run_mlp --cpu` on that config.
"""

from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml

import orion_tpu as jorion
import orion_tpu.nn as jon
import orion_tpu_torch as torion
import orion_tpu_torch.nn as ton
from orion_tpu_torch.compiler import packing
from orion_tpu_torch.crypto.keys import KeyChest
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.runtime import io
from orion_tpu_torch.runtime.tensors import CipherTensor
from orion_tpu_torch.utils import ArrayLoader, mae

from .test_torch_mlp import narrow_mlp, seed_jax_net

CONFIG = Path(__file__).parent.parent / "configs" / "mlp.yml"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops on the plain path: one intra-op thread (see
    tests/test_torch_resnet.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def small_config(**orion):
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["ckks_params"]["LogN"] = 10
    cfg["ckks_params"]["H"] = 64
    cfg["orion"].update(orion)
    return cfg


def port_compile(cfg, params, loader):
    scheme = torion.init_scheme(cfg, device="cpu")
    net = narrow_mlp(ton)
    load_jax_params(net, params)
    net.eval()
    torion.fit(net, loader)
    return scheme, net, torion.compile(net)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    paths = {"npz": (str(d / "keys.npz"), str(d / "diags.npz")),
             "h5": (str(d / "keys.h5"), str(d / "diags.h5"))}
    rng = np.random.default_rng(11)
    jnet = narrow_mlp(jon)
    params = seed_jax_net(jnet, rng)
    x_fit = rng.uniform(0, 1, (32, 1, 8, 8)).astype(np.float32)
    loader = ArrayLoader(x_fit, np.zeros(len(x_fit)), batch_size=1)
    x = rng.uniform(0, 1, (1, 1, 8, 8)).astype(np.float32)

    keys, diags = paths["h5"]
    jorion.init_scheme(small_config(io_mode="save", keys_path=keys,
                                    diags_path=diags))
    jnet.eval()
    jorion.fit(jnet, loader)
    jorion.compile(jnet)

    keys, diags = paths["npz"]
    _, net, level = port_compile(small_config(
        io_mode="save", keys_path=keys, diags_path=diags), params, loader)
    clear = net(x).numpy().reshape(-1)
    ct = torion.encrypt(torion.encode(x, level))
    net.he()
    out_save = net(ct)

    made = {"keys": 0, "packed": 0}
    gen_ksk, pack_linear = KeyChest._gen_ksk, packing.pack_linear

    def counted_ksk(self, s):
        made["keys"] += 1
        return gen_ksk(self, s)

    def counted_pack(*a, **kw):
        made["packed"] += 1
        return pack_linear(*a, **kw)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(KeyChest, "_gen_ksk", counted_ksk)
        m.setattr(packing, "pack_linear", counted_pack)
        scheme, net2, level2 = port_compile(small_config(
            io_mode="load", keys_path=keys, diags_path=diags), params,
            loader)
    assert level2 == level
    net2.he()
    out_load = net2(CipherTensor(scheme, ct.cts, ct.shape, ct.on_shape))
    fhe = out_load.decrypt().decode().reshape(-1)[: clear.size]
    return dict(paths=paths, params=params, loader=loader, made=made,
                out_save=out_save, out_load=out_load, mae=mae(clear, fhe))


def test_save_then_load_gives_equal_ciphertexts(runs):
    a, b = runs["out_save"], runs["out_load"]
    assert len(a.cts) == len(b.cts)
    for x, y in zip(a.cts, b.cts):
        assert (x.level, x.scale) == (y.level, y.scale)
        assert torch.equal(x.data, y.data)
    # the load compile read every key and layer: only __init__'s
    # relinearisation key was generated (and replaced by the saved one)
    assert runs["made"] == {"keys": 1, "packed": 0}
    assert runs["mae"] < 0.005


def _hdf5_members(path):
    """{member name: value} of an HDF5 file under the port's naming:
    datasets by path, the attribute A of P as `P@A`."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            for a, v in obj.attrs.items():
                out[f"{name}@{a}"] = v
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
        f.visititems(visit)
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["keys", "diagonals"])
def test_archives_equal_orion_tpu_hdf5(runs, which):
    want = _hdf5_members(runs["paths"]["h5"][which])
    with io.read(runs["paths"]["npz"][which]) as f:
        got = {n: f[n] for n in f.files}
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        if isinstance(v, (str, bytes)):
            assert str(got[name][()]) == (v.decode() if isinstance(
                v, bytes) else v), name
        else:
            v = np.asarray(v)
            assert got[name].dtype == v.dtype, name
            assert np.array_equal(got[name], v), name


def _copy_archive(src, dst, change):
    with io.read(src) as f:
        arrays = {n: f[n] for n in f.files}
    arrays.update(change(arrays))
    io.start_archive(dst)
    io.append(dst, arrays)


@pytest.mark.parametrize("case", ["secret_key", "rotation_keys",
                                  "diagonals"])
def test_mismatched_archive_raises(runs, case, tmp_path):
    keys, diags = runs["paths"]["npz"]
    if case == "secret_key":
        cfg = small_config(io_mode="load", keys_path=keys,
                           diags_path=diags)
        cfg["ckks_params"]["LogScale"] = 25
        with pytest.raises(ValueError, match="saved secret key was "
                           "generated under different parameters"):
            torion.init_scheme(cfg, device="cpu")
        return
    if case == "rotation_keys":
        other = str(tmp_path / "keys.npz")
        _copy_archive(keys, other,
                      lambda a: {"secret_key": -a["secret_key"]})
        with pytest.raises(ValueError, match="saved rotation keys belong "
                           "to different parameters or a different secret "
                           "key"):
            torion.init_scheme(small_config(
                io_mode="load", keys_path=other, diags_path=diags),
                device="cpu")
        return
    other = str(tmp_path / "diags.npz")
    _copy_archive(diags, other, lambda a: {
        "fc1@fingerprint": np.array(str(a["fc1@fingerprint"][()])
                                    + ";stale")})
    with pytest.raises(ValueError, match="saved diagonals for fc1 use "
                       "different parameters"):
        port_compile(small_config(io_mode="load", keys_path=keys,
                                  diags_path=other),
                     runs["params"], runs["loader"])


def test_run_mlp_example_on_cpu(tmp_path):
    from orion_tpu_torch.examples import run_mlp

    path = tmp_path / "mlp_small.yml"
    with open(path, "w") as f:
        yaml.safe_dump(small_config(), f)
    assert run_mlp.main(["--config", str(path), "--cpu"]) < 0.005
