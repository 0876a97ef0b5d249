"""The port's boundaries: what it imports and where it runs.

* A static scan of every source of `orion_tpu_torch/` and of
  `chip_smoke.py`: none imports `jax` or `orion_tpu` (the interpreter may
  import jax at startup, so `sys.modules` cannot show this).
* `init_scheme` and `CKKSContext` without a device raise when no CUDA
  device is present, on a bootstrapped config too; asked for the CPU, a
  net's fit and compile keep every buffer there.
* A tensor on another device reaches neither a kernel nor a plain version.
* `chip_smoke.py` exits non-zero and prints no result without a GPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

import orion_tpu_torch
from orion_tpu_torch.crypto import CKKSContext
from orion_tpu_torch.crypto.keyswitch import dev_level, keyswitch
from orion_tpu_torch.crypto.ntt_pallas import PallasNTT
from orion_tpu_torch.kernels import keyswitch as kks
from orion_tpu_torch.kernels import ntt as kntt
from orion_tpu_torch.kernels import rescale as krs

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "orion_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "orion_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0]


SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_orion_tpu_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_init_scheme_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """Both entry points, `init_scheme` and the low-level `CKKSContext`,
    run on `cuda` unless the caller asks for the CPU."""
    with open(ROOT / "configs" / "mlp.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["ckks_params"].update(LogN=8, H=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        orion_tpu_torch.init_scheme(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        orion_tpu_torch.init_scheme(cfg, device="cuda")
    scheme = orion_tpu_torch.init_scheme(cfg, device="cpu")
    assert scheme.ctx.dev["tw"].device.type == "cpu"

    kw = dict(logn=8, logq=[29, 26], logp=[29], logscale=26, h=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CKKSContext(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CKKSContext(**kw, device="cuda")
    ctx = CKKSContext(**kw, device="cpu")
    assert ctx.device.type == "cpu"
    assert ctx.dev["tw"].device.type == "cpu"


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; anything that is not on
    the CPU must launch a kernel (here: raise, as a meta tensor cannot)."""
    ctx = CKKSContext(logn=8, logq=[29, 26], logp=[29], logscale=26, h=64,
                      device="cpu")
    dl = dev_level(ctx, 1)
    meta = torch.empty((2, ctx.n), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kntt.ntt_fwd(meta, dl.q)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kntt.ntt_inv(meta, dl.q)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        PallasNTT(ctx).ntt(meta, [0, 1])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kks.ks_decompose(meta, dl)
    ext = torch.empty((len(dl.digits), 3, ctx.n), dtype=torch.int64,
                      device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kks.ks_finish(ext, dl, ext, None)
    acc = torch.empty((2, dl.t.p.shape[0], ctx.n), dtype=torch.int64,
                      device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        krs.mod_drop_rescale(acc, dl)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        krs.rescale_poly(acc[:, :2], dl)


def test_new_paths_refuse_other_devices(monkeypatch):
    """A bootstrapped config, like the others, runs on `cuda` unless the
    CPU is asked for.  The batched evaluator (polynomial evaluation over
    stacked ciphertexts: its key-switch and rescale) and the bootstrap's
    ModRaise reach the same wrappers: a tensor that is not on the CPU
    must launch a kernel, here raise."""
    from orion_tpu_torch.crypto import Evaluator, KeyChest
    from orion_tpu_torch.crypto.bootstrap import Bootstrapper
    from orion_tpu_torch.crypto.ciphertext import Ciphertext

    with open(ROOT / "configs" / "resnet.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["ckks_params"].update(LogN=8, H=64)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            orion_tpu_torch.init_scheme(cfg)
    scheme = orion_tpu_torch.init_scheme(cfg, device="cpu")
    assert scheme.evaluator.lean_keys and scheme.params.boot

    ctx = CKKSContext(logn=8, logq=[29, 26], logp=[29], logscale=26, h=64,
                      device="cpu")
    ev = Evaluator(ctx, KeyChest(ctx))
    meta = torch.empty((3, 2, 2, ctx.n), dtype=torch.int64, device="meta")
    ct = Ciphertext(meta, 1, ctx.default_scale)
    rlk = ev.keys.relin_key
    with pytest.raises(ValueError, match="CUDA or CPU"):
        keyswitch(meta[:, 1], dev_level(ctx, 1), rlk.data, rlk.shoup)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ev.rescale(ct)

    class _Raise:
        """Only the state mod_raise reads."""
        scheme = type("S", (), {"params": type("P", (), {
            "base_level": 0})()})()

    btp = _Raise()
    btp.ctx, btp.top = ctx, 1
    btp._raise_digit = None
    with pytest.raises(ValueError, match="CUDA or CPU"):
        Bootstrapper.mod_raise(btp, Ciphertext(meta[0], 0, 1.0))


def test_bootstrapped_net_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """A net of VGG-11's layers (conv, BatchNorm2d, minimax ReLU (15, 15,
    27), pooling, linear) on configs/vgg.yml, at LogN 8: without a card the
    scheme it compiles on cannot be made unless the CPU is asked for; on
    the CPU, fit and compile leave every key and compiled buffer there."""
    import numpy as np

    import orion_tpu_torch.nn as on
    from orion_tpu_torch.utils import ArrayLoader

    with open(ROOT / "configs" / "vgg.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["ckks_params"].update(LogN=8, H=64)

    class TinyVGG(on.Module):
        def __init__(self):
            super().__init__()
            self.features = on.Sequential(
                on.Conv2d(3, 4, kernel_size=3, padding=1),
                on.BatchNorm2d(4), on.ReLU(degrees=[15, 15, 27]),
                on.AvgPool2d(kernel_size=2, stride=2))
            self.flatten = on.Flatten()
            self.classifier = on.Linear(16, 10)

        def forward(self, x):
            return self.classifier(self.flatten(self.features(x)))

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            orion_tpu_torch.init_scheme(cfg)
    scheme = orion_tpu_torch.init_scheme(cfg, device="cpu")
    net = TinyVGG()
    data = np.random.default_rng(1).uniform(0, 1, (8, 3, 4, 4)).astype(
        np.float32)
    orion_tpu_torch.fit(net, ArrayLoader(data, np.zeros(8), batch_size=1))
    orion_tpu_torch.compile(net)
    buffers = [p.ksk for p in scheme.evaluator._key_packs.values()]
    buffers += [k.data for k in scheme.keys.galois_keys.values()]
    buffers += [tr.pts for m in net.modules()
                for tr in getattr(m, "compiled", {}).values()]
    assert buffers
    assert all(b.device.type == "cpu" for b in buffers)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_ci_ring_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """A ConjugateInvariant config (tests/configs/mlp.yml, at LogN 8) runs
    on `cuda` unless the CPU is asked for, through both entry points; on
    the CPU its tables are the 2n lift's, and a tensor that is not on the
    CPU must launch the CI kernels (here: raise)."""
    with open(ROOT / "tests" / "configs" / "mlp.yml") as f:
        cfg = yaml.safe_load(f)
    assert cfg["ckks_params"]["RingType"] == "ConjugateInvariant"
    cfg["ckks_params"].update(LogN=8, H=64)
    kw = dict(logn=8, logq=[29, 26], logp=[29], logscale=26, h=64,
              ring_type="conjugate_invariant")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            orion_tpu_torch.init_scheme(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CKKSContext(**kw)
    scheme = orion_tpu_torch.init_scheme(cfg, device="cpu")
    assert scheme.ctx.ring_type == "conjugate_invariant"
    assert scheme.ctx.slots == scheme.ctx.n == 256
    assert scheme.ctx.dev["tw"].shape[-1] == 512
    assert scheme.ctx.dev["tw"].device.type == "cpu"

    ctx = CKKSContext(**kw, device="cpu")
    dl = dev_level(ctx, 1)
    assert dl.ci is not None and dl.dropdown is None
    meta = torch.empty((2, 2, ctx.n), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kntt.ntt_fwd(meta[0], dl.q)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kntt.ntt_inv(meta[0], dl.q)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kks.ks_decompose(meta[0], dl)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        krs.rescale_poly(meta, dl)
    # no drop-down tables on the CI ring: the fused drop refuses it
    with pytest.raises(ValueError, match="drop-down"):
        krs.mod_drop_rescale(torch.zeros((2, 3, ctx.n), dtype=torch.int64),
                             dl)
    # a CI ring of LogN 14 needs transforms of 2^15, beyond the kernels:
    # refused on the card before anything is built
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match=r"2\^15-point"):
            CKKSContext(**dict(kw, logn=14))


def test_init_multihost_needs_cuda_unless_cpu_or_gloo(monkeypatch, tmp_path):
    """A world runs its ranks on the card (NCCL) unless the caller asks for
    the CPU or for gloo; a second call returns the first call's device.
    The sharded key-switch's wrappers refuse a tensor that is not on the
    CPU or the card, and the ConjugateInvariant ring."""
    import torch.distributed as dist

    from orion_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multihost, "_DEVICE", None)
    url = (tmp_path / "store").as_uri()
    for kw in ({}, {"device": "cuda"}, {"backend": "nccl"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.init_multihost(url, 1, 0, **kw)
    with pytest.raises(ValueError, match="nccl backend needs"):
        multihost.init_multihost(url, 1, 0, backend="nccl", device="cpu")
    assert not dist.is_initialized()
    for i, kw in enumerate(({"device": "cpu"}, {"backend": "gloo"})):
        try:
            dev = multihost.init_multihost(
                (tmp_path / f"store{i}").as_uri(), 1, 0, **kw)
            assert dev == torch.device("cpu")
            assert dist.get_backend() == "gloo"
            assert multihost.init_multihost() == dev
        finally:
            dist.destroy_process_group()
            multihost._DEVICE = None

    ctx = CKKSContext(logn=8, logq=[29, 26, 26], logp=[29], logscale=26,
                      h=64, device="cpu")
    dl = dev_level(ctx, 2)
    blk = kks.row_block(dl, 2, 4)
    assert blk.nq == 1
    meta = torch.empty((1, 3, ctx.n), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kks.ks_convert_rows(meta, dl, blk)
    ext = torch.empty((len(dl.digits), 2, ctx.n), dtype=torch.int64,
                      device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kks.ks_inner_rows(ext, dl, blk, ext, None, torch.arange(2))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kks.ks_moddown_rows(meta[None, :, :2].expand(1, 2, 2, ctx.n), dl,
                            blk)
    ci = CKKSContext(logn=8, logq=[29, 26], logp=[29], logscale=26, h=64,
                     ring_type="conjugate_invariant", device="cpu")
    with pytest.raises(ValueError, match="standard ring only"):
        kks.row_block(dev_level(ci, 1), 0, 1)
