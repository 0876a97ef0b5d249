"""The port's boundaries: what it imports and where it runs.

* A static scan of every source of `orion_tpu_torch/` and of
  `chip_smoke.py`: none imports `jax` or `orion_tpu` (the interpreter may
  import jax at startup, so `sys.modules` cannot show this).
* `init_scheme` and `CKKSContext` without a device raise when no CUDA
  device is present.
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
from orion_tpu_torch.crypto.keyswitch import dev_level
from orion_tpu_torch.crypto.ntt_pallas import PallasNTT
from orion_tpu_torch.kernels import keyswitch as kks
from orion_tpu_torch.kernels import ntt as kntt

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


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
