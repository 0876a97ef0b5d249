"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded through ctypes (no
PyTorch headers, so a build takes seconds).  All sources are compiled at
the first kernel launch of a process, one `nvcc` each, started together.
Libraries land in the build directory (`build/orion_tpu_torch/` at the
checkout root) under a name that carries the hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

No `--use_fast_math`: the basis conversion's float32 division and sum
must round as IEEE float32 does on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..native import build_dir

CSRC = Path(__file__).parent / "csrc"
SOURCES = ("ntt.cu", "ks_decompose.cu", "ks_finish.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the "
            "port's CUDA kernels are built from source at first use")
    return str(path)


def _tag() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library for the current hash.

    Returns {source: library path}.  Raises with nvcc's output when a
    build fails.  ptxas' register and shared-memory report goes to a
    `.log` beside each library.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tag = _tag()
    libs = {src: out / f"{Path(src).stem}-{tag}.so" for src in SOURCES}
    todo = {src: so for src, so in libs.items() if not so.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for src, so in todo.items():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            log = open(so.with_suffix(".log"), "w")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT),
                          tmp, so, log)
        failed = []
        for src, (proc, tmp, so, log) in procs.items():
            proc.wait()
            log.close()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{so.with_suffix('.log').read_text()}")
            else:
                tmp.replace(so)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return libs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source (building all sources if needed)."""
    if source not in _libs:
        path = build_all()[source]
        _libs[source] = ctypes.CDLL(str(path))
    return _libs[source]
