"""Native (C++/OpenMP) host NTT kernels, built on first use.

The encrypted compute path is PyTorch and CUDA; these kernels cover the
*host* side of the pipeline: compile-time plaintext encoding (thousands of
diagonal NTTs when packing a network) and client-side encrypt/decrypt.

Build model: `host_ntt.cpp` is compiled with the system g++ into the
package's build directory (`build/orion_tpu_torch/` at the checkout root,
named by the source hash) the first time a host NTT runs, and loaded with
ctypes.  Without g++ or OpenMP the build fails and `get_lib()` returns
None: `crypto/ref.py` then runs its numpy butterflies, which give the same
bits (tests/test_torch_ring.py checks both).
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "host_ntt.cpp"
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)

_state: dict = {}


def build_dir() -> Path:
    """Where the port's native and CUDA libraries are built."""
    return Path(__file__).resolve().parents[2] / "build" / "orion_tpu_torch"


def _build() -> ctypes.CDLL:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = build_dir()
    so = out / f"host_ntt-{tag}.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out) as td:
            tmp = Path(td) / "host_ntt.so"
            cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
                   "-o", str(tmp), str(_SRC)]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    lib.ntt_rows.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64,
                             _i64p, _i64p, _i64p, _u64p]
    lib.ntt_rows.restype = None
    lib.intt_rows.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64,
                              _i64p, _i64p, _i64p, _u64p, _i64p, _u64p]
    lib.intt_rows.restype = None
    return lib


def get_lib():
    """The loaded host-NTT library, or None where it cannot be built."""
    if "lib" not in _state:
        try:
            _state["lib"] = _build()
        except (OSError, subprocess.SubprocessError):
            _state["lib"] = None
    return _state["lib"]


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def ntt_rows(a: np.ndarray, prime_idx: np.ndarray, primes: np.ndarray,
             tw: np.ndarray, tw_shoup: np.ndarray) -> None:
    """In-place forward NTT of int64[rows, n]; tables are (nprimes, n)."""
    rows, n = a.shape
    get_lib().ntt_rows(_ptr(a, _i64p), rows, n, _ptr(prime_idx, _i64p),
                       _ptr(primes, _i64p), _ptr(tw, _i64p),
                       _ptr(tw_shoup, _u64p))


def intt_rows(a: np.ndarray, prime_idx: np.ndarray, primes: np.ndarray,
              itw: np.ndarray, itw_shoup: np.ndarray,
              ninv: np.ndarray, ninv_shoup: np.ndarray) -> None:
    """In-place inverse NTT of int64[rows, n]."""
    rows, n = a.shape
    get_lib().intt_rows(_ptr(a, _i64p), rows, n, _ptr(prime_idx, _i64p),
                        _ptr(primes, _i64p), _ptr(itw, _i64p),
                        _ptr(itw_shoup, _u64p), _ptr(ninv, _i64p),
                        _ptr(ninv_shoup, _u64p))
