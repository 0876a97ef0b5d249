"""Keep a long-lived test process below the kernel's memory-mapping limit.

Every XLA:CPU executable that JAX loads maps about three regions of JIT
code and data, and JAX's own caches keep the executables alive for the
life of the process.  A pytest-xdist worker that runs a few hundred of the
suite's tests in a row loads some 20,000 of them, and once the process
holds ``vm.max_map_count`` mappings (65530 by default) the next load's
mmap fails and XLA dies with a segmentation fault inside
``deserialize_executable`` or the compiler.

Before each test, the fixture below counts the process's mappings; past
half the limit it drops JAX's caches, which unmaps the executables that
only those caches held.  Later tests reload what they need from the
persistent compilation cache.  JAX is imported only then, so that
``tests/conftest.py`` still picks the platform before JAX starts.
"""

import gc

import pytest

_MAPS = "/proc/self/maps"


def _map_limit():
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 65530


def _mappings():
    try:
        with open(_MAPS, "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return 0


_RELEASE_AT = _map_limit() // 2


@pytest.fixture(autouse=True)
def _release_compiled_programs():
    if _mappings() > _RELEASE_AT:
        import jax

        jax.clear_caches()
        gc.collect()
    yield
