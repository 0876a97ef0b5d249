"""Keep a long-lived test process below the kernel's memory-mapping limit,
and start the suite's longest tests first.

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

Under pytest-xdist's ``--dist load`` the wall of the suite is set by a few
single tests of several minutes (bootstraps and networks, `LONG` below):
in collection order they come in the middle, and each worker then runs one
after the tests it drew first, or two in a row.  ``load`` hands each of
the N workers a first chunk of consecutive tests, max(2, tests // N // 4)
of them, then more as they run short.  The collection hook below moves the
file of each of the N longest tests to the head of one first chunk (its
tests in their order, so module fixtures are set up once), and the files
of the other long tests right after those chunks, so every long test
starts early on a worker of its own.  Tests are only reordered; without
xdist the order is left as collected.
"""

import gc
import os

import pytest

# The suite's tests of 100 s and more in a run with a cold XLA compilation
# cache (6 workers, 8 CPU cores), longest first.
LONG = (
    "tests/models/test_post_bootstrap_scale.py::"
    "test_post_bootstrap_scale_alignment",
    "tests/models/test_residual_bootstrap.py::"
    "test_residual_bootstrap_e2e[stream]",
    "tests/crypto/test_bootstrap.py::test_full_bootstrap",
    "tests/test_diagnostics.py::test_noise_profile",
    "tests/models/test_multict_bootstrap.py::"
    "test_non_pow2_multict_bootstrap",
    "tests/models/test_relu.py::test_encrypted_relu_net",
    "tests/models/test_multict_activation.py::test_multict_activation_scan",
    "tests/test_torch_models.py::test_tiny_vgg_encrypted",
    "tests/models/test_yolo_compile.py::test_yolo_fit_compile",
    "tests/models/test_lola.py::test_lola",
)


def pytest_collection_modifyitems(config, items):
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers < 2:
        return
    files = []
    for nodeid in LONG:
        path = nodeid.split("::")[0]
        if path not in files and any(i.nodeid == nodeid for i in items):
            files.append(path)
    groups = [[i for i in items if i.nodeid.split("::")[0] == f]
              for f in files]
    rest = [i for i in items if i.nodeid.split("::")[0] not in files]
    chunk = max(2, len(items) // workers // 4)
    order = []
    for group in groups[:workers]:
        order += group
        fill = max(0, chunk - len(group))
        order += rest[:fill]
        rest = rest[fill:]
    for group in groups[workers:]:
        order += group
    items[:] = order + rest

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
