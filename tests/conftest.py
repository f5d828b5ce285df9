import os

# Tests run on a virtual 8-device CPU mesh so sharding logic is exercised
# without accelerator hardware (SURVEY.md §4). The platform is pinned to
# the CPU, also through jax.config, so that no test worker opens a GPU:
# one JAX process per card.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NOTE on the persistent compilation cache: it was tried here and
# REVERTED. The XLA:CPU AOT loader
# deserializes cached executables with a machine-feature mismatch
# ("+prefer-no-scatter ... could lead to execution errors such as
# SIGILL") and deterministically SEGFAULTS loading the pose-graph
# fori_loop program (reproduced twice with a fresh cache dir,
# compilation_cache.get_executable_and_time in the crash stack). Warm
# in-module runs measured ~2x wall-time savings, not worth a flaky
# suite; suite time is bounded instead by the module-scope cache clear
# below plus shared shapes within modules.


import gc  # noqa: E402

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running; deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; the suite pins the CPU, so "
        "these skip here (on the card, chip_smoke.py is the check)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the number of live compiled executables in one pytest
    process.

    The full suite compiles hundreds of XLA:CPU programs; with all of
    them held live, a late compile of a large nested-control-flow
    program (the loop-closure Gauss-Newton / CG pose-graph programs in
    test_slam.py) segfaults inside ``backend_compile_and_load``
    deterministically — 3/3 full-suite runs at r3, reproduced at r4
    with a file-set bisection (the crash follows cumulative compile
    volume, not any single poisoning test: an 11-file half-set + slam
    crashes, the complementary set passes, and no single pairing
    reproduces). Verified independent of the r4 native-prefetcher
    heap-corruption bug (fixed in native/io_shim.cpp): with that fixed
    and this fixture removed, the crash still reproduces (rc=139);
    with the fixture in place the full suite is green 3/3. Dropping
    cache references after each module lets the JIT code regions be
    reclaimed and the suite complete in one process.
    """
    yield
    jax.clear_caches()
    gc.collect()
