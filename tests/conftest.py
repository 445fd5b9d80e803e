"""Test configuration: force an 8-device virtual CPU mesh.

Tests run on the CPU backend; multi-device sharding tests run on faked CPU
devices. Tests that need the GPU take the `gpu_device` fixture, which skips
them when JAX finds no GPU. The platform is set through jax.config after
importing jax and before any backend initializes.
"""
import os

# No persistent compile cache under test: CPU AOT entries embed the
# compiling machine's CPU features, and reloading them on a host with a
# different feature set can SIGILL.
os.environ.setdefault("RAYTRACE_NO_COMPILE_CACHE", "1")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CPU unless the environment names the platforms: `JAX_PLATFORMS=cuda,cpu
# pytest -m gpu tests/test_gpu.py` runs the GPU tests on a machine with a card
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")


import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules. The full suite
    compiles hundreds of XLA CPU programs in one process; past ~2/3 of the
    run the accumulated compiler/executable state has twice segfaulted
    inside XLA:CPU compilation (full-suite only — every module passes in
    isolation). Modules share few compilations, so dropping the jit caches
    at module boundaries costs little and keeps the process lean."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: whether a card exists is decided here, when
    the test runs, never at import or collection time."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("no GPU (run `JAX_PLATFORMS=cuda,cpu pytest -m gpu "
                    "tests/test_gpu.py` on a machine with a card)")
    return devices[0]
