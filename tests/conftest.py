"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding paths are exercised without accelerators.

Tests marked `chip` need a GPU: they take the `gpu` fixture, which skips
them on the CPU. Run them on the card with JAX_ON_GPU=1 (the default is
the CPU, pinned before any backend initializes).
"""

import os

if os.environ.get("JAX_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import atexit  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

if os.environ.get("JAX_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
# Per-run compile-cache dir: a SHARED cache dir can be poisoned by a
# concurrently killed run and SIGSEGV inside JAX's cache write (round-4
# post-mortem: one gate run died RC=139 in compilation_cache.put_executable).
# Caching still pays within a run (fixtures re-jit across modules under
# pytest-forked-style isolation is not used here, but repeated jits of the
# same kernel across tests in one process hit the in-memory cache anyway);
# the on-disk dir is unique per run and removed at exit.
_cache_dir = tempfile.mkdtemp(prefix="jax_cache_test_")
atexit.register(shutil.rmtree, _cache_dir, ignore_errors=True)
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_ON_GPU=1 on the card)")
    return dev
