"""Test configuration: force an 8-device virtual CPU mesh.

Multi-device sharding tests run on fake CPU devices (the JAX-native
equivalent of a fake backend), per SURVEY.md §4.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_platforms", "cpu")
# hermetic compiles: the persistent compilation cache is shared with any
# concurrently-running bench/tools process, and concurrent access has been
# observed to segfault XLA:CPU inside backend_compile_and_load (full-suite
# runs on 2026-08-18 died twice in test_precision while a TPU client ran)
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    Even with the persistent cache off, full-suite runs (~300 tests, one
    process) died twice with a deterministic XLA:CPU segfault inside
    backend_compile_and_load at the same late test (test_precision, ~275
    compiles in) while the same file passes alone — accumulated live JIT
    executables are the only order-dependent state left. Freeing them
    between modules keeps the per-process compile population bounded.
    """
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips on machines without one")
