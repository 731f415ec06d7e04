"""Test configuration.

Tests run on the CPU backend with 8 virtual devices: correctness and
parity tests need no GPU, and the 8-device mesh exercises the
multi-device sharding paths.  float64 is enabled and matmuls run at
"highest" precision for the parity assertions.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", True)
# Parity tests need full-precision matmuls on every backend.
jax.config.update("jax_default_matmul_precision", "highest")
# The persistent compilation cache is disabled for tests: in this
# sandbox the cache read/write path (zstd-compressed executables)
# intermittently segfaults/aborts the interpreter mid-suite (observed
# in both get_executable_and_time and put_executable_and_time).  CPU
# compiles of the test-sized programs are fast, so in-memory caching
# within a single pytest process is sufficient.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    With the suite's size (hundreds of distinct jit programs at x64 +
    8 virtual devices in one process), this sandbox's XLA:CPU
    intermittently segfaults inside backend_compile_and_load once too
    much compile state has accumulated; dropping caches at module
    boundaries keeps the process under that threshold (observed: full
    runs abort around the ~150th compile without this, pass with it).
    """
    yield
    jax.clear_caches()
