"""Test configuration: an 8-device virtual CPU mesh, set before backends init.

The suite runs on the CPU: the platform is whatever ``JAX_PLATFORMS`` names,
and ``cpu`` when it names none, so a machine with a GPU still runs the CPU
suite unless asked otherwise. Sharding/collective code
paths are validated on a simulated 8-device CPU mesh via
--xla_force_host_platform_device_count (SURVEY.md §4). Tests that need the
card carry the ``gpu`` marker and skip here (see the ``gpu_device``
fixture).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-bound (many jitted
# sampler variants); caching compiled executables across runs cuts repeat
# wall time dramatically. JAX_COMPILATION_CACHE_DIR wins when set.
from bark_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when the process has none.

    Decided here, at test time, and never at import: every xdist worker
    must collect the same tests.
    """
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run the gpu-marked tests on the card)")
    return devices[0]
