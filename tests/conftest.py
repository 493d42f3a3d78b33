"""Test configuration.

The suite runs on the CPU: XLA's CPU backend with 8 virtual devices (so the
sharding tests have a mesh), x64 enabled for the numerical-parity tests,
and Pallas kernels in interpret mode. Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/ -m 'not slow'

Tests marked `gpu` need an NVIDIA GPU and skip without one. They run on the
card, in the same process as everything else there, through
`python chip_smoke.py` (its card-only phase sets WDX_TEST_PLATFORM=gpu, so
this file leaves the platform and x64 alone).
"""

import os

import pytest

ON_GPU = os.environ.get("WDX_TEST_PLATFORM", "cpu") == "gpu"

if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from warpdemux_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


@pytest.fixture(autouse=True)
def _gpu_marker_needs_a_gpu(request):
    """Skip `gpu`-marked tests unless the default JAX device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {platform} here")
