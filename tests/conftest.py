"""Test configuration.

Tier 1 runs on the CPU with an 8-device virtual mesh, so the multi-device
sharding tests have devices to shard over; it must run anywhere.  When
JAX_PLATFORMS names the GPU (chip_smoke.py's in-process GPU tier), the
platform is left alone and only the tests marked ``gpu`` are selected.
"""

import os

import pytest

_platforms = os.environ.get("JAX_PLATFORMS", "")
if "cuda" not in _platforms and "gpu" not in _platforms:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

from fhestring_tpu.compat import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; run by chip_smoke.py on the card")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this tier on one")
