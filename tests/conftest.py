"""Test harness: an 8-device virtual CPU mesh by default.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``, the default set here)
with 8 virtual devices so the sharding tests have a mesh.  Tests marked
``gpu`` need the card: they take the ``gpu`` fixture, which skips them
unless JAX's default device is a GPU.  Run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, not import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu tests/")
    return jax.devices()[0]
