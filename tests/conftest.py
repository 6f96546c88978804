"""Test configuration: the host CPU with 8 virtual devices, so the sharding
tests run without an accelerator.  ``JAX_PLATFORMS`` set by the caller
wins (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the
card-only tests on a GPU).  Tests that need the card take the ``gpu``
fixture, which skips them when JAX has no GPU.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")
    return jax.devices()[0]
