"""Test configuration: run on CPU with 8 virtual devices for mesh tests.

Mirrors SURVEY.md section 4's test plan: multi-chip paths are validated via
jax's host-platform device-count emulation.

Tests marked `gpu` need an NVIDIA card and skip without one.  They run on
the card with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
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


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX found no gpu backend)")
