"""Test harness: an 8-device virtual CPU mesh, unless CUDA is asked for.

Multi-device sharding paths are validated on fake CPU devices
(``xla_force_host_platform_device_count``). Tests marked ``gpu`` need the
card and skip elsewhere; run them on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
            "python -m pytest -m gpu tests/"
        )
