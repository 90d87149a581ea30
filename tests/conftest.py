"""Test configuration: force a virtual 8-device CPU mesh and float64.

Tests run on CPU (the reference tests are CPU; float64 gives clean parity with
its Float64 numerics) with XLA's host-platform device-count override so the
multi-device sharding paths are exercised without accelerators (SURVEY.md
section 4).  Tests that need the card carry the ``gpu`` marker and skip
here (the ``gpu_device`` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# CPU unless the caller asks for more (the ``gpu`` tests on the card run with
# JAX_PLATFORMS=cuda,cpu)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: recompiles of the jitted solve across test
# sessions are the dominant cost (the solve is one large while-loop program)
from iterativelqr_tpu.utils.compile_cache import setup_compile_cache

setup_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX finds none)")
