"""Test configuration: CPU backend, 8-device virtual mesh, float64.

The engine is dtype-parameterized (float32 on the GPU for the benches);
tests run on the CPU with x64 so the JAX engine can be compared against
float64 NumPy oracles at tight tolerances, and so multi-device shardings
can be exercised on a virtual 8-device mesh without hardware.

``JAX_PLATFORMS`` picks another backend list (``cuda,cpu`` on a GPU machine
for the ``gpu``-marked tests); unset, the tests run on the CPU.  Whether a
card is present is decided inside the ``gpu_device`` fixture, never here.
"""

import os
import sys

import pytest

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:          # no GPU backend in JAX_PLATFORMS
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX found none); chip_smoke.py "
                    "runs the same check on the card")
    return gpus[0]
