"""Test harness configuration.

Tests run hermetically on the CPU with 8 virtual devices (so multi-device
sharding logic is exercised without accelerator hardware) and with x64
enabled (so numeric parity with the float64 reference semantics is checked
at full precision). Tests marked ``gpu`` need a GPU and skip elsewhere; the
float32 path on the card is exercised by ``chip_smoke.py``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402

# CPU unless JAX_PLATFORMS names a platform (the ``gpu`` tests run with
# JAX_PLATFORMS=cuda,cpu on the card).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# The slow tier is dominated by XLA compiles of shape-bucketed tracker/BA
# programs; a persistent compilation cache makes repeat runs (and shared
# shapes across test files) pay each compile once.
from pilotguru.cli._common import setup_compile_cache  # noqa: E402

setup_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when none is present.

    Decided here, at run time, never at import or collection: every xdist
    worker must collect the same tests.
    """
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run on the card: see README)")
    return devices[0]
