"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is
validated the way the reference validates GPU against CPU — N-device
results must match 1-device results), with float64 enabled for oracle
parity with the reference's tolerances (degrid atol 1e-14 / rtol 1e-13
etc.; see BASELINE.md).

``JAX_PLATFORMS`` defaults to ``cpu``; the tests marked ``gpu`` skip
unless the process already runs on a GPU (``python chip_smoke.py`` runs
them there). Environment must be set before jax is first imported.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The GPU device for tests marked ``gpu``; skips elsewhere. Decided
    here, at run time, so every xdist worker collects the same tests."""
    from ska_sdp_func_jax.utility.device import platform

    name = platform()
    if name != "gpu":
        pytest.skip(f"needs a GPU (running on {name})")
    return jax.devices()[0]
