"""Unit tests for bench.py's byte model and timing helper (CPU-only).

The byte model must track the kernels' operand format, or any rate
derived from it is wrong.
"""

import sys

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, ".")
import bench  # noqa: E402

from ska_sdp_func_jax.parallel import plan_wstack  # noqa: E402
from ska_sdp_func_jax.parallel.packed import (  # noqa: E402
    packed_gridder,
    plan_packed,
)

C_0 = 299792458.0


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(2)
    rows, chans, image, subgrid = 200, 2, 256, 128
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.3 * image / 2 / 0.002
    uvw[:, 2] *= 1.2 * 100.0 * 4.0
    plan = plan_wstack(uvw, C_0, C_0 / 100, chans, image, subgrid,
                       0.002, 100.0, support=8, w_support=4,
                       w_tower_height=4.0)
    pplan = plan_packed(plan, uvw, block_v=128)
    return plan, pplan, rows * chans


def test_grid_stream_bytes_tracks_engine(small):
    plan, pplan, _ = small
    g_high = packed_gridder(pplan, precision="high")
    g_bf16 = packed_gridder(pplan, precision="bf16")
    # u_off + iv0 (4 B each) + 8 u-taps + 8 v-taps + 4 w-taps (f32)
    # + the re/im visibility.
    assert bench._grid_stream_bytes_per_slot(g_high) == \
        8.0 + 4.0 * (8 + 8 + 4) + 8.0
    # The taps stream as f32 in every precision mode (the kernels
    # split or round them in registers).
    assert bench._grid_stream_bytes_per_slot(g_bf16) == \
        bench._grid_stream_bytes_per_slot(g_high)


def test_measure_returns_median_and_spread():
    calls = {"n": 0}

    def step():
        calls["n"] += 1

    dt, spread = bench._measure(step, lambda: None, iters=5, n_meas=3)
    # 1 warm loop + 3 measured loops of 5 iters each.
    assert calls["n"] == 4 * 5
    assert dt >= 0.0 and spread >= 0.0
