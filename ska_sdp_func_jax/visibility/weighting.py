"""Imaging weights: uniform and Briggs (robust).

Reference: visibility/sdp_weighting.{h,cpp,cu}. Two passes over a uv grid
of accumulated input weights:

1. grid write: ``grid[idx_u, idx_v, pol] += input_weight`` with
   ``idx = floor(u * inv_wavelength / max_abs_uv * half_grid) + half_grid``
   (weights_grid_write, sdp_weighting.cpp:19-76);
2. read-back: uniform ``w = 1 / grid_cell``
   (uniform_weights_grid_read, :149-207); Briggs
   ``w = w_in / (1 + robustness * grid_cell)`` with
   ``robustness = (5 * 10^-R)^2 / (sum grid^2 / sum grid)`` where the sums
   run over *visits* (per visibility sample), not unique cells
   (sum_weights_calc :79-135, robustness_calc :138-147).

Design: scatter-add for the grid write, gathers for the sums and
read-back — one fused jit, no per-sample loop.
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..utility.constants import C_0
from ..utility.errors import SdpShapeError
from ..utility.data_model import check_uvw, check_weights

Array = jax.Array


def get_uv_range(uvw: Array, freq_hz: Array) -> float:
    """Max absolute u coordinate in wavelength units at the top frequency
    (reference Python helper, weighting.py:41-60)."""
    uvw = jnp.asarray(uvw)
    if uvw.ndim != 3 or uvw.shape[-1] != 3:
        raise SdpShapeError(
            f"get_uv_range: uvw must be [time, baseline, 3]; got "
            f"{uvw.shape}")
    max_abs_uv = float(jnp.max(jnp.abs(uvw[:, :, 0:1])))
    return max_abs_uv * float(freq_hz[-1]) / C_0


def _grid_indices(uvw, freq_hz, max_abs_uv, grid_size):
    """idx_u/idx_v [T,B,C] plus validity mask."""
    half = grid_size // 2
    inv_wave = freq_hz / C_0                     # [C]
    gu = uvw[:, :, 0:1] * inv_wave[None, None, :]
    gv = uvw[:, :, 1:2] * inv_wave[None, None, :]
    idx_u = jnp.floor(gu / max_abs_uv * half).astype(jnp.int32) + half
    idx_v = jnp.floor(gv / max_abs_uv * half).astype(jnp.int32) + half
    ok = ((idx_u >= 0) & (idx_u < grid_size)
          & (idx_v >= 0) & (idx_v < grid_size))
    return idx_u, idx_v, ok


@partial(jax.jit, static_argnames=("grid_size",))
def _grid_write(uvw, freq_hz, max_abs_uv, input_weights, grid_size: int):
    num_pols = input_weights.shape[3]
    idx_u, idx_v, ok = _grid_indices(uvw, freq_hz, max_abs_uv, grid_size)
    grid = jnp.zeros((grid_size, grid_size, num_pols),
                     input_weights.dtype)
    contrib = jnp.where(ok[..., None], input_weights,
                        jnp.zeros((), input_weights.dtype))
    iu = jnp.where(ok, idx_u, 0)
    iv = jnp.where(ok, idx_v, 0)
    return grid.at[iu, iv].add(contrib), (idx_u, idx_v, ok)


@partial(jax.jit, static_argnames=("grid_size",))
def _uniform(uvw, freq_hz, max_abs_uv, input_weights, grid_size: int):
    grid, (idx_u, idx_v, ok) = _grid_write(
        uvw, freq_hz, max_abs_uv, input_weights, grid_size)
    cells = grid[jnp.where(ok, idx_u, 0), jnp.where(ok, idx_v, 0)]
    out = jnp.where(ok[..., None], 1.0 / cells,
                    jnp.zeros((), input_weights.dtype))
    return grid, out


@partial(jax.jit, static_argnames=("grid_size",))
def _briggs(uvw, freq_hz, max_abs_uv, robust_param, input_weights,
            grid_size: int):
    grid, (idx_u, idx_v, ok) = _grid_write(
        uvw, freq_hz, max_abs_uv, input_weights, grid_size)
    cells = grid[jnp.where(ok, idx_u, 0), jnp.where(ok, idx_v, 0)]
    visited = jnp.where(ok[..., None], cells,
                        jnp.zeros((), cells.dtype))
    # Accumulate the robustness sums in f64 whenever available: over
    # ~1e9 visibilities f32 running sums lose digits (without x64
    # the XLA tree reduction keeps the error at ~log2(N) ulps).
    acc_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    visited_acc = visited.astype(acc_dtype)
    sumweight = jnp.sum(visited_acc)
    sumweight2 = jnp.sum(visited_acc * visited_acc)
    numerator = (5.0 * 10.0 ** (-robust_param)) ** 2
    robustness = (numerator / (sumweight2 / sumweight)).astype(cells.dtype)
    out = jnp.where(ok[..., None],
                    input_weights / (1.0 + robustness * cells),
                    jnp.zeros((), input_weights.dtype))
    return grid, out


def uniform_weights(uvw: Array, freq_hz: Array, max_abs_uv: float,
                    input_weights: Array,
                    grid_size: int = None) -> Tuple[Array, Array]:
    """Uniform weighting: weight = 1 / (uv-cell hit weight).

    Equivalent of `sdp_weighting_uniform` (sdp_weighting.h:59-70); returns
    ``(weights_grid_uv [grid, grid, pols], output_weights)`` instead of
    filling preallocated arrays. ``grid_size`` defaults to
    2 * ceil(max_abs_uv) aliasing the reference's caller convention of a
    grid spanning the uv range; pass it explicitly for parity tests.
    """
    uvw = jnp.asarray(uvw)
    input_weights = jnp.asarray(input_weights)
    check_uvw(uvw)
    check_weights(input_weights)
    if grid_size is None:
        grid_size = int(2 * (int(max_abs_uv) + 1))
    return _uniform(uvw, jnp.asarray(freq_hz), float(max_abs_uv),
                    input_weights, int(grid_size))


def briggs_weights(uvw: Array, freq_hz: Array, max_abs_uv: float,
                   robust_param: float, input_weights: Array,
                   grid_size: int = None) -> Tuple[Array, Array]:
    """Briggs/robust weighting.

    Equivalent of `sdp_weighting_briggs` (sdp_weighting.h:72-78):
    ``w = w_in / (1 + robustness * grid_cell)``.
    """
    uvw = jnp.asarray(uvw)
    input_weights = jnp.asarray(input_weights)
    check_uvw(uvw)
    check_weights(input_weights)
    if grid_size is None:
        grid_size = int(2 * (int(max_abs_uv) + 1))
    return _briggs(uvw, jnp.asarray(freq_hz), float(max_abs_uv),
                   float(robust_param), input_weights, int(grid_size))
