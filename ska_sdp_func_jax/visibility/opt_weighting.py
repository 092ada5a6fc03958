"""Tiled (bucket-sorted) Briggs weighting.

Reference: visibility/sdp_opt_weighting.{h,cpp,cu} — GPU-oriented Briggs
weighting over shared-memory tiles: for each tile of bucket-sorted
records, accumulate a tile-local weight grid, compute a PER-TILE
robustness from the per-visit sums, and read back
``w = w_in / (1 + robustness * cell)``
(`sdp_opt_briggs_bucket_gpu`, sdp_opt_weighting.cu). The indexed variant
writes through the sorted visibility indices into the original layout.

Note: the reference kernels' per-tile loops use ``i_vis < total_vis``
as the bound instead of ``start + total`` (sdp_opt_weighting.cu), which
truncates every tile after the first; this implementation uses the
intended per-tile ranges.

Design: tiles become a segment dimension — one scatter-add into a
[num_tiles, tile_u, tile_v] stack, segment sums for the per-tile
robustness, one gather for the read-back. No atomics, no shared memory.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .tiled_functions import (
    _TILE_KEY_STRIDE,
    _geometry,
    _sorted_records,
    bucket_sort,
    tiled_indexing,
)

Array = jax.Array


def _tile_local_weights(sorted_uu, sorted_vv, sorted_tile, weights,
                        grid_size, tile_size_u, tile_size_v, geom,
                        robust_param):
    """Per-record Briggs weights with per-tile robustness."""
    grid_centre = grid_size // 2
    pu = sorted_tile % _TILE_KEY_STRIDE
    pv = sorted_tile // _TILE_KEY_STRIDE
    seg = (pu + pv * geom.num_tiles_u).astype(jnp.int32)
    num_tiles = geom.num_tiles_u * geom.num_tiles_v

    grid_u = jnp.round(sorted_uu).astype(jnp.int64) + grid_centre
    grid_v = jnp.round(sorted_vv).astype(jnp.int64) + grid_centre
    tile_u0 = pu * tile_size_u + geom.top_left_u
    tile_v0 = pv * tile_size_v + geom.top_left_v
    lu = (grid_u - tile_u0).astype(jnp.int32)
    lv = (grid_v - tile_v0).astype(jnp.int32)
    inside = ((lu >= 0) & (lu < tile_size_u)
              & (lv >= 0) & (lv < tile_size_v))
    lu = jnp.clip(lu, 0, tile_size_u - 1)
    lv = jnp.clip(lv, 0, tile_size_v - 1)

    stack = jnp.zeros((num_tiles, tile_size_u, tile_size_v),
                      weights.dtype)
    contrib = jnp.where(inside, weights, jnp.zeros((), weights.dtype))
    stack = stack.at[seg, lu, lv].add(contrib)

    cell = stack[seg, lu, lv]
    # Per-visit sums per tile -> per-tile robustness
    # (robustness_calc, sdp_weighting.cpp:138-147, applied per tile).
    sw = jax.ops.segment_sum(jnp.where(inside, cell, 0.0), seg, num_tiles)
    sw2 = jax.ops.segment_sum(jnp.where(inside, cell * cell, 0.0), seg,
                              num_tiles)
    numerator = (5.0 * 10.0 ** (-robust_param)) ** 2
    robustness = numerator / (sw2[seg] / jnp.where(sw[seg] == 0, 1.0,
                                                   sw[seg]))
    out = weights / (1.0 + robustness * cell)
    return jnp.where(inside, out, jnp.zeros((), out.dtype))


def optimized_weighting(uvw: Array, freqs: Array, vis: Array,
                        weights: Array, robust_param: float,
                        grid_size: int, cell_size_rad: float,
                        support: int, tile_size_u: int = 32,
                        tile_size_v: int = 32) -> Tuple[Array, Array]:
    """Briggs weighting over bucket-sorted uv tiles.

    Equivalent of `sdp_optimized_weighting` (sdp_opt_weighting.h:80):
    bucket-sorts the visibilities, then computes per-tile-robustness
    Briggs weights for every sorted record. Returns
    ``(sorted_tile, output_weights)`` aligned with the sorted order.
    """
    sorted_uu, sorted_vv, sorted_w, sorted_tile, _ = bucket_sort(
        uvw, freqs, vis, weights, grid_size, tile_size_u, tile_size_v,
        cell_size_rad, support)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    out = _tile_local_weights(
        sorted_uu, sorted_vv, sorted_tile, sorted_w, grid_size,
        tile_size_u, tile_size_v, geom, float(robust_param))
    return sorted_tile, out


def optimised_indexed_weighting(uvw: Array, freqs: Array, vis: Array,
                                weights: Array, robust_param: float,
                                grid_size: int, cell_size_rad: float,
                                support: int, tile_size_u: int = 32,
                                tile_size_v: int = 32
                                ) -> Tuple[Array, Array]:
    """Indexed variant (`sdp_optimised_indexed_weighting`,
    sdp_opt_weighting.h:153): weights computed over sorted records and
    scattered back through the visibility indices into the original
    ``[time, baseline, chan, pol]`` layout (last write wins for
    duplicated records, matching the reference's unordered writes up to
    ordering). Returns ``(sorted_vis_index, output_weights)``."""
    sorted_uu, sorted_vv, sorted_idx, sorted_tile = tiled_indexing(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support)
    weights = jnp.asarray(weights)
    w_flat = weights[..., 0].reshape(-1) if weights.ndim == 4 \
        else weights.reshape(-1)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    out_sorted = _tile_local_weights(
        sorted_uu, sorted_vv, sorted_tile, w_flat[sorted_idx], grid_size,
        tile_size_u, tile_size_v, geom, float(robust_param))
    out = jnp.zeros_like(w_flat).at[sorted_idx].set(out_sorted)
    if weights.ndim == 4:
        out = jnp.broadcast_to(out.reshape(weights.shape[:3] + (1,)),
                               weights.shape)
    else:
        out = out.reshape(weights.shape)
    return sorted_idx, out
