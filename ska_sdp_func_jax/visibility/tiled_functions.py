"""UV-tile binning: count + prefix sum, bucket sort, index-only variant.

Reference: visibility/sdp_tiled_functions.{h,cpp,cu} — the GPU
locality-tiling infrastructure: per-tile visibility counts with an
exclusive prefix sum, then a bucket sort of (u, v, vis, weight) records
into tile order (visibilities are DUPLICATED into every tile their
support box overlaps), or an index-only variant.

Geometry (sdp_opt_weighting.cpp:58-64): ``num_tiles_u =
ceil(grid_size / tile_size_u)``; the tile lattice's top-left is
``grid_centre - (grid_centre / tile_u) * tile_u - tile_u / 2``. A
visibility at grid position (round(pos)+centre) covering +-support cells
touches tiles ``floor((rel - support) / tile) ..
ceil((rel + support + 1) / tile))``. Points whose support box leaves the
grid are skipped (counted in ``num_skipped``).

Design: instead of atomic scatter ordering, records are generated for
a static bound of candidate tiles per visibility and STABLY sorted by
tile id — deterministic tile-contiguous buckets, the layout a per-tile
gridding kernel consumes.
"""

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utility.constants import C_0
from ..utility.errors import SdpShapeError

Array = jax.Array

_TILE_KEY_STRIDE = 32768  # sorted_tile = pv * 32768 + pu (reference)


class TileGeometry(NamedTuple):
    num_tiles_u: int
    num_tiles_v: int
    top_left_u: int
    top_left_v: int
    max_tiles_spanned: int


def _geometry(grid_size: int, tile_size_u: int, tile_size_v: int,
              support: int) -> TileGeometry:
    grid_centre = grid_size // 2
    num_tiles_u = (grid_size + tile_size_u - 1) // tile_size_u
    num_tiles_v = (grid_size + tile_size_v - 1) // tile_size_v
    ctile_u = grid_centre // tile_size_u
    ctile_v = grid_centre // tile_size_v
    top_left_u = grid_centre - ctile_u * tile_size_u - tile_size_u // 2
    top_left_v = grid_centre - ctile_v * tile_size_v - tile_size_v // 2
    # Static bound on tiles a support box can span per axis.
    span_u = int(math.ceil((2 * support + 1) / tile_size_u)) + 2
    span_v = int(math.ceil((2 * support + 1) / tile_size_v)) + 2
    return TileGeometry(num_tiles_u, num_tiles_v, top_left_u, top_left_v,
                        max(span_u, span_v))


def _candidates(uvw, freqs, grid_size, tile_size_u, tile_size_v,
                cell_size_rad, support, geom):
    """Flattened candidate records: for each (vis sample, candidate tile)
    -> (valid mask, tile key, pos_u, pos_v, flat vis index)."""
    grid_centre = grid_size // 2
    grid_scale = grid_size * cell_size_rad
    inv_wave = freqs / C_0
    pos_u = (uvw[..., 0:1] * inv_wave * grid_scale)         # [T,B,C]
    pos_v = (uvw[..., 1:2] * inv_wave * grid_scale)
    grid_u = jnp.round(pos_u).astype(jnp.int64) + grid_centre
    grid_v = jnp.round(pos_v).astype(jnp.int64) + grid_centre
    ok = ((grid_u + support < grid_size) & (grid_u - support >= 0)
          & (grid_v + support < grid_size) & (grid_v - support >= 0))
    rel_u = grid_u - geom.top_left_u
    rel_v = grid_v - geom.top_left_v
    # Tile ranges, matching the reference's float arithmetic
    # (floor/ceil of (rel -+ support) / tile).
    tu_min = jnp.floor((rel_u - support).astype(jnp.float32)
                       * np.float32(1.0 / tile_size_u)).astype(jnp.int32)
    tu_max = jnp.ceil((rel_u + support + 1).astype(jnp.float32)
                      * np.float32(1.0 / tile_size_u)).astype(jnp.int32)
    tv_min = jnp.floor((rel_v - support).astype(jnp.float32)
                       * np.float32(1.0 / tile_size_v)).astype(jnp.int32)
    tv_max = jnp.ceil((rel_v + support + 1).astype(jnp.float32)
                      * np.float32(1.0 / tile_size_v)).astype(jnp.int32)

    span = geom.max_tiles_spanned
    du = jnp.arange(span)
    dv = jnp.arange(span)
    pu = tu_min[..., None, None] + du[None, :, None]     # [T,B,C,su,1]
    pv = tv_min[..., None, None] + dv[None, None, :]     # [T,B,C,1,sv]
    valid = (ok[..., None, None]
             & (pu < tu_max[..., None, None])
             & (pv < tv_max[..., None, None]))
    tile_key = pv * _TILE_KEY_STRIDE + pu
    flat_vis_index = jnp.arange(pos_u.size).reshape(pos_u.shape)
    shape = valid.shape
    return (valid.reshape(-1),
            jnp.broadcast_to(tile_key, shape).reshape(-1),
            jnp.broadcast_to(pos_u[..., None, None], shape).reshape(-1),
            jnp.broadcast_to(pos_v[..., None, None], shape).reshape(-1),
            jnp.broadcast_to(flat_vis_index[..., None, None],
                             shape).reshape(-1),
            ok)


def count_and_prefix_sum(uvw: Array, freqs: Array, grid_size: int,
                         tile_size_u: int, tile_size_v: int,
                         cell_size_rad: float, support: int
                         ) -> Tuple[Array, Array, Array, int]:
    """Count visibilities per uv tile and build exclusive prefix sums.

    Equivalent of `sdp_count_and_prefix_sum` (sdp_tiled_functions.h:62):
    returns ``(tile_offsets [num_tiles+1], num_points_in_tiles
    [num_tiles], num_skipped [1], num_visibilities)`` — the total record
    count is returned directly instead of via an out-parameter.
    """
    uvw = jnp.asarray(uvw)
    freqs = jnp.asarray(freqs)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    uvw = _check_tiled_uvw(uvw)
    (valid, tile_key, _, _, _, ok) = _candidates(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support, geom)
    num_tiles = geom.num_tiles_u * geom.num_tiles_v
    # Reference key layout is pv * 32768 + pu; counts are stored
    # pu + pv * num_tiles_u.
    pu = tile_key % _TILE_KEY_STRIDE
    pv = tile_key // _TILE_KEY_STRIDE
    lin = jnp.where(valid, pu + pv * geom.num_tiles_u, 0)
    counts = jnp.zeros((num_tiles,), jnp.int32).at[lin].add(
        valid.astype(jnp.int32))
    offsets = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(counts).astype(jnp.int32)])
    num_skipped = jnp.sum(jnp.logical_not(ok)).astype(jnp.int32)[None]
    num_visibilities = int(offsets[-1])
    return offsets, counts, num_skipped, num_visibilities


def _check_tiled_uvw(uvw):
    """Data-model contract shared by the tiled trio: uvw must be the
    canonical ``[time, baseline, 3]`` layout (the reference validates
    via sdp_data_model_check_uvw on every entry,
    sdp_tiled_functions.cpp)."""
    uvw = jnp.asarray(uvw)
    if uvw.ndim != 3 or uvw.shape[-1] != 3:
        raise SdpShapeError(
            f"uvw must be [time, baseline, 3]; got {uvw.shape}")
    return uvw


def _sorted_records(uvw, freqs, grid_size, tile_size_u, tile_size_v,
                    cell_size_rad, support):
    uvw = _check_tiled_uvw(uvw)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    (valid, tile_key, pos_u, pos_v, vis_idx, _) = _candidates(
        jnp.asarray(uvw), jnp.asarray(freqs), grid_size, tile_size_u,
        tile_size_v, cell_size_rad, support, geom)
    big = jnp.iinfo(jnp.int32).max
    key = jnp.where(valid, tile_key, big)
    order = jnp.argsort(key, stable=True)
    num_records = int(jnp.sum(valid))
    sel = order[:num_records]
    return (tile_key[sel].astype(jnp.int32), pos_u[sel], pos_v[sel],
            vis_idx[sel], geom)


def bucket_sort(uvw: Array, freqs: Array, vis: Array, weights: Array,
                grid_size: int, tile_size_u: int, tile_size_v: int,
                cell_size_rad: float, support: int):
    """Bucket-sort visibilities into tile order (duplicating overlaps).

    Equivalent of `sdp_bucket_sort` (sdp_tiled_functions.h:136); returns
    ``(sorted_uu, sorted_vv, sorted_weight, sorted_tile, sorted_vis)``.
    Ordering within a tile is deterministic (stable sort) rather than the
    reference's atomic arrival order.
    """
    vis = jnp.asarray(vis)
    weights = jnp.asarray(weights)
    tile, uu, vv, idx, _ = _sorted_records(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support)
    vis_flat = vis[..., 0].reshape(-1) if vis.ndim == 4 \
        else vis.reshape(-1)
    w_flat = weights[..., 0].reshape(-1) if weights.ndim == 4 \
        else weights.reshape(-1)
    return uu, vv, w_flat[idx], tile, vis_flat[idx]


def tiled_indexing(uvw: Array, freqs: Array, grid_size: int,
                   tile_size_u: int, tile_size_v: int,
                   cell_size_rad: float, support: int):
    """Index-only bucket sort (`sdp_tiled_indexing`,
    sdp_tiled_functions.h:200): returns
    ``(sorted_uu, sorted_vv, sorted_vis_index, sorted_tile)``."""
    tile, uu, vv, idx, _ = _sorted_records(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support)
    return uu, vv, idx.astype(jnp.int32), tile
