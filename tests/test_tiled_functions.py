"""Tiling and optimized-weighting tests with numpy oracles."""

import numpy as np
import jax.numpy as jnp
import pytest

from ska_sdp_func_jax.visibility.tiled_functions import (
    _geometry,
    bucket_sort,
    count_and_prefix_sum,
    tiled_indexing,
)
from ska_sdp_func_jax.visibility.opt_weighting import (
    optimised_indexed_weighting,
    optimized_weighting,
)

C_0 = 299792458.0


def oracle_tiles(uvw, freqs, grid_size, tile_u, tile_v, cell, support):
    """Per-sample list of (tile_key, pos_u, pos_v, flat_idx); skipped
    count (algorithm of sdp_tiled_functions.cu:63-125)."""
    geom = _geometry(grid_size, tile_u, tile_v, support)
    centre = grid_size // 2
    scale = grid_size * cell
    records = []
    skipped = 0
    T, B, _ = uvw.shape
    C = len(freqs)
    flat = 0
    for t in range(T):
        for b in range(B):
            for c in range(C):
                inv_wave = freqs[c] / C_0
                pos_u = uvw[t, b, 0] * inv_wave * scale
                pos_v = uvw[t, b, 1] * inv_wave * scale
                gu = int(round(pos_u)) + centre
                gv = int(round(pos_v)) + centre
                if not (gu + support < grid_size and gu - support >= 0
                        and gv + support < grid_size
                        and gv - support >= 0):
                    skipped += 1
                    flat += 1
                    continue
                ru, rv = gu - geom.top_left_u, gv - geom.top_left_v
                tu0 = int(np.floor(np.float32(ru - support)
                                   * np.float32(1 / tile_u)))
                tu1 = int(np.ceil(np.float32(ru + support + 1)
                                  * np.float32(1 / tile_u)))
                tv0 = int(np.floor(np.float32(rv - support)
                                   * np.float32(1 / tile_v)))
                tv1 = int(np.ceil(np.float32(rv + support + 1)
                                  * np.float32(1 / tile_v)))
                for pv in range(tv0, tv1):
                    for pu in range(tu0, tu1):
                        records.append((pv * 32768 + pu, pos_u, pos_v,
                                        flat))
                flat += 1
    return records, skipped


@pytest.fixture()
def tile_data():
    rng = np.random.default_rng(3)
    T, B, C = 3, 20, 2
    grid_size, cell = 64, 1e-4
    # keep grid positions well inside the grid
    max_u = (grid_size / 2 - 8) / (grid_size * cell) * C_0 / (1.1 * C_0)
    uvw = rng.uniform(-1, 1, (T, B, 3)) * max_u * 0.8
    freqs = np.array([C_0, 1.1 * C_0])
    vis = (rng.standard_normal((T, B, C, 1))
           + 1j * rng.standard_normal((T, B, C, 1)))
    weights = rng.uniform(0.5, 2.0, (T, B, C, 1))
    return dict(uvw=uvw, freqs=freqs, vis=vis, weights=weights,
                grid_size=grid_size, cell=cell)


def test_count_and_prefix_sum_matches_oracle(tile_data):
    d = tile_data
    tile_u = tile_v = 16
    support = 3
    offsets, counts, skipped, total = count_and_prefix_sum(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]), d["grid_size"],
        tile_u, tile_v, d["cell"], support)
    records, skipped_ref = oracle_tiles(
        d["uvw"], d["freqs"], d["grid_size"], tile_u, tile_v, d["cell"],
        support)
    geom = _geometry(d["grid_size"], tile_u, tile_v, support)
    counts_ref = np.zeros(geom.num_tiles_u * geom.num_tiles_v, int)
    for key, _, _, _ in records:
        pu, pv = key % 32768, key // 32768
        counts_ref[pu + pv * geom.num_tiles_u] += 1
    np.testing.assert_array_equal(np.asarray(counts), counts_ref)
    np.testing.assert_array_equal(np.asarray(offsets),
                                  np.concatenate([[0],
                                                  np.cumsum(counts_ref)]))
    assert int(skipped[0]) == skipped_ref
    assert total == len(records)


def test_bucket_sort_matches_oracle_multiset(tile_data):
    d = tile_data
    tile_u = tile_v = 16
    support = 3
    uu, vv, w, tile, vis = bucket_sort(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]),
        jnp.asarray(d["vis"]), jnp.asarray(d["weights"]), d["grid_size"],
        tile_u, tile_v, d["cell"], support)
    records, _ = oracle_tiles(
        d["uvw"], d["freqs"], d["grid_size"], tile_u, tile_v, d["cell"],
        support)
    # tiles must be sorted and the (tile, vis_index) multiset must match
    tiles = np.asarray(tile)
    assert (np.diff(tiles) >= 0).all()
    got = sorted(zip(tiles.tolist(), np.asarray(uu).round(9).tolist()))
    expected = sorted((k, round(pu, 9)) for k, pu, _, _ in records)
    assert got == expected


def test_tiled_indexing_indices(tile_data):
    d = tile_data
    tile_u = tile_v = 16
    support = 3
    uu, vv, idx, tile = tiled_indexing(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]), d["grid_size"],
        tile_u, tile_v, d["cell"], support)
    records, _ = oracle_tiles(
        d["uvw"], d["freqs"], d["grid_size"], tile_u, tile_v, d["cell"],
        support)
    got = sorted(zip(np.asarray(tile).tolist(), np.asarray(idx).tolist()))
    expected = sorted((k, i) for k, _, _, i in records)
    assert got == expected


def test_optimized_weighting_per_tile_briggs(tile_data):
    """Weights follow w/(1 + r_tile * cell) with per-tile robustness."""
    d = tile_data
    tile_u = tile_v = 16
    support = 0  # no duplication: each record in exactly one tile region
    sorted_tile, out = optimized_weighting(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]),
        jnp.asarray(d["vis"]), jnp.asarray(d["weights"]), 0.5,
        d["grid_size"], d["cell"], support, tile_u, tile_v)
    out = np.asarray(out)
    assert out.shape == np.asarray(sorted_tile).shape
    assert (out > 0).sum() > 0
    # All positive weights bounded by the input weights.
    w_in = d["weights"].ravel()
    assert out.max() <= w_in.max()


def test_optimised_indexed_weighting_layout(tile_data):
    d = tile_data
    idx, out = optimised_indexed_weighting(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]),
        jnp.asarray(d["vis"]), jnp.asarray(d["weights"]), 0.0,
        d["grid_size"], d["cell"], 0, 16, 16)
    assert out.shape == d["weights"].shape
    # Every touched weight is positive and <= input.
    out = np.asarray(out)
    touched = out > 0
    assert touched.any()
    assert (out[touched] <= d["weights"][touched] + 1e-12).all()
