"""Inner-tap kernel implementations agree with each other.

The scatter formulation is validated against the in-file NumPy oracle in
test_wtower.py; here the dense banded-matmul path is validated against
the scatter path, and its all-layer twin (the bucketed driver's inner
tap) against a NumPy scatter/gather oracle — the
implementation-consistency pattern the reference uses for GPU-vs-CPU
(tests/grid_data/test_gridder_wtower_uvw.py:1848,1869).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.grid_data.wtower import (
    GridderWtowerUVW,
    _degrid_plane,
    _grid_plane_scatter,
    _plane_geometry,
)
from ska_sdp_func_jax.kernels.dense_tap import (
    degrid_all_layers_dense,
    degrid_plane_dense,
    grid_all_layers_dense,
    grid_plane_dense,
)

C_0 = 299792458.0
SG = 32
SUPPORT, W_SUPPORT = 8, 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    num_rows, num_chan = 100, 3
    theta, w_step = 0.002, 100.0
    freq0, dfreq = C_0, C_0 / (100 * num_chan)
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.4 * SG / 2 / theta
    uvw[:, 2] *= 1.5 * w_step
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan)))
    plan = GridderWtowerUVW(SG, SG, theta, w_step, 0, 0, SUPPORT, 16384,
                            W_SUPPORT, 16384)
    geom = _plane_geometry(
        jnp.asarray(uvw), jnp.zeros(num_rows, jnp.int32),
        jnp.full(num_rows, num_chan, jnp.int32), jnp.asarray(0),
        jnp.asarray(0), jnp.asarray(0), jnp.asarray(0), freq0, dfreq,
        num_chan, theta, w_step, SUPPORT, 16384, W_SUPPORT, 16384, SG,
        0, num_rows)
    uvk = jnp.asarray(plan.uv_kernel)
    wk = jnp.asarray(plan.w_kernel)
    vis = jnp.asarray(vis)
    subgrids = jnp.asarray(
        rng.standard_normal((W_SUPPORT, SG, SG))
        + 1j * rng.standard_normal((W_SUPPORT, SG, SG)))
    return dict(geom=geom, uvk=uvk, wk=wk, vis=vis, subgrids=subgrids)


def test_dense_grid_matches_scatter_f64(setup):
    s = setup
    zero = jnp.zeros((W_SUPPORT, SG, SG), s["vis"].dtype)
    ref = _grid_plane_scatter(zero, s["vis"], s["uvk"], s["wk"], s["geom"],
                              SUPPORT, W_SUPPORT)
    out = grid_plane_dense(zero, s["vis"], s["uvk"], s["wk"], s["geom"],
                           SUPPORT, W_SUPPORT)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-12)


def test_dense_degrid_matches_gather_f64(setup):
    s = setup
    ref = _degrid_plane(s["subgrids"], s["uvk"], s["wk"], s["geom"],
                        SUPPORT, W_SUPPORT)
    out = degrid_plane_dense(s["subgrids"], s["uvk"], s["wk"], s["geom"],
                             SUPPORT, W_SUPPORT)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=1e-12)


def test_dense_adjointness(setup):
    s = setup
    rng = np.random.default_rng(2)
    zero = jnp.zeros((W_SUPPORT, SG, SG), s["vis"].dtype)
    aty = grid_plane_dense(zero, s["vis"], s["uvk"], s["wk"], s["geom"],
                           SUPPORT, W_SUPPORT)
    ax = degrid_plane_dense(s["subgrids"], s["uvk"], s["wk"], s["geom"],
                            SUPPORT, W_SUPPORT)
    lhs = np.vdot(np.asarray(ax), np.asarray(s["vis"]))
    rhs = np.vdot(np.asarray(s["subgrids"]), np.asarray(aty))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


# All-layer twin: (num_layers K, subgrid N, support S, w_support Sw).
ALL_LAYER_CASES = [(7, 32, 8, 4), (5, 64, 6, 3)]


def _all_layer_taps(num_k, size, support, w_support, seed=0):
    rng = np.random.default_rng(seed)
    num_v = 300
    iu0 = rng.integers(0, size - support + 1, num_v)
    iv0 = rng.integers(0, size - support + 1, num_v)
    slab = rng.integers(0, num_k - w_support + 1, num_v)
    uk = rng.random((num_v, support))
    vk = rng.random((num_v, support))
    wk = rng.random((num_v, w_support))
    weights = np.zeros((num_v, num_k))
    for layer in range(w_support):
        weights[np.arange(num_v), slab + layer] = wk[:, layer]
    vis = rng.standard_normal(num_v) + 1j * rng.standard_normal(num_v)
    return iu0, iv0, uk, vk, weights, vis


@pytest.mark.parametrize("num_k,size,support,w_support", ALL_LAYER_CASES)
def test_dense_all_layers_grid_matches_numpy_scatter(num_k, size, support,
                                                     w_support):
    iu0, iv0, uk, vk, weights, vis = _all_layer_taps(
        num_k, size, support, w_support)
    oracle = np.zeros((num_k, size, size), complex)
    for p in range(vis.shape[0]):
        patch = np.outer(uk[p], vk[p]) * vis[p]
        for k in range(num_k):
            oracle[k, iu0[p]:iu0[p] + support,
                   iv0[p]:iv0[p] + support] += weights[p, k] * patch
    out = grid_all_layers_dense(
        jnp.asarray(vis.real), jnp.asarray(vis.imag),
        jnp.asarray(iu0, jnp.int32), jnp.asarray(iv0, jnp.int32),
        jnp.asarray(uk), jnp.asarray(vk), jnp.asarray(weights), num_k,
        size)
    assert out.shape == (num_k, size, size)
    err = np.abs(np.asarray(out) - oracle).max() / np.abs(oracle).max()
    assert err < 2e-6


@pytest.mark.parametrize("num_k,size,support,w_support", ALL_LAYER_CASES)
def test_dense_all_layers_degrid_matches_numpy_gather(num_k, size,
                                                      support, w_support):
    iu0, iv0, uk, vk, weights, _ = _all_layer_taps(
        num_k, size, support, w_support)
    rng = np.random.default_rng(4)
    layers = (rng.standard_normal((num_k, size, size))
              + 1j * rng.standard_normal((num_k, size, size)))
    oracle = np.array([
        sum(weights[p, k] * np.sum(
            np.outer(uk[p], vk[p])
            * layers[k, iu0[p]:iu0[p] + support,
                     iv0[p]:iv0[p] + support])
            for k in range(num_k))
        for p in range(iu0.shape[0])])
    out = degrid_all_layers_dense(
        jnp.asarray(layers, jnp.complex64), jnp.asarray(iu0, jnp.int32),
        jnp.asarray(iv0, jnp.int32), jnp.asarray(uk), jnp.asarray(vk),
        jnp.asarray(weights))
    err = np.abs(np.asarray(out) - oracle).max() / np.abs(oracle).max()
    assert err < 2e-6


def test_dense_all_layers_adjointness():
    num_k, size, support, w_support = ALL_LAYER_CASES[0]
    iu0, iv0, uk, vk, weights, vis = _all_layer_taps(
        num_k, size, support, w_support, seed=3)
    rng = np.random.default_rng(5)
    layers = (rng.standard_normal((num_k, size, size))
              + 1j * rng.standard_normal((num_k, size, size)))
    args = (jnp.asarray(iu0, jnp.int32), jnp.asarray(iv0, jnp.int32),
            jnp.asarray(uk), jnp.asarray(vk), jnp.asarray(weights))
    aty = np.asarray(grid_all_layers_dense(
        jnp.asarray(vis.real), jnp.asarray(vis.imag), *args[:2],
        *args[2:], num_k, size))
    ax = np.asarray(degrid_all_layers_dense(
        jnp.asarray(layers, jnp.complex64), *args))
    lhs = np.vdot(ax, vis)
    rhs = np.vdot(layers, aty)
    assert abs(lhs - rhs) / abs(lhs) < 1e-5
