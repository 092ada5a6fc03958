"""Native host-runtime tests: C++ results match the NumPy fallback and
the jnp implementations."""

import numpy as np
import jax.numpy as jnp
import pytest

from ska_sdp_func_jax import native
from ska_sdp_func_jax.grid_data import uvw_bounds_all

C_0 = 299792458.0


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    uvw = rng.uniform(-1, 1, (500, 3)) * [[8000.0, 8000.0, 400.0]]
    start = np.zeros(500, np.int32)
    end = np.full(500, 4, np.int32)
    return uvw, start, end


def test_native_compiles():
    assert native.available(), "native host runtime failed to build"


def test_uvw_bounds_matches_jnp(data):
    uvw, start, end = data
    lo_n, hi_n = native.uvw_bounds(uvw, C_0, C_0 / 400, start, end)
    lo_j, hi_j = uvw_bounds_all(jnp.asarray(uvw), C_0, C_0 / 400,
                                jnp.asarray(start), jnp.asarray(end))
    np.testing.assert_allclose(lo_n, np.asarray(lo_j), rtol=1e-12)
    np.testing.assert_allclose(hi_n, np.asarray(hi_j), rtol=1e-12)


def test_plan_boxes_native_matches_numpy(data):
    uvw, start, end = data
    args = (uvw, C_0, C_0 / 400, 4, 300.0, 200.0,
            (-2, 2), (-2, 2), (-1, 1))
    c_n, lo_n, hi_n = native.plan_wstack_boxes(*args)
    c_p, lo_p, hi_p = native._plan_wstack_boxes_np(
        uvw, C_0, C_0 / 400, 4, 300.0, 200.0, -2, 5, -2, 5, -1, 3)
    np.testing.assert_array_equal(c_n, c_p)
    sel = c_n > 0
    np.testing.assert_allclose(lo_n[sel], lo_p[sel], rtol=1e-12)
    np.testing.assert_allclose(hi_n[sel], hi_p[sel], rtol=1e-12)
    # Every selected visibility is counted exactly once across w-planes.
    assert c_n.sum() > 0


def test_sort_and_prefix(data):
    uvw, _, _ = data
    perm = native.sort_rows_by_w(uvw)
    w = uvw[perm, 2]
    assert np.all(np.diff(w) >= 0)
    counts = np.asarray([3, 0, 5, 2], np.int64)
    np.testing.assert_array_equal(native.prefix_sum(counts),
                                  [0, 3, 3, 8, 10])


def test_packed_tasks_matches_numpy(data):
    """Native task enumeration must reproduce np.unique's ascending-key
    ids and the per-task scaled-w bounds exactly."""
    uvw, _, _ = data
    if not native.available():
        pytest.skip("native unavailable")
    freq0, dfreq, num_chan = C_0, C_0 / 400, 4
    d, wd = 350.0, 400.0
    out = native.packed_tasks(uvw, freq0, dfreq, num_chan, d, wd)
    assert out is not None
    task_id, boxes, wmin_t, wmax_t = out

    scale = (freq0 + dfreq * np.arange(num_chan)) / C_0
    u = (uvw[:, 0:1] * scale[None, :]).ravel()
    v = (uvw[:, 1:2] * scale[None, :]).ravel()
    w = (uvw[:, 2:3] * scale[None, :]).ravel()
    biu = np.floor(u / d + 0.5).astype(np.int64)
    biv = np.floor(v / d + 0.5).astype(np.int64)
    biw = np.floor(w / wd + 0.5).astype(np.int64)
    span = 1 << 20
    key = ((biw + span // 2) * span + (biu + span // 2)) * span \
        + (biv + span // 2)
    keys, tid_np = np.unique(key, return_inverse=True)
    np.testing.assert_array_equal(task_id, tid_np.ravel())
    np.testing.assert_array_equal(
        boxes, np.stack([keys // (span * span) - span // 2,
                         (keys // span) % span - span // 2,
                         keys % span - span // 2], axis=1))
    order = np.argsort(tid_np.ravel(), kind="stable")
    seg = np.searchsorted(tid_np.ravel()[order], np.arange(keys.size))
    np.testing.assert_allclose(
        wmin_t, np.minimum.reduceat(w[order], seg), rtol=0, atol=0)
    np.testing.assert_allclose(
        wmax_t, np.maximum.reduceat(w[order], seg), rtol=0, atol=0)


def test_hash_arrays_deterministic():
    if not native.available():
        pytest.skip("native unavailable")
    rng = np.random.default_rng(1)
    a = rng.standard_normal((1000, 4)).astype(np.float32)
    b = np.arange(3000, dtype=np.int64)
    h1 = native.hash_arrays([a, b])
    h2 = native.hash_arrays([a, b])
    assert h1 == h2 and h1.startswith("fnv64:")
    b2 = b.copy()
    b2[-1] += 1
    assert native.hash_arrays([a, b2]) != h1
    # Concatenation boundaries matter (no length-extension aliasing
    # between [a, b] and [a||b]).
    assert native.hash_arrays([a]) != native.hash_arrays([a, b])
