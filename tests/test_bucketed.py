"""Bucketed w-stacking drivers vs the task drivers (f32 perf path)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.parallel import plan_wstack
from ska_sdp_func_jax.parallel.bucketed import (
    degrid_all_bucketed,
    grid_all_bucketed,
    inverse_index_of,
    plan_bucketed,
)
from ska_sdp_func_jax.parallel.wstack import (
    degrid_all_tasks,
    grid_all_tasks,
)

C_0 = 299792458.0

PARAMS = dict(
    subgrid_size=32,
    theta=0.002,
    w_step=50.0,
    shear_u=0.0,
    shear_v=0.0,
    support=8,
    oversampling=16 * 1024,
    w_support=4,
    w_oversampling=16 * 1024,
    subgrid_frac=2.0 / 3.0,
    w_tower_height=4.0,
)
IMAGE_SIZE = 128


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.default_rng(5)
    num_rows, num_chan = 100, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * IMAGE_SIZE / 2 / PARAMS["theta"]
    uvw[:, 2] *= 2.0 * PARAMS["w_step"] * PARAMS["w_tower_height"] / 2
    freq0, dfreq = C_0, C_0 / 100
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan))
           ).astype(np.complex64)
    plan = plan_wstack(uvw, freq0, dfreq, num_chan, IMAGE_SIZE, **PARAMS)
    bplan, sort_index, valid = plan_bucketed(plan, uvw, block_v=128)
    return dict(uvw=uvw.astype(np.float32), vis=vis, plan=plan,
                bplan=bplan, sort_index=sort_index, valid=valid,
                num_chan=num_chan)


def test_bucket_partition_complete(scenario):
    """Every (row, channel) visibility lands in exactly one bucket."""
    s = scenario
    assert int(s["valid"].sum()) == s["uvw"].shape[0] * s["num_chan"]
    # Padded totals are block multiples per task.
    for t in s["bplan"].tasks:
        assert t.size % 128 == 0


@pytest.mark.verylong
@pytest.mark.slow
def test_bucketed_grid_matches_task_driver(scenario):
    s = scenario
    uvw = jnp.asarray(s["uvw"])
    img_b = grid_all_bucketed(
        s["bplan"], jnp.asarray(s["vis"]), uvw,
        jnp.asarray(s["sort_index"]), jnp.asarray(s["valid"]))
    n = s["uvw"].shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), s["num_chan"], jnp.int32)
    img_r = grid_all_tasks(s["plan"], s["plan"].kernel(),
                           jnp.asarray(s["vis"]), uvw, st, en).real
    b = 16  # PSWF correction amplifies f32 noise towards the edge
    scale = float(np.abs(np.asarray(img_r)[b:-b, b:-b]).max())
    np.testing.assert_allclose(
        np.asarray(img_b)[b:-b, b:-b], np.asarray(img_r)[b:-b, b:-b],
        atol=1e-4 * scale)


@pytest.mark.slow
def test_bucketed_degrid_matches_task_driver(scenario):
    s = scenario
    uvw = jnp.asarray(s["uvw"])
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    img[IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15] = 0.5
    inv = inverse_index_of(s["sort_index"], s["valid"],
                           s["uvw"].shape[0] * s["num_chan"])
    vis_b = degrid_all_bucketed(
        s["bplan"], jnp.asarray(img), uvw, jnp.asarray(s["sort_index"]),
        jnp.asarray(s["valid"]), jnp.asarray(inv))
    n = s["uvw"].shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), s["num_chan"], jnp.int32)
    vis_r = degrid_all_tasks(s["plan"], s["plan"].kernel(),
                             jnp.asarray(img, jnp.complex64), uvw, st, en,
                             jnp.complex64)
    scale = float(np.abs(np.asarray(vis_r)).max())
    np.testing.assert_allclose(np.asarray(vis_b), np.asarray(vis_r),
                               atol=1e-4 * scale)


@pytest.mark.verylong
@pytest.mark.slow
def test_bucketed_sharded_matches_single(scenario):
    """The mesh-sharded bucketed grid equals the single-chip bucketed
    grid (the GPU-vs-CPU consistency pattern)."""
    from ska_sdp_func_jax.parallel import make_mesh
    from ska_sdp_func_jax.parallel.bucketed import grid_all_bucketed_sharded

    s = scenario
    uvw = jnp.asarray(s["uvw"])
    img_1 = grid_all_bucketed(
        s["bplan"], jnp.asarray(s["vis"]), uvw,
        jnp.asarray(s["sort_index"]), jnp.asarray(s["valid"]))
    img_8 = grid_all_bucketed_sharded(
        s["bplan"], jnp.asarray(s["vis"]), uvw,
        jnp.asarray(s["sort_index"]), jnp.asarray(s["valid"]),
        make_mesh(8))
    # Partial-accumulator FFT drains reassociate f32 sums; the 1/PSWF
    # correction amplifies that towards the border.
    b = 24
    scale = float(np.abs(np.asarray(img_1)[b:-b, b:-b]).max())
    np.testing.assert_allclose(
        np.asarray(img_8)[b:-b, b:-b], np.asarray(img_1)[b:-b, b:-b],
        atol=1e-4 * scale)
