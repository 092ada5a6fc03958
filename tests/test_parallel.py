"""Multi-chip distribution tests on the virtual 8-device CPU mesh.

The reference validates its GPU kernels against the CPU result
(tests/grid_data/test_gridder_wtower_uvw.py:1848,1869); we validate the
N-device `shard_map` path against the single-chip driver the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.grid_data import (
    wstack_wtower_degrid_all,
    wstack_wtower_grid_all,
)
from ska_sdp_func_jax.parallel import (
    make_mesh,
    plan_wstack,
    wstack_degrid_all_sharded,
    wstack_grid_all_sharded,
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
    image = np.zeros((IMAGE_SIZE, IMAGE_SIZE))
    image[IMAGE_SIZE // 3, IMAGE_SIZE // 3] = 1.0
    image[3 * IMAGE_SIZE // 4, IMAGE_SIZE // 2] = 0.5
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan)))
    plan = plan_wstack(uvw, freq0, dfreq, num_chan, IMAGE_SIZE, **PARAMS)
    return dict(uvw=uvw, vis=vis, num_chan=num_chan, freq0=freq0,
                dfreq=dfreq, image=image, plan=plan)


def test_plan_has_tasks(scenario):
    plan = scenario["plan"]
    assert len(plan.tasks) > 0
    assert len(plan.w_plane_ids) >= 1
    # Every task's w-plane is listed.
    assert {t.iw for t in plan.tasks} == set(plan.w_plane_ids)


@pytest.mark.slow
@pytest.mark.parametrize(
    "n_dev", [pytest.param(1, marks=pytest.mark.verylong), 8])
def test_sharded_grid_matches_single_chip(scenario, n_dev):
    s = scenario
    mesh = make_mesh(n_dev)
    image = wstack_grid_all_sharded(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]), mesh,
        image_dtype=jnp.float64)
    ref = wstack_wtower_grid_all(
        jnp.asarray(s["vis"]), s["freq0"], s["dfreq"],
        jnp.asarray(s["uvw"]), image=jnp.zeros((IMAGE_SIZE, IMAGE_SIZE)),
        **PARAMS)
    # Exclude the image border: the 1/PSWF grid correction reaches ~1e15
    # there and amplifies float reassociation under whole-graph jit — the
    # reference tests exclude a border for the same reason
    # (test_gridder_wtower_uvw.py:2188-2193).
    b = 8
    np.testing.assert_allclose(np.asarray(image)[b:-b, b:-b],
                               np.asarray(ref)[b:-b, b:-b], atol=1e-10)


@pytest.mark.slow
@pytest.mark.parametrize(
    "n_dev", [pytest.param(1, marks=pytest.mark.verylong), 8])
def test_sharded_degrid_matches_single_chip(scenario, n_dev):
    s = scenario
    mesh = make_mesh(n_dev)
    vis = wstack_degrid_all_sharded(
        s["plan"], jnp.asarray(s["image"], dtype=complex),
        jnp.asarray(s["uvw"]), mesh)
    ref = wstack_wtower_degrid_all(
        jnp.asarray(s["image"], dtype=complex), s["freq0"], s["dfreq"],
        jnp.asarray(s["uvw"]),
        vis=jnp.zeros((s["uvw"].shape[0], s["num_chan"]), complex),
        **PARAMS)
    np.testing.assert_allclose(np.asarray(vis), np.asarray(ref),
                               atol=1e-12)


@pytest.mark.slow
def test_degrid_row_count_not_divisible(scenario):
    """Row padding: 100 rows over 8 devices needs 4 pad rows."""
    s = scenario
    mesh = make_mesh(8)
    vis = wstack_degrid_all_sharded(
        s["plan"], jnp.asarray(s["image"], dtype=complex),
        jnp.asarray(s["uvw"]), mesh)
    assert vis.shape == (100, s["num_chan"])
    assert bool(jnp.any(vis != 0))
