"""W-stacking driver tests.

Reference pattern (tests/grid_data/test_gridder_wtower_uvw.py:2100-2400):
degrid the whole image and compare against the exact point-source DFT;
grid all visibilities and compare the dirty image against the direct
iDFT image, excluding a border.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.grid_data import (
    dft,
    idft,
    image_lmn,
    image_to_flmn,
    wstack_wtower_degrid_all,
    wstack_wtower_grid_all,
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
    rng = np.random.default_rng(99)
    num_rows, num_chan = 200, 2
    # uvw spanning several sub-grids and a few w-stack planes.
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.35 * IMAGE_SIZE / 2 / PARAMS["theta"]
    uvw[:, 2] *= 3.0 * PARAMS["w_step"] * PARAMS["w_tower_height"] / 2
    freq0, dfreq = C_0, C_0 / 100
    image = np.zeros((IMAGE_SIZE, IMAGE_SIZE))
    image[IMAGE_SIZE // 3, IMAGE_SIZE // 3] = 1.0
    image[3 * IMAGE_SIZE // 4, IMAGE_SIZE // 2] = 0.5
    return dict(uvw=uvw, num_chan=num_chan, freq0=freq0, dfreq=dfreq,
                image=image)


@pytest.mark.slow
def test_degrid_all_matches_point_source_dft(scenario):
    s = scenario
    vis = wstack_wtower_degrid_all(
        jnp.asarray(s["image"], dtype=complex), s["freq0"], s["dfreq"],
        jnp.asarray(s["uvw"]), verbosity=1,
        vis=jnp.zeros((s["uvw"].shape[0], s["num_chan"]), complex),
        **PARAMS)
    flux, lmn = image_to_flmn(s["image"], PARAMS["theta"])
    vis_exact = dft(jnp.asarray(s["uvw"]), jnp.asarray(flux),
                    jnp.asarray(lmn), None, None, 0, 0, 0,
                    PARAMS["theta"], PARAMS["w_step"], s["freq0"],
                    s["dfreq"], s["num_chan"])
    got = np.asarray(vis)
    expected = np.asarray(vis_exact)
    assert np.abs(got).max() > 0.1
    err = np.abs(got - expected).max() / np.abs(expected).max()
    assert err < 5e-4, f"relative error {err}"


@pytest.mark.slow
def test_grid_all_matches_idft_image(scenario):
    s = scenario
    num_rows = s["uvw"].shape[0]
    rng = np.random.default_rng(3)
    vis = (rng.standard_normal((num_rows, s["num_chan"]))
           + 1j * rng.standard_normal((num_rows, s["num_chan"])))
    image = wstack_wtower_grid_all(
        jnp.asarray(vis), s["freq0"], s["dfreq"], jnp.asarray(s["uvw"]),
        image=jnp.zeros((IMAGE_SIZE, IMAGE_SIZE)), verbosity=1, **PARAMS)
    # Direct iDFT dirty image oracle.
    lmn = image_lmn((IMAGE_SIZE, IMAGE_SIZE), PARAMS["theta"])
    expected = np.asarray(idft(
        jnp.asarray(s["uvw"]), jnp.asarray(vis), lmn, None, None, None,
        0, 0, 0, PARAMS["theta"], PARAMS["w_step"], s["freq0"], s["dfreq"],
        image_shape=(IMAGE_SIZE, IMAGE_SIZE))).real
    got = np.asarray(image)
    border = 16
    inner = np.s_[border:-border, border:-border]
    scale = np.abs(expected[inner]).max()
    err = np.abs(got[inner] - expected[inner]).max() / scale
    assert err < 1e-3, f"relative interior error {err}"


@pytest.mark.slow
def test_grid_degrid_operator_consistency(scenario):
    """<A x, A x> via degrid == <x, A^T A x> via grid of the degrided vis
    (weak adjointness: corrections match on both sides)."""
    s = scenario
    x = jnp.asarray(s["image"], dtype=complex)
    vis = wstack_wtower_degrid_all(
        x, s["freq0"], s["dfreq"], jnp.asarray(s["uvw"]),
        vis=jnp.zeros((s["uvw"].shape[0], s["num_chan"]), complex),
        **PARAMS)
    back = wstack_wtower_grid_all(
        vis, s["freq0"], s["dfreq"], jnp.asarray(s["uvw"]),
        image=jnp.zeros((IMAGE_SIZE, IMAGE_SIZE), complex), **PARAMS)
    lhs = np.vdot(np.asarray(vis), np.asarray(vis)).real
    rhs = np.vdot(np.asarray(back), np.asarray(x)).real
    np.testing.assert_allclose(lhs, rhs, rtol=1e-2)


@pytest.mark.slow
def test_wstack_engine_packed_matches_reference():
    """engine="packed" routes the reference-API drivers through the
    packed production path; f32 results match the reference loop to
    kernel accuracy, and incompatible geometry raises."""
    from ska_sdp_func_jax.grid_data.wstack import (
        wstack_wtower_degrid_all,
        wstack_wtower_grid_all,
    )

    rng = np.random.default_rng(5)
    image_size, subgrid = 256, 128
    theta, w_step, height = 0.002, 100.0, 4.0
    rows, chans = 200, 2
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.3 * image_size / 2 / theta
    uvw[:, 2] *= 1.2 * w_step * height
    vis = (rng.standard_normal((rows, chans))
           + 1j * rng.standard_normal((rows, chans))).astype(np.complex64)
    freq0, dfreq = C_0, C_0 / 100
    geom = dict(subgrid_size=subgrid, theta=theta, w_step=w_step,
                shear_u=0.0, shear_v=0.0, support=8,
                oversampling=16 * 1024, w_support=4,
                w_oversampling=16 * 1024, subgrid_frac=2.0 / 3.0,
                w_tower_height=height)
    tmpl = np.zeros((image_size, image_size), np.float32)

    ref = np.asarray(wstack_wtower_grid_all(
        jnp.asarray(vis), freq0, dfreq, jnp.asarray(uvw), image=tmpl,
        **geom))
    got = np.asarray(wstack_wtower_grid_all(
        jnp.asarray(vis), freq0, dfreq, jnp.asarray(uvw), image=tmpl,
        engine="packed", **geom))
    # The 1/PSWF grid correction diverges in the border ring; compare
    # the interior (the reference's own border-excluded comparison,
    # tests/grid_data/test_gridder_wtower_uvw.py:2188-2193).
    b = image_size // 8
    inner = np.s_[b:-b, b:-b]
    scale = np.abs(ref[inner]).max()
    assert np.abs(got[inner] - ref[inner]).max() < 2e-3 * scale

    sky = np.zeros((image_size, image_size), np.float32)
    sky[130, 140] = 1.0
    vref = np.asarray(wstack_wtower_degrid_all(
        jnp.asarray(sky), freq0, dfreq, jnp.asarray(uvw),
        vis=vis, **geom))
    vgot = np.asarray(wstack_wtower_degrid_all(
        jnp.asarray(sky), freq0, dfreq, jnp.asarray(uvw),
        vis=vis, engine="packed", **geom))
    vscale = np.abs(vref).max()
    assert np.abs(vgot - vref).max() < 2e-3 * vscale

    # auto on a single-precision template with compatible geometry
    # agrees with packed; incompatible geometry raises for "packed".
    auto = np.asarray(wstack_wtower_grid_all(
        jnp.asarray(vis), freq0, dfreq, jnp.asarray(uvw), image=tmpl,
        engine="auto", **geom))
    np.testing.assert_array_equal(auto[inner], got[inner])
    bad = dict(geom, subgrid_size=96)
    with pytest.raises(Exception):
        wstack_wtower_grid_all(
            jnp.asarray(vis), freq0, dfreq, jnp.asarray(uvw),
            image=tmpl, engine="packed", **bad)
