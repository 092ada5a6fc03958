"""Tests for the direct gridder, custom degridder and tower-height tuner."""

import numpy as np
import jax.numpy as jnp
import pytest

from ska_sdp_func_jax.grid_data import (
    GridderDirect,
    GridderWtowerUVW,
    degrid_uvw_custom,
    determine_max_w_tower_height,
    make_pswf_kernel,
    worst_case_image,
)

C_0 = 299792458.0


def test_direct_gridder_is_oracle_for_wtower():
    """The w-towers degridder must approximate the direct (DFT) gridder —
    the reference's core accuracy-oracle relationship."""
    rng = np.random.default_rng(1)
    size, theta, w_step = 64, 0.002, 100.0
    num_rows, num_chan = 100, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([7000.0, 7000.0,
                                                        150.0])
    start = np.zeros(num_rows, np.int32)
    end = np.full(num_rows, num_chan, np.int32)
    image = np.zeros((size, size))
    image[size // 3, size // 4] = 1.0
    image[2 * size // 3, size // 2] = 0.7

    direct = GridderDirect(size, size, theta, w_step, 0.0, 0.0, 8)
    wtower = GridderWtowerUVW(size, size, theta, w_step, 0.0, 0.0, 8,
                              16 * 1024, 4, 16 * 1024)
    img_direct = direct.degrid_correct(jnp.asarray(image, dtype=complex))
    img_wtower = wtower.degrid_correct(jnp.asarray(image, dtype=complex))
    vis_direct = direct.degrid_subgrid(
        img_direct, (0, 0, 0), num_chan, C_0, C_0 / 100, jnp.asarray(uvw),
        jnp.asarray(start), jnp.asarray(end))
    vis_wtower = wtower.degrid_subgrid(
        img_wtower, (0, 0, 0), num_chan, C_0, C_0 / 100, jnp.asarray(uvw),
        jnp.asarray(start), jnp.asarray(end))
    got = np.asarray(vis_wtower)
    expected = np.asarray(vis_direct)
    mask = np.abs(got) > 0
    assert mask.sum() > 0.8 * mask.size
    err = np.abs(got[mask] - expected[mask]).max()
    assert err < 5e-4 * np.abs(expected[mask]).max()


def test_direct_gridder_grid_adjoint():
    rng = np.random.default_rng(2)
    size, theta, w_step = 32, 0.002, 100.0
    num_rows, num_chan = 50, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([3000.0, 3000.0,
                                                        100.0])
    start = np.zeros(num_rows, np.int32)
    end = np.full(num_rows, num_chan, np.int32)
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan)))
    image = rng.standard_normal((size, size))
    direct = GridderDirect(size, size, theta, w_step, 0.0, 0.0, 8)
    predicted = direct.degrid_subgrid(
        jnp.asarray(image, dtype=complex), (0, 0, 0), num_chan, C_0,
        C_0 / 100, jnp.asarray(uvw), jnp.asarray(start), jnp.asarray(end))
    gridded = direct.grid_subgrid(
        jnp.asarray(vis), jnp.asarray(uvw), jnp.asarray(start),
        jnp.asarray(end), num_chan, C_0, C_0 / 100,
        jnp.zeros((size, size), complex), (0, 0, 0))
    # Taper appears on both sides: <vis, A x> == <A^T vis, x> with x the
    # *untapered* image and taper inside both operators.
    lhs = np.vdot(np.asarray(vis), np.asarray(predicted))
    rhs = np.vdot(np.asarray(gridded), image)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_degrid_uvw_custom_single_point():
    """A unit grid point at the snapped location reproduces the kernel
    separable weight; oracle is a direct numpy loop."""
    rng = np.random.default_rng(3)
    x_size = y_size = 32
    z_size = 4
    num_chan, num_pols = 2, 1
    T, B = 2, 8
    uv_os, uv_ks = 8, 4
    w_os, w_ks = 4, 4
    theta, wstep = 0.01, 200.0
    grid = (rng.standard_normal((num_chan, z_size, y_size, x_size, num_pols))
            + 1j * rng.standard_normal((num_chan, z_size, y_size, x_size,
                                        num_pols)))
    uv_kernel = rng.random((uv_os, uv_ks))
    w_kernel = rng.random((w_os, w_ks))
    uvw = rng.uniform(-1, 1, (T, B, 3)) * np.array([800.0, 800.0, 100.0])
    f0, df = C_0, C_0 / 100

    got = np.asarray(degrid_uvw_custom(
        jnp.asarray(grid), jnp.asarray(uvw), jnp.asarray(uv_kernel),
        jnp.asarray(w_kernel), theta, wstep, f0, df))

    # numpy oracle replicating calculate_coordinates + separable taps
    expected = np.zeros((T, B, num_chan, num_pols), complex)
    half = uv_ks // 2
    for t in range(T):
        for b in range(B):
            for c in range(num_chan):
                inv_wave = (f0 + c * df) / C_0
                u, v, w = uvw[t, b] * inv_wave
                iox = int(round(theta * u * uv_os)) \
                    + (x_size // 2 + 1) * uv_os - 1
                home_x, frac_x = iox // uv_os, uv_os - 1 - iox % uv_os
                ioy = int(round(theta * v * uv_os)) \
                    + (y_size // 2 + 1) * uv_os - 1
                home_y, frac_y = ioy // uv_os, uv_os - 1 - ioy % uv_os
                ioz = int(round((1 + w / wstep) * w_os)) + w_os - 1
                frac_z = w_os - 1 - ioz % w_os
                if not (half < home_x < x_size - half
                        and half < home_y < y_size - half):
                    continue
                for p in range(num_pols):
                    acc = 0j
                    for z in range(w_ks):
                        for y in range(uv_ks):
                            for x in range(uv_ks):
                                acc += (w_kernel[frac_z, z]
                                        * uv_kernel[frac_y, y]
                                        * uv_kernel[frac_x, x]
                                        * grid[c, z, home_y + y - half,
                                               home_x + x - half, p])
                    expected[t, b, c, p] = acc
    np.testing.assert_allclose(got, expected, atol=1e-12)
    assert np.abs(expected).max() > 0


def test_degrid_uvw_custom_conjugate():
    rng = np.random.default_rng(5)
    grid = (rng.standard_normal((1, 2, 16, 16, 1))
            + 1j * rng.standard_normal((1, 2, 16, 16, 1)))
    uvw = rng.uniform(-1, 1, (1, 4, 3)) * 200.0
    uv_k = rng.random((4, 4))
    w_k = rng.random((4, 2))
    a = degrid_uvw_custom(jnp.asarray(grid), jnp.asarray(uvw),
                          jnp.asarray(uv_k), jnp.asarray(w_k), 0.01, 100.0,
                          C_0, 0.0, conjugate=False)
    b = degrid_uvw_custom(jnp.asarray(grid), jnp.asarray(uvw),
                          jnp.asarray(uv_k), jnp.asarray(w_k), 0.01, 100.0,
                          C_0, 0.0, conjugate=True)
    np.testing.assert_allclose(np.asarray(b), np.conj(np.asarray(a)),
                               atol=1e-14)


def test_worst_case_image():
    image = worst_case_image(0.002, 0.001, 128)
    nz = np.transpose(np.nonzero(image))
    assert len(nz) == 4
    assert np.isrealobj(image.real)
    # off-centre, asymmetric placement
    assert not np.allclose(image, image[::-1, ::-1])


@pytest.mark.filterwarnings("ignore")
def test_determine_max_w_tower_height_runs():
    height = determine_max_w_tower_height(
        image_size=128, subgrid_size=32, theta=0.002, w_step=100.0,
        support=8, oversampling=16 * 1024, w_support=4,
        w_oversampling=16 * 1024, fov=0.001)
    assert height >= 2
    assert height % 2 == 0


def test_deprecated_grid_degrid_signatures_match_subgrid_forms():
    """The reference's pre-1.2 grid/degrid signatures
    (gridder_wtower_uvw.py:62-79, 212-229) forward to the *_subgrid
    forms (functional: results returned, not written in place)."""
    rng = np.random.default_rng(4)
    size, theta, w_step = 64, 0.002, 100.0
    num_rows, num_chan = 50, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([6000.0, 6000.0,
                                                        120.0])
    start = jnp.zeros(num_rows, jnp.int32)
    end = jnp.full(num_rows, num_chan, jnp.int32)
    freq0, dfreq = C_0, C_0 / 100
    kern = GridderWtowerUVW(size, size, theta, w_step, 0.0, 0.0, 8,
                            16 * 1024, 4, 16 * 1024)
    img = np.zeros((size, size))
    img[20, 24] = 1.0
    facet = kern.degrid_correct(jnp.asarray(img, complex))
    from ska_sdp_func_jax.fourier_transforms.fft import fft_shifted, \
        ifft_shifted_norm
    sub = ifft_shifted_norm(fft_shifted(facet))
    vis_t = jnp.zeros((num_rows, num_chan), jnp.complex128)
    old = kern.degrid(sub, 0, 0, 0, freq0, dfreq, jnp.asarray(uvw),
                      start, end, vis_t)
    new = kern.degrid_subgrid(sub, (0, 0, 0), num_chan, freq0, dfreq,
                              jnp.asarray(uvw), start, end, vis_t)
    np.testing.assert_array_equal(np.asarray(old), np.asarray(new))

    sg0 = jnp.zeros((size, size), jnp.complex128)
    g_old = kern.grid(old, jnp.asarray(uvw), start, end, freq0, dfreq,
                      sg0, 0, 0, 0)
    g_new = kern.grid_subgrid(old, jnp.asarray(uvw), start, end,
                              num_chan, freq0, dfreq, sg0, (0, 0, 0))
    np.testing.assert_array_equal(np.asarray(g_old), np.asarray(g_new))
