"""Gridder helper tests with in-file numpy oracles (reference pattern:
tests/grid_data/test_gridder_wtower_uvw.py keeps readable numpy
implementations next to the assertions)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.grid_data import (
    accumulate_scaled_arrays,
    clamp_channels_inline,
    clamp_channels_single,
    clamp_channels_uv,
    determine_w_step,
    dft,
    idft,
    image_lmn,
    image_to_flmn,
    lm_to_n,
    make_kernel,
    make_pswf_kernel,
    make_w_pattern,
    rms_diff,
    scale_inv_array,
    shift_subgrids,
    subgrid_add,
    subgrid_cut_out,
    uvw_bounds_all,
)

C_0 = 299792458.0


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------

def oracle_make_kernel(window, oversampling):
    """Direct triple-loop DFT of the window
    (formula from sdp_gridder_utils.cpp:385-425)."""
    support = len(window)
    out = np.zeros((oversampling + 1, support))
    for i in range(oversampling + 1):
        for s_out in range(support):
            du = i - oversampling
            u = (s_out - support // 2) - du / oversampling
            val = 0.0
            for s_in in range(support):
                l = (s_in - support // 2) / support
                val += window[s_in] * math.cos(2 * math.pi * u * l)
            out[i, s_out] = val / support
    return out


def oracle_clamp(u, freq0, dfreq, start_ch, end_ch, min_u, max_u):
    """Scalar clamp (formula from sdp_gridder_clamp_channels.h:116-172)."""
    u0 = freq0 * u / C_0
    du = dfreq * u / C_0
    eta = max(abs(min_u - u0), abs(max_u - u0)) / 2147483645.0
    if du > eta:
        start_ch = max(start_ch, int(math.ceil((min_u - u0) / du)))
        end_ch = min(end_ch, int(math.ceil((max_u - u0) / du)))
    elif du < -eta:
        start_ch = max(start_ch, int(math.ceil((max_u - u0) / du)))
        end_ch = min(end_ch, int(math.ceil((min_u - u0) / du)))
    else:
        if min_u > u0 or max_u <= u0:
            return (0, 0)
    if end_ch <= start_ch:
        return (0, 0)
    return (start_ch, end_ch)


# ---------------------------------------------------------------------------
# Window / kernel construction
# ---------------------------------------------------------------------------

def test_make_kernel_matches_oracle():
    rng = np.random.default_rng(3)
    window = rng.random(8)
    kernel = make_kernel(window, oversampling=16)
    expected = oracle_make_kernel(window, 16)
    np.testing.assert_allclose(kernel, expected, atol=1e-13)


def test_make_pswf_kernel_shape_and_symmetry():
    support, oversampling = 8, 64
    kernel = make_pswf_kernel(support, support, oversampling)
    assert kernel.shape == (oversampling + 1, support)
    # Row `oversampling` is the on-grid kernel: symmetric about support//2.
    on_grid = kernel[oversampling]
    np.testing.assert_allclose(
        on_grid[1:], on_grid[1:][::-1], atol=1e-12)
    # Kernel rows should roughly sum to the window DC level (positive).
    assert np.all(kernel[oversampling // 2].sum() > 0)


def test_make_w_pattern_phase():
    subgrid, theta, w_step = 16, 0.01, 100.0
    pattern = make_w_pattern(subgrid, theta, 0.0, 0.0, w_step)
    assert pattern.shape == (subgrid, subgrid)
    np.testing.assert_allclose(np.abs(pattern), 1.0, atol=1e-14)
    # Centre pixel: l = m = 0 -> n = 0 -> phase 0.
    np.testing.assert_allclose(pattern[8, 8], 1.0 + 0j, atol=1e-15)
    # Check one off-centre pixel against the formula.
    il, im = 3, 12
    l = (il - 8) * theta / subgrid
    m = (im - 8) * theta / subgrid
    n = math.sqrt(1 - l * l - m * m) - 1
    np.testing.assert_allclose(
        pattern[il, im], np.exp(2j * np.pi * w_step * n), atol=1e-14)


def test_lm_to_n_sheared():
    l, m, hu, hv = 0.01, -0.02, 0.2, 0.1
    n = lm_to_n(l, m, hu, hv)
    # Defining property: the sheared n satisfies the quadratic
    # (n*sqrt(1+hu^2+hv^2) form); check against explicit formula.
    hul = hu * l + hv * m - 1
    hu2 = hu * hu + hv * hv + 1
    expected = (math.sqrt(hul * hul - hu2 * (l * l + m * m)) + hul) / hu2
    np.testing.assert_allclose(n, expected, rtol=1e-15)
    np.testing.assert_allclose(
        lm_to_n(l, m, 0.0, 0.0), math.sqrt(1 - l * l - m * m) - 1,
        rtol=1e-15)


# ---------------------------------------------------------------------------
# Channel clamping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clamp_channels_single_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    num = 200
    uvws = rng.uniform(-1000, 1000, (num, 3))
    uvws[::17] = 0.0  # exercise the du ~ 0 branch
    freq0, dfreq = 1e9, 1e6
    start = np.zeros(num, np.int32)
    end = np.full(num, 64, np.int32)
    min_u, max_u = -2.0, 2.5
    got_s, got_e = clamp_channels_single(
        jnp.asarray(uvws), 0, freq0, dfreq, jnp.asarray(start),
        jnp.asarray(end), min_u, max_u)
    for i in range(num):
        exp_s, exp_e = oracle_clamp(
            uvws[i, 0], freq0, dfreq, int(start[i]), int(end[i]),
            min_u, max_u)
        assert (int(got_s[i]), int(got_e[i])) == (exp_s, exp_e), i


def test_clamp_channels_uv_matches_sequential_single():
    rng = np.random.default_rng(7)
    uvws = rng.uniform(-500, 500, (100, 3))
    freq0, dfreq = 1.2e9, 2e6
    start = np.zeros(100, np.int32)
    end = np.full(100, 32, np.int32)
    s1, e1 = clamp_channels_single(
        jnp.asarray(uvws), 0, freq0, dfreq, jnp.asarray(start),
        jnp.asarray(end), -1.0, 1.0)
    s2, e2 = clamp_channels_single(
        jnp.asarray(uvws), 1, freq0, dfreq, s1, e1, -0.5, 1.5)
    s_uv, e_uv = clamp_channels_uv(
        jnp.asarray(uvws), freq0, dfreq, jnp.asarray(start),
        jnp.asarray(end), -1.0, 1.0, -0.5, 1.5)
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(s_uv))
    np.testing.assert_array_equal(np.asarray(e2), np.asarray(e_uv))


def test_clamp_channels_non_overlap_property():
    """Adjacent boxes sharing a boundary never produce overlapping ranges
    (the documented symmetry property)."""
    u = 123.456
    freq0, dfreq = 1e9, 3e6
    s1, e1 = clamp_channels_inline(u, freq0, dfreq, 0, 1000, 0.0, 250.0)
    s2, e2 = clamp_channels_inline(u, freq0, dfreq, 0, 1000, 250.0, 500.0)
    if int(e1) > int(s1) and int(e2) > int(s2):
        assert int(e1) <= int(s2)


# ---------------------------------------------------------------------------
# uvw bounds
# ---------------------------------------------------------------------------

def test_uvw_bounds_all_matches_oracle():
    rng = np.random.default_rng(11)
    num = 100
    uvws = rng.uniform(-100, 100, (num, 3))
    start = rng.integers(0, 8, num).astype(np.int32)
    end = rng.integers(0, 16, num).astype(np.int32)
    freq0, dfreq = 1e9, 5e6
    lo, hi = uvw_bounds_all(jnp.asarray(uvws), freq0, dfreq,
                            jnp.asarray(start), jnp.asarray(end))
    exp_lo = np.full(3, np.inf)
    exp_hi = np.full(3, -np.inf)
    for i in range(num):
        if start[i] >= end[i]:
            continue
        for j in range(3):
            u0 = freq0 * uvws[i, j] / C_0
            du = dfreq * uvws[i, j] / C_0
            if uvws[i, j] >= 0:
                exp_lo[j] = min(exp_lo[j], u0 + start[i] * du)
                exp_hi[j] = max(exp_hi[j], u0 + (end[i] - 1) * du)
            else:
                exp_hi[j] = max(exp_hi[j], u0 + start[i] * du)
                exp_lo[j] = min(exp_lo[j], u0 + (end[i] - 1) * du)
    np.testing.assert_allclose(np.asarray(lo), exp_lo, rtol=1e-14)
    np.testing.assert_allclose(np.asarray(hi), exp_hi, rtol=1e-14)


# ---------------------------------------------------------------------------
# Sub-grid cut-out / add-back (wrap-around)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [(0, 0), (5, -3), (30, 30), (-33, 17)])
def test_subgrid_cut_out_matches_numpy_roll(offset):
    rng = np.random.default_rng(13)
    grid = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
    sub_size = 16
    ou, ov = offset
    got = np.asarray(subgrid_cut_out(jnp.asarray(grid), ou, ov, sub_size))
    # Oracle: roll the grid so the (offset) block lands centred, then slice.
    rolled = np.roll(np.roll(grid, -ou, axis=0), -ov, axis=1)
    lo = 64 // 2 - sub_size // 2
    expected = rolled[lo:lo + sub_size, lo:lo + sub_size]
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("offset", [(0, 0), (5, -3), (-33, 17)])
def test_subgrid_add_is_adjoint_of_cut_out(offset):
    """add uses -offset indexing, cut_out +offset
    (sdp_gridder_utils.cpp:566/619) — the w-stack driver therefore calls
    add with negated offsets (sdp_grid_wstack_wtower.cpp:687-690)."""
    rng = np.random.default_rng(17)
    sub = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    ou, ov = offset
    grid = np.asarray(subgrid_add(
        jnp.zeros((64, 64), complex), -ou, -ov, jnp.asarray(sub), 2.0))
    back = np.asarray(subgrid_cut_out(jnp.asarray(grid), ou, ov, 16))
    np.testing.assert_allclose(back, 2.0 * sub, atol=1e-15)


def test_shift_subgrids():
    stack = jnp.arange(3 * 4 * 4, dtype=jnp.float64).reshape(3, 4, 4)
    out = np.asarray(shift_subgrids(stack))
    np.testing.assert_array_equal(out[0], np.asarray(stack[1]))
    np.testing.assert_array_equal(out[1], np.asarray(stack[2]))
    np.testing.assert_array_equal(out[2], np.asarray(stack[2]))


# ---------------------------------------------------------------------------
# Array algebra
# ---------------------------------------------------------------------------

def test_accumulate_and_scale_inv():
    rng = np.random.default_rng(19)
    a = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    b = np.exp(1j * rng.standard_normal((8, 8)))
    out = np.zeros((8, 8), complex)
    got = accumulate_scaled_arrays(jnp.asarray(out), jnp.asarray(a),
                                   jnp.asarray(b), 3)
    np.testing.assert_allclose(np.asarray(got), a * b ** 3, rtol=1e-12)
    got0 = accumulate_scaled_arrays(jnp.asarray(a), jnp.asarray(a), None, 0)
    np.testing.assert_allclose(np.asarray(got0), 2 * a, rtol=1e-15)
    inv = scale_inv_array(jnp.asarray(a), jnp.asarray(b), 2)
    np.testing.assert_allclose(np.asarray(inv), a / b ** 2, rtol=1e-12)


def test_rms_diff():
    a = jnp.asarray(np.full((4, 4), 3.0))
    b = jnp.asarray(np.full((4, 4), 1.0))
    np.testing.assert_allclose(float(rms_diff(a, b)), 2.0, rtol=1e-15)


# ---------------------------------------------------------------------------
# image <-> flmn
# ---------------------------------------------------------------------------

def test_image_lmn_and_image_to_flmn():
    theta = 0.01
    image = np.zeros((8, 8))
    image[2, 3] = 1.5
    image[5, 6] = -0.5
    flux, lmn = image_to_flmn(image, theta, 0.0, 0.0)
    assert flux.shape == (2,)
    np.testing.assert_allclose(flux, [1.5, -0.5])
    l = (2 - 4) * theta / 8
    m = (3 - 4) * theta / 8
    np.testing.assert_allclose(lmn[0], [l, m, math.sqrt(
        1 - l * l - m * m) - 1], rtol=1e-14)
    all_lmn = np.asarray(image_lmn((8, 8), theta))
    assert all_lmn.shape == (64, 3)
    np.testing.assert_allclose(all_lmn[2 * 8 + 3], lmn[0], rtol=1e-14)


def test_determine_w_step():
    theta, fov = 0.02, 0.01
    w_step = determine_w_step(theta, fov, 0.0, 0.0, 0.0)
    n_min = lm_to_n(fov / 2, fov / 2, 0.0, 0.0)
    expected = 1.0 / (2 * -n_min / (fov / theta))
    np.testing.assert_allclose(w_step, expected, rtol=1e-14)


# ---------------------------------------------------------------------------
# DFT / iDFT oracles
# ---------------------------------------------------------------------------

def test_dft_matches_loop_oracle():
    rng = np.random.default_rng(23)
    num_rows, num_chan, num_src = 20, 3, 4
    uvws = rng.uniform(-50, 50, (num_rows, 3))
    flux = rng.random(num_src)
    lmn = np.column_stack([
        rng.uniform(-0.01, 0.01, num_src),
        rng.uniform(-0.01, 0.01, num_src),
        np.zeros(num_src),
    ])
    lmn[:, 2] = np.sqrt(1 - lmn[:, 0] ** 2 - lmn[:, 1] ** 2) - 1
    freq0, dfreq = 1e9, 1e7
    start = np.zeros(num_rows, np.int32)
    end = np.full(num_rows, num_chan, np.int32)
    end[3] = 0  # one empty row
    got = np.asarray(dft(
        jnp.asarray(uvws), jnp.asarray(flux), jnp.asarray(lmn),
        jnp.asarray(start), jnp.asarray(end), 2, -1, 1, 0.01, 100.0,
        freq0, dfreq, num_chan))
    expected = np.zeros((num_rows, num_chan), complex)
    du, dv, dw = 2 / 0.01, -1 / 0.01, 1 * 100.0
    for i in range(num_rows):
        if start[i] >= end[i]:
            continue
        for c in range(num_chan):
            scale = (freq0 + dfreq * c) / C_0
            u = uvws[i, 0] * scale - du
            v = uvws[i, 1] * scale - dv
            w = uvws[i, 2] * scale - dw
            for s in range(num_src):
                phase = -2 * np.pi * (
                    lmn[s, 0] * u + lmn[s, 1] * v + lmn[s, 2] * w)
                expected[i, c] += flux[s] * np.exp(1j * phase)
    np.testing.assert_allclose(got, expected, atol=1e-11)


def test_idft_is_adjoint_of_dft():
    """vdot(vis, DFT(image)) == vdot(iDFT(vis), image) — the adjointness
    test pattern from tests/grid_data/test_gridder_uvw_es_fft.py:500-529."""
    rng = np.random.default_rng(29)
    num_rows, num_chan = 30, 2
    size = 8
    theta = 0.01
    uvws = rng.uniform(-100, 100, (num_rows, 3))
    vis = rng.standard_normal((num_rows, num_chan)) \
        + 1j * rng.standard_normal((num_rows, num_chan))
    image = rng.standard_normal((size, size))
    freq0, dfreq = 1e9, 1e7
    lmn = image_lmn((size, size), theta)
    flux = jnp.asarray(image.ravel())
    predicted = dft(jnp.asarray(uvws), flux, lmn, None, None,
                    0, 0, 0, theta, 0.0, freq0, dfreq, num_chan)
    dirty = idft(jnp.asarray(uvws), jnp.asarray(vis), lmn, None, None,
                 None, 0, 0, 0, theta, 0.0, freq0, dfreq,
                 image_shape=(size, size))
    lhs = np.vdot(vis, np.asarray(predicted))
    rhs = np.vdot(np.asarray(dirty), image)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
