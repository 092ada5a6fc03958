"""Visibility-function tests with in-file numpy oracles
(reference pattern: tests/visibility/test_dft.py, test_weighting.py,
test_phase_rotate.py, test_flagger.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.utility import SkyCoord
from ska_sdp_func_jax.visibility import (
    dft_point_v00,
    dft_point_v01,
    phase_rotate_uvw,
    phase_rotate_vis,
)
from ska_sdp_func_jax.visibility.flagger import flagger_dynamic_threshold
from ska_sdp_func_jax.visibility.weighting import (
    briggs_weights,
    get_uv_range,
    uniform_weights,
)

C_0 = 299792458.0


# ---------------------------------------------------------------------------
# DFT point-source predict
# ---------------------------------------------------------------------------

def _oracle_dft_v01(directions, fluxes, uvw, f0, df):
    T, B, _ = uvw.shape
    S, C, P = fluxes.shape
    vis = np.zeros((T, B, C, P), complex)
    for t in range(T):
        for b in range(B):
            for c in range(C):
                inv_wave = (f0 + c * df) / C_0
                for s in range(S):
                    phase = -2 * np.pi * inv_wave * np.dot(
                        directions[s], uvw[t, b])
                    vis[t, b, c] += fluxes[s, c] * np.exp(1j * phase)
    return vis


@pytest.mark.parametrize("num_pols", [1, 4])
def test_dft_point_v01_matches_oracle(num_pols):
    rng = np.random.default_rng(1)
    T, B, C, S = 3, 10, 2, 5
    uvw = rng.uniform(-100, 100, (T, B, 3))
    directions = rng.uniform(-0.01, 0.01, (S, 3))
    fluxes = (rng.standard_normal((S, C, num_pols))
              + 1j * rng.standard_normal((S, C, num_pols)))
    f0, df = 1e9, 1e7
    got = np.asarray(dft_point_v01(
        jnp.asarray(directions), jnp.asarray(fluxes), jnp.asarray(uvw),
        f0, df))
    expected = _oracle_dft_v01(directions, fluxes, uvw, f0, df)
    np.testing.assert_allclose(got, expected, atol=1e-11)


def test_dft_point_v00_matches_v01_with_scaled_uvw():
    rng = np.random.default_rng(2)
    T, B, C, S, P = 2, 6, 3, 4, 1
    uvw = rng.uniform(-100, 100, (T, B, 3))
    directions = rng.uniform(-0.01, 0.01, (S, 3))
    fluxes = (rng.standard_normal((S, C, P))
              + 1j * rng.standard_normal((S, C, P)))
    f0, df = 1.2e9, 5e6
    inv_wave = (f0 + df * np.arange(C)) / C_0
    uvw_lambda = uvw[:, :, None, :] * inv_wave[None, None, :, None]
    v00 = np.asarray(dft_point_v00(
        jnp.asarray(directions), jnp.asarray(fluxes),
        jnp.asarray(uvw_lambda)))
    v01 = np.asarray(dft_point_v01(
        jnp.asarray(directions), jnp.asarray(fluxes), jnp.asarray(uvw),
        f0, df))
    np.testing.assert_allclose(v00, v01, atol=1e-12)


# ---------------------------------------------------------------------------
# Phase rotation
# ---------------------------------------------------------------------------

def test_phase_rotate_uvw_preserves_norm_and_matches_matrix():
    rng = np.random.default_rng(3)
    uvw = rng.uniform(-1000, 1000, (4, 20, 3))
    orig = SkyCoord("icrs", np.radians(20.0), np.radians(-30.0))
    new = SkyCoord("icrs", np.radians(20.5), np.radians(-29.5))
    out = np.asarray(phase_rotate_uvw(orig, new, jnp.asarray(uvw)))
    # norms preserved (rotation)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1),
                               np.linalg.norm(uvw, axis=-1), rtol=1e-12)
    # explicit matrix oracle (sdp_phase_rotate.cpp:120-135)
    d_a = -(new.ra - orig.ra)
    d_d = new.dec - orig.dec
    mat = np.array([
        [np.cos(d_a), 0, np.sin(d_a)],
        [np.sin(d_a) * np.sin(d_d), np.cos(d_d),
         -np.cos(d_a) * np.sin(d_d)],
        [-np.sin(d_a) * np.cos(d_d), np.sin(d_d),
         np.cos(d_a) * np.cos(d_d)],
    ])
    np.testing.assert_allclose(out, uvw @ mat.T, atol=1e-10)


def test_phase_rotate_vis_roundtrip_point_source():
    """Rotating visibilities of a source to a new centre must equal
    predicting directly at the new centre (self-consistency oracle)."""
    rng = np.random.default_rng(4)
    T, B, C, P = 2, 15, 2, 1
    uvw = rng.uniform(-500, 500, (T, B, 3))
    orig = SkyCoord("icrs", 0.0, np.radians(-40.0))
    new = SkyCoord("icrs", np.radians(0.3), np.radians(-40.2))
    f0, df = 1e9, 1e7
    vis = (rng.standard_normal((T, B, C, P))
           + 1j * rng.standard_normal((T, B, C, P)))
    rotated = np.asarray(phase_rotate_vis(
        orig, new, f0, df, jnp.asarray(uvw), jnp.asarray(vis)))
    # oracle: multiply by exp(2 pi i f/c (u dl + v dm + w dn))
    d_a = -(new.ra - orig.ra)
    l1 = np.cos(new.dec) * -np.sin(d_a)
    m1 = (np.cos(orig.dec) * np.sin(new.dec)
          - np.sin(orig.dec) * np.cos(new.dec) * np.cos(d_a))
    n1 = (np.sin(orig.dec) * np.sin(new.dec)
          + np.cos(orig.dec) * np.cos(new.dec) * np.cos(d_a))
    dl, dm, dn = -l1, -m1, 1 - n1
    expected = np.zeros_like(vis)
    for c in range(C):
        inv_wave = (f0 + c * df) / C_0
        phase = 2 * np.pi * inv_wave * (
            uvw[..., 0] * dl + uvw[..., 1] * dm + uvw[..., 2] * dn)
        expected[:, :, c, 0] = vis[:, :, c, 0] * np.exp(1j * phase)
    np.testing.assert_allclose(rotated, expected, atol=1e-12)


# ---------------------------------------------------------------------------
# Weighting
# ---------------------------------------------------------------------------

def _oracle_weights(uvw, freq, max_abs_uv, grid_size, in_w, robust=None):
    T, B, _ = uvw.shape
    C = len(freq)
    P = in_w.shape[3]
    half = grid_size // 2
    grid = np.zeros((grid_size, grid_size, P))
    for t in range(T):
        for b in range(B):
            for c in range(C):
                iw = freq[c] / C_0
                iu = int(np.floor(uvw[t, b, 0] * iw / max_abs_uv * half)
                         ) + half
                iv = int(np.floor(uvw[t, b, 1] * iw / max_abs_uv * half)
                         ) + half
                if iu >= grid_size or iv >= grid_size or iu < 0 or iv < 0:
                    continue
                grid[iu, iv] += in_w[t, b, c]
    out = np.zeros_like(in_w)
    if robust is not None:
        sw = sw2 = 0.0
        for t in range(T):
            for b in range(B):
                for c in range(C):
                    iw = freq[c] / C_0
                    iu = int(np.floor(uvw[t, b, 0] * iw / max_abs_uv * half)
                             ) + half
                    iv = int(np.floor(uvw[t, b, 1] * iw / max_abs_uv * half)
                             ) + half
                    if iu >= grid_size or iv >= grid_size or iu < 0 or iv < 0:
                        continue
                    for p in range(P):
                        sw += grid[iu, iv, p]
                        sw2 += grid[iu, iv, p] ** 2
        robustness = (5.0 * 10 ** (-robust)) ** 2 / (sw2 / sw)
    for t in range(T):
        for b in range(B):
            for c in range(C):
                iw = freq[c] / C_0
                iu = int(np.floor(uvw[t, b, 0] * iw / max_abs_uv * half)
                         ) + half
                iv = int(np.floor(uvw[t, b, 1] * iw / max_abs_uv * half)
                         ) + half
                if iu >= grid_size or iv >= grid_size or iu < 0 or iv < 0:
                    continue
                for p in range(P):
                    if robust is None:
                        out[t, b, c, p] = 1.0 / grid[iu, iv, p]
                    else:
                        out[t, b, c, p] = in_w[t, b, c, p] / (
                            1 + robustness * grid[iu, iv, p])
    return grid, out


@pytest.fixture()
def weighting_data():
    rng = np.random.default_rng(7)
    T, B, C, P = 4, 30, 3, 1
    uvw = rng.uniform(-800, 800, (T, B, 3))
    freq = np.array([1.0e9, 1.1e9, 1.2e9])
    in_w = np.ones((T, B, C, P))
    max_abs_uv = get_uv_range(jnp.asarray(uvw), jnp.asarray(freq))
    return uvw, freq, in_w, max_abs_uv


def test_uniform_weights_matches_oracle(weighting_data):
    uvw, freq, in_w, max_abs_uv = weighting_data
    grid_size = 32
    grid, out = uniform_weights(jnp.asarray(uvw), jnp.asarray(freq),
                                max_abs_uv, jnp.asarray(in_w), grid_size)
    grid_ref, out_ref = _oracle_weights(uvw, freq, max_abs_uv, grid_size,
                                        in_w)
    np.testing.assert_allclose(np.asarray(grid), grid_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out), out_ref, atol=1e-12)


def test_briggs_weights_matches_oracle(weighting_data):
    uvw, freq, in_w, max_abs_uv = weighting_data
    grid_size = 32
    grid, out = briggs_weights(jnp.asarray(uvw), jnp.asarray(freq),
                               max_abs_uv, 0.5, jnp.asarray(in_w), grid_size)
    grid_ref, out_ref = _oracle_weights(uvw, freq, max_abs_uv, grid_size,
                                        in_w, robust=0.5)
    np.testing.assert_allclose(np.asarray(grid), grid_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out), out_ref, atol=1e-12)


def test_briggs_weights_large_n_f32_accurate():
    """f32 weights over ~1e6 visibilities: the robustness sums
    accumulate in f64, so the result tracks the f64 oracle to f32
    rounding (a sequential f32 sum would lose ~3 digits here)."""
    rng = np.random.default_rng(11)
    T, B, C, P = 100, 100, 100, 1
    uvw = rng.uniform(-800, 800, (T, B, 3))
    freq = np.linspace(1.0e9, 1.2e9, C)
    in_w = rng.uniform(0.5, 2.0, (T, B, C, P))
    max_abs_uv = float(get_uv_range(jnp.asarray(uvw), jnp.asarray(freq)))
    # f64 uvw in both runs: cell assignment must be identical so the
    # comparison isolates accumulation accuracy.
    _, out32 = briggs_weights(jnp.asarray(uvw), jnp.asarray(freq),
                              max_abs_uv, 0.5,
                              jnp.asarray(in_w, jnp.float32), 64)
    _, out64 = briggs_weights(jnp.asarray(uvw), jnp.asarray(freq),
                              max_abs_uv, 0.5, jnp.asarray(in_w), 64)
    np.testing.assert_allclose(np.asarray(out32), np.asarray(out64),
                               rtol=3e-5)


def test_get_uv_range():
    uvw = np.zeros((2, 3, 3))
    uvw[1, 2, 0] = -123.0
    freq = np.array([1e9, 2e9])
    expected = 123.0 * 2e9 / C_0
    np.testing.assert_allclose(
        get_uv_range(jnp.asarray(uvw), jnp.asarray(freq)), expected)


# ---------------------------------------------------------------------------
# FluctuFlagger
# ---------------------------------------------------------------------------

def _oracle_flagger(vis, alpha, thr_mag, thr_var, thr_bb, step, window,
                    hist_window):
    """Direct numpy replication of sdp_flagger.cpp:125-350."""
    T, B, C, P = vis.shape
    flags = np.zeros((T, B, C, P), np.int32)
    n = C // step
    mid = int(round(0.5 * n))

    def med(arr):
        s = np.sort(arr)
        return s[min(mid, len(s) - 1)] if len(arr) == n else \
            s[min(int(round(0.5 * len(arr))), len(s) - 1)]

    def zsc(median, mad, val):
        if mad == 0 and val == median:
            return 0.0
        if mad == 0:
            return 10000000.0
        return 0.6795 * (val - median) / mad

    for b in range(B):
        for p in range(P):
            transit = np.zeros(C)
            med_hist = np.zeros(T)
            for t in range(T):
                mags = np.abs(vis[t, b, :, p])
                samples = np.sort(mags[::step][:n])
                median = samples[mid]
                mad = np.sort(np.abs(samples - median))[mid]
                med_hist[t] = median
                mw = min(t + 1, hist_window)
                medarr = np.sort(med_hist[t - mw + 1:t + 1])
                mid_w = min(int(round(0.5 * mw)), mw - 1)
                medmed = medarr[mid_w]
                medmeddev = np.sort(np.abs(medarr - medmed))[mid_w]
                z_med = zsc(medmed, medmeddev, median)
                situation = abs(z_med) > thr_bb and t != 0
                for c in range(C):
                    z = zsc(median, mad, mags[c])
                    if abs(z) > thr_mag or situation:
                        flags[t, b, c, p] = 1
                        for w in range(window):
                            if c - w - 1 > 0:
                                flags[t, b, c - w - 1, p] = 1
                            if c + w + 1 < C:
                                flags[t, b, c + w + 1, p] = 1
                if t > 0:
                    prev = np.abs(vis[t - 1, b, :, p])
                    rate = np.abs(prev - mags)
                    if t == 1:
                        transit = rate.copy()
                    else:
                        transit = alpha * rate + (1 - alpha) * transit
                    tsamp = np.sort(np.abs(transit[::step][:n]))
                    medvar = tsamp[mid]
                    medvardev = np.sort(np.abs(tsamp - median))[mid]
                    for c in range(C):
                        z = zsc(medvar, medvardev, abs(transit[c]))
                        if abs(z) > thr_var:
                            flags[t, b, c, p] = 1
                            flags[t - 1, b, c, p] = 1
                            for w in range(window):
                                if c - w - 1 > 0:
                                    flags[t, b, c - w - 1, p] = 1
                                    flags[t - 1, b, c - w - 1, p] = 1
                                if c + w + 1 < C:
                                    flags[t, b, c + w + 1, p] = 1
                                    flags[t - 1, b, c + w + 1, p] = 1
    return flags


@pytest.mark.parametrize("window", [0, 2])
def test_flagger_matches_oracle(window):
    rng = np.random.default_rng(11)
    T, B, C, P = 8, 3, 32, 2
    vis = (rng.standard_normal((T, B, C, P))
           + 1j * rng.standard_normal((T, B, C, P))).astype(complex)
    # inject RFI: a strong spike and a broadband burst
    vis[3, 1, 10, 0] += 50.0
    vis[5, 0, :, 1] += 30.0
    args = dict(alpha=0.4, threshold_magnitudes=3.5,
                threshold_variations=3.5, threshold_broadband=3.5,
                sampling_step=2, window=window, window_median_history=4)
    got = np.asarray(flagger_dynamic_threshold(jnp.asarray(vis), **args))
    expected = _oracle_flagger(vis, 0.4, 3.5, 3.5, 3.5, 2, window, 4)
    assert expected.sum() > 0  # scenario sanity: something got flagged
    np.testing.assert_array_equal(got, expected)


def test_flagger_flags_injected_spike():
    rng = np.random.default_rng(13)
    T, B, C, P = 6, 2, 16, 1
    vis = (rng.standard_normal((T, B, C, P)) * 0.1
           + 1j * rng.standard_normal((T, B, C, P)) * 0.1 + 1.0)
    vis[2, 0, 5, 0] = 100.0
    flags = np.asarray(flagger_dynamic_threshold(jnp.asarray(vis)))
    assert flags[2, 0, 5, 0] == 1
