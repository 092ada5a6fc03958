"""CLEAN tests: in-file numpy oracles, data generated with the framework's
own DFT imaging (the reference pattern: tests/clean/test_hogbom_clean.py
generates data with the library itself, then checks C vs in-file numpy
CLEAN to decimal=6 for f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from ska_sdp_func_jax.clean import create_cbeam, hogbom_clean, ms_clean_cornwell
from ska_sdp_func_jax.numeric_functions import fft_convolution
from ska_sdp_func_jax.grid_data import dft, idft, image_lmn, image_to_flmn

C_0 = 299792458.0


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------

def oracle_cbeam(details, size):
    sx, sy = details[0], details[1]
    theta = np.pi / 180.0 * details[2]
    a = np.cos(theta) ** 2 / (2 * sx ** 2) + np.sin(theta) ** 2 / (2 * sy ** 2)
    b = np.sin(2 * theta) / (4 * sx ** 2) - np.sin(2 * theta) / (4 * sy ** 2)
    c = np.sin(theta) ** 2 / (2 * sx ** 2) + np.cos(theta) ** 2 / (2 * sy ** 2)
    x0 = size // 2
    out = np.zeros((size, size))
    for x in range(size):
        for y in range(size):
            out[x, y] = np.exp(-(a * (x - x0) ** 2
                                 + 2 * b * (x - x0) * (y - x0)
                                 + c * (y - x0) ** 2))
    return out


def oracle_hogbom(dirty, psf, details, gain, threshold, cycle_limit):
    size = dirty.shape[0]
    residual = dirty.copy()
    model = np.zeros_like(dirty)
    for _ in range(cycle_limit):
        idx = np.argmax(residual)
        x, y = idx // size, idx % size
        peak = residual[x, y]
        if peak < threshold:
            break
        model[x, y] += gain * peak
        residual -= gain * peak * psf[size - x:2 * size - x,
                                      size - y:2 * size - y]
    cbeam = oracle_cbeam(details, int(details[3]))
    sky = scipy.signal.convolve(model, cbeam, mode="same") + residual
    return model, residual, sky


def oracle_ms_clean(dirty, psf, details, scales, gain, threshold,
                    cycle_limit):
    size = dirty.shape[0]
    psf_dim = psf.shape[0]
    num_scales = len(scales)
    # scale kernels
    kerns = np.zeros((num_scales, psf_dim, psf_dim))
    centre = psf_dim // 2
    xs = np.arange(psf_dim) - centre
    d2 = xs[:, None] ** 2 + xs[None, :] ** 2
    for i, s in enumerate(scales):
        if s == 0:
            kerns[i, centre, centre] = 1.0
        else:
            sig = 3.0 / 16.0 * s
            kerns[i] = np.exp(-d2 / (2 * sig * sig)) / (np.pi * 2 * sig * sig)
    scaled_psf = np.zeros((num_scales, num_scales, psf_dim, psf_dim))
    for s in range(num_scales):
        once = scipy.signal.convolve(psf, kerns[s], mode="same")
        for p in range(num_scales):
            scaled_psf[s, p] = scipy.signal.convolve(once, kerns[p],
                                                     mode="same")
    coupling = scaled_psf.reshape(num_scales, num_scales, -1).max(axis=-1)
    resid = np.stack([scipy.signal.convolve(dirty, kerns[s], mode="same")
                      for s in range(num_scales)])
    model = np.zeros_like(dirty)
    for _ in range(cycle_limit):
        peaks = np.zeros(num_scales)
        idxs = np.zeros(num_scales, int)
        for i in range(num_scales):
            flat = resid[i].ravel()
            j = np.argmax(flat)
            if flat[j] > 0:
                peaks[i] = flat[j]
                idxs[i] = j
        biased = peaks / np.diagonal(coupling)
        mscale = int(np.argmax(biased))
        if peaks[mscale] < threshold:
            break
        mb = biased[mscale]
        x, y = idxs[mscale] // size, idxs[mscale] % size
        model += gain * mb * kerns[mscale][size - x:2 * size - x,
                                           size - y:2 * size - y]
        for s in range(num_scales):
            resid[s] -= gain * mb * scaled_psf[s, mscale][
                size - x:2 * size - x, size - y:2 * size - y]
    cbeam = oracle_cbeam(details, psf_dim)
    sky = scipy.signal.convolve(model, cbeam, mode="same") + resid[0]
    return model, resid[0], sky


# ---------------------------------------------------------------------------
# data generation (with the framework itself)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clean_data():
    rng = np.random.default_rng(123)
    size = 64
    theta = 0.002
    freq0, dfreq = C_0, C_0 / 100
    num_rows, num_chan = 300, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([7000.0, 7000.0, 0.0])
    # sky: a few point sources
    sky = np.zeros((size, size))
    for _ in range(6):
        sky[rng.integers(8, size - 8), rng.integers(8, size - 8)] = \
            rng.uniform(0.3, 1.0)
    flux, lmn = image_to_flmn(sky, theta)
    vis = dft(jnp.asarray(uvw), jnp.asarray(flux), jnp.asarray(lmn),
              None, None, 0, 0, 0, theta, 0.0, freq0, dfreq, num_chan)
    # dirty image (normalised by vis count)
    nvis = num_rows * num_chan
    lmn_img = image_lmn((size, size), theta)
    dirty = np.asarray(idft(jnp.asarray(uvw), vis, lmn_img, None, None,
                            None, 0, 0, 0, theta, 0.0, freq0, dfreq,
                            image_shape=(size, size))).real / nvis
    # psf at twice the size
    lmn_psf = image_lmn((2 * size, 2 * size), 2 * theta)
    unit_vis = jnp.ones_like(vis)
    psf = np.asarray(idft(jnp.asarray(uvw), unit_vis, lmn_psf, None, None,
                          None, 0, 0, 0, 2 * theta, 0.0, freq0, dfreq,
                          image_shape=(2 * size, 2 * size))).real / nvis
    return dict(dirty=dirty, psf=psf, sky=sky)


CBEAM = np.array([2.0, 2.0, 1.0, 128.0])


def test_create_cbeam_matches_oracle():
    got = np.asarray(create_cbeam(jnp.asarray(CBEAM), 128))
    expected = oracle_cbeam(CBEAM, 128)
    np.testing.assert_allclose(got, expected, atol=1e-13)


def test_fft_convolution_matches_scipy():
    rng = np.random.default_rng(5)
    for n1, n2 in [(64, 128), (64, 64), (32, 16)]:
        a = rng.standard_normal((n1, n1))
        b = rng.standard_normal((n2, n2))
        got = np.asarray(fft_convolution(jnp.asarray(a), jnp.asarray(b)))
        expected = scipy.signal.convolve(a, b, mode="same")
        np.testing.assert_allclose(got.real, expected, atol=1e-11)
        assert np.abs(got.imag).max() < 1e-11


def test_hogbom_clean_matches_oracle(clean_data):
    dirty, psf = clean_data["dirty"], clean_data["psf"]
    gain, threshold, limit = 0.1, 1e-3, 2000
    model, residual, sky = hogbom_clean(
        jnp.asarray(dirty), jnp.asarray(psf), CBEAM, gain, threshold, limit)
    model_ref, residual_ref, sky_ref = oracle_hogbom(
        dirty, psf, CBEAM, gain, threshold, limit)
    assert np.count_nonzero(model_ref) > 3  # actually cleaned something
    np.testing.assert_array_almost_equal(np.asarray(model), model_ref,
                                         decimal=6)
    np.testing.assert_array_almost_equal(np.asarray(residual), residual_ref,
                                         decimal=6)
    np.testing.assert_array_almost_equal(np.asarray(sky), sky_ref, decimal=6)


def test_hogbom_clean_threshold_stops_loop(clean_data):
    dirty, psf = clean_data["dirty"], clean_data["psf"]
    # Huge threshold: no cleaning at all -> model 0, residual == dirty.
    model, residual, _ = hogbom_clean(
        jnp.asarray(dirty), jnp.asarray(psf), CBEAM, 0.1, 1e9, 100)
    assert np.abs(np.asarray(model)).max() == 0.0
    np.testing.assert_array_equal(np.asarray(residual), dirty)


def test_hogbom_clean_float32(clean_data):
    dirty, psf = clean_data["dirty"], clean_data["psf"]
    model, residual, sky = hogbom_clean(
        jnp.asarray(dirty, jnp.float32), jnp.asarray(psf, jnp.float32),
        CBEAM, 0.1, 1e-3, 500)
    model_ref, residual_ref, sky_ref = oracle_hogbom(
        dirty, psf, CBEAM, 0.1, 1e-3, 500)
    np.testing.assert_array_almost_equal(np.asarray(model), model_ref,
                                         decimal=4)
    np.testing.assert_array_almost_equal(np.asarray(sky), sky_ref, decimal=4)


def test_ms_clean_cornwell_matches_oracle(clean_data):
    dirty, psf = clean_data["dirty"], clean_data["psf"]
    scales = [0, 2, 4]
    gain, threshold, limit = 0.1, 1e-3, 300
    model, residual, sky = ms_clean_cornwell(
        jnp.asarray(dirty), jnp.asarray(psf), CBEAM, scales, gain,
        threshold, limit)
    model_ref, residual_ref, sky_ref = oracle_ms_clean(
        dirty, psf, CBEAM, scales, gain, threshold, limit)
    assert np.abs(model_ref).max() > 0
    np.testing.assert_array_almost_equal(np.asarray(model), model_ref,
                                         decimal=6)
    np.testing.assert_array_almost_equal(np.asarray(residual), residual_ref,
                                         decimal=6)
    np.testing.assert_array_almost_equal(np.asarray(sky), sky_ref, decimal=6)


def test_msclean_scale_bias_fixes_point_source_flux():
    """Cornwell 2008 small-scale selection bias: for a point source with
    large scales available, the biased minor cycle attributes flux to
    scale 0 instead of smearing it over the largest scale (ROADMAP
    round-1 item; the reference-faithful ms_clean_cornwell keeps the
    unbiased selection)."""
    from ska_sdp_func_jax.clean.hogbom import create_cbeam
    from ska_sdp_func_jax.pipeline.major_cycle import _make_msclean_minor

    size = 128
    psf = np.asarray(create_cbeam(
        jnp.asarray([3.0, 3.0, 0.0, 2 * size], jnp.float64), 2 * size))
    psf = psf / psf.max()
    x0, y0 = 70, 58
    dirty = psf[size - x0:2 * size - x0, size - y0:2 * size - y0].copy()

    results = {}
    for bias in (0.0, 0.6):
        minor = _make_msclean_minor(jnp.asarray(psf), (0, 8, 32), 0.1,
                                    200, bias)
        model, resid = minor(jnp.asarray(dirty), jnp.asarray(0.05))
        m = np.asarray(model)
        results[bias] = (m[x0, y0], m.sum(),
                         float(np.abs(np.asarray(resid)).max()))

    # Biased run: flux concentrated at the point, total near truth (1).
    assert results[0.6][0] > 2 * results[0.0][0]
    assert abs(results[0.6][1] - 1.0) < abs(results[0.0][1] - 1.0)
    assert results[0.6][2] < results[0.0][2]
