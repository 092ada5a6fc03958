"""Station/element beam tests with in-file numpy oracles
(reference pattern: tests/station_beam/test_station_beam.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.station_beam import (
    aperture_array,
    dipole,
    spherical_wave_harp,
)
from ska_sdp_func_jax.station_beam.element import (
    dipole_pattern,
    dipole_pattern_scalar,
)

C_0 = 299792458.0


# ---------------------------------------------------------------------------
# Aperture array
# ---------------------------------------------------------------------------

def _oracle_aperture_array(k, w, ex, ey, ez, px, py, pz, idx=None,
                           beam=None, normalise=True):
    num_e = len(ex)
    num_p = len(px)
    shape = (num_p,) if beam is None or beam.ndim == 2 else (num_p, 4)
    out = np.zeros(shape, complex)
    for p in range(num_p):
        for i in range(num_e):
            phase = k * (px[p] * ex[i] + py[p] * ey[i] + pz[p] * ez[i])
            term = w[i] * np.exp(1j * phase)
            if beam is None:
                out[p] += term
            else:
                j = idx[i] if idx is not None else i
                out[p] += term * beam[j, p]
    if normalise:
        out /= num_e
    return out


def test_aperture_array_scalar_matches_oracle():
    rng = np.random.default_rng(1)
    num_e, num_p = 16, 25
    ex, ey, ez = (rng.uniform(-10, 10, num_e) for _ in range(3))
    px, py = (rng.uniform(-0.5, 0.5, num_p) for _ in range(2))
    pz = np.sqrt(1 - px ** 2 - py ** 2)
    w = rng.standard_normal(num_e) + 1j * rng.standard_normal(num_e)
    k = 2 * np.pi / 0.21
    got = np.asarray(aperture_array(
        k, jnp.asarray(w), jnp.asarray(ex), jnp.asarray(ey),
        jnp.asarray(ez), jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz)))
    expected = _oracle_aperture_array(k, w, ex, ey, ez, px, py, pz)
    np.testing.assert_allclose(got, expected, atol=1e-12)


def test_aperture_array_with_element_beam_and_index():
    rng = np.random.default_rng(2)
    num_e, num_p, num_types = 12, 9, 3
    ex, ey, ez = (rng.uniform(-5, 5, num_e) for _ in range(3))
    px, py = (rng.uniform(-0.3, 0.3, num_p) for _ in range(2))
    pz = np.sqrt(1 - px ** 2 - py ** 2)
    w = rng.standard_normal(num_e) + 1j * rng.standard_normal(num_e)
    beam = (rng.standard_normal((num_types, num_p))
            + 1j * rng.standard_normal((num_types, num_p)))
    idx = rng.integers(0, num_types, num_e).astype(np.int32)
    k = 2.0
    got = np.asarray(aperture_array(
        k, jnp.asarray(w), jnp.asarray(ex), jnp.asarray(ey),
        jnp.asarray(ez), jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz),
        element_beam_index=jnp.asarray(idx), element_beam=jnp.asarray(beam)))
    expected = _oracle_aperture_array(k, w, ex, ey, ez, px, py, pz, idx,
                                      beam)
    np.testing.assert_allclose(got, expected, atol=1e-12)


def test_aperture_array_polarised_eval_mask():
    rng = np.random.default_rng(3)
    num_e, num_p = 8, 5
    ex, ey, ez = (rng.uniform(-5, 5, num_e) for _ in range(3))
    px, py = (rng.uniform(-0.3, 0.3, num_p) for _ in range(2))
    pz = np.sqrt(1 - px ** 2 - py ** 2)
    w = np.ones(num_e) + 0j
    beam = (rng.standard_normal((num_e, num_p, 4))
            + 1j * rng.standard_normal((num_e, num_p, 4)))
    got = np.asarray(aperture_array(
        1.0, jnp.asarray(w), jnp.asarray(ex), jnp.asarray(ey),
        jnp.asarray(ez), jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz),
        element_beam=jnp.asarray(beam), eval_y=False))
    assert got.shape == (num_p, 4)
    assert np.abs(got[:, 2:]).max() == 0.0
    expected = _oracle_aperture_array(1.0, w, ex, ey, ez, px, py, pz,
                                      None, beam)
    np.testing.assert_allclose(got[:, :2], expected[:, :2], atol=1e-12)


# ---------------------------------------------------------------------------
# Dipole
# ---------------------------------------------------------------------------

def _oracle_dipole(kl, phi, theta):
    cos_phi = np.cos(phi)
    denom = 1 + cos_phi ** 2 * (np.cos(theta) ** 2 - 1)
    temp = (np.cos(kl * cos_phi * np.sin(theta)) - np.cos(kl)) / denom
    return -cos_phi * np.cos(theta) * temp, np.sin(phi) * temp


def test_dipole_pattern_matches_oracle():
    rng = np.random.default_rng(4)
    theta = rng.uniform(0.1, 1.4, 20)
    phi = rng.uniform(0, 2 * np.pi, 20)
    freq, length = 1e8, 1.5
    e_th, e_ph = dipole_pattern(jnp.asarray(theta), jnp.asarray(phi),
                                freq, length)
    kl = length * np.pi * freq / C_0
    exp_th, exp_ph = _oracle_dipole(kl, phi, theta)
    np.testing.assert_allclose(np.asarray(e_th).real, exp_th, atol=1e-13)
    np.testing.assert_allclose(np.asarray(e_ph).real, exp_ph, atol=1e-13)


def test_dipole_strided_write():
    theta = np.array([0.3, 0.7])
    phi = np.array([0.1, 1.2])
    beam = jnp.zeros((2, 4), jnp.complex128)
    out = np.asarray(dipole(jnp.asarray(theta), jnp.asarray(phi), 1e8, 1.5,
                            4, 0, beam))
    kl = 1.5 * np.pi * 1e8 / C_0
    exp_th, exp_ph = _oracle_dipole(kl, phi, theta)
    np.testing.assert_allclose(out[:, 0].real, exp_th, atol=1e-13)
    np.testing.assert_allclose(out[:, 1].real, exp_ph, atol=1e-13)
    assert np.abs(out[:, 2:]).max() == 0


def test_dipole_scalar_is_rms_of_crossed_dipoles():
    theta = np.array([0.5])
    phi = np.array([0.8])
    amp = np.asarray(dipole_pattern_scalar(
        jnp.asarray(theta), jnp.asarray(phi), 1e8, 1.5))
    kl = 1.5 * np.pi * 1e8 / C_0
    x = _oracle_dipole(kl, phi, theta)
    y = _oracle_dipole(kl, phi + np.pi / 2, theta)
    expected = np.sqrt((x[0] ** 2 + x[1] ** 2 + y[0] ** 2 + y[1] ** 2) / 2)
    np.testing.assert_allclose(amp.real, expected, atol=1e-13)


# ---------------------------------------------------------------------------
# Spherical wave (HARP)
# ---------------------------------------------------------------------------

def _oracle_legendre2(l, m, cos_t, sin_t):
    p0 = 1.0
    if m > 0:
        fact = 1.0
        for _ in range(m):
            p0 *= -fact * sin_t
            fact += 2.0
    out0 = cos_t * (2 * m + 1) * p0
    if l == m:
        p1, out0 = out0, p0
    else:
        p1 = out0
        for i in range(m + 2, l + 2):
            out0 = p1
            p1 = ((2 * i - 1) * cos_t * out0 - (i + m - 1) * p0) / (i - m)
            p0 = out0
        out0 = p0
    if sin_t != 0:
        return out0, out0 / sin_t, (cos_t * out0 * (l + 1)
                                    - p1 * (l - m + 1)) / sin_t
    return out0, 0.0, 0.0


def _oracle_harp(theta, phi_x, phi_y, l_max, alpha):
    num = len(theta)
    pattern = np.zeros((num, 4), complex)
    for i in range(num):
        th = max(theta[i], 1e-5)
        sin_t, cos_t = np.sin(th), np.cos(th)
        acc = dict(x_theta=0j, x_phi=0j, y_theta=0j, y_phi=0j)

        def harp(m, a_te, a_tm, ct, cp, cos_p, sin_p, pds, dpms):
            qq = complex(-cos_p * dpms, -sin_p * dpms)
            dd = complex(-sin_p * pds * m, cos_p * pds * m)
            return ct + dd * a_tm + qq * a_te, cp + qq * a_tm - dd * a_te

        for l in range(1, l_max + 1):
            ind0 = l * l - 1 + l
            f_ = (2 * l + 1) / (4 * np.pi * l * (l + 1))
            for am in range(l, -1, -1):
                _, pds, dpms = _oracle_legendre2(l, am, cos_t, sin_t)
                if am == 0:
                    cos_p, sin_p = math.sqrt(f_), 0.0
                    acc["x_theta"], acc["x_phi"] = harp(
                        0, alpha[4 * ind0], alpha[4 * ind0 + 1],
                        acc["x_theta"], acc["x_phi"], cos_p, sin_p, pds,
                        dpms)
                    acc["y_theta"], acc["y_phi"] = harp(
                        0, alpha[4 * ind0 + 2], alpha[4 * ind0 + 3],
                        acc["y_theta"], acc["y_phi"], cos_p, sin_p, pds,
                        dpms)
                else:
                    nf = math.sqrt(f_ * math.factorial(l - am)
                                   / math.factorial(l + am))
                    ind_m, ind_p = 4 * (ind0 - am), 4 * (ind0 + am)
                    p = -am * phi_x[i]
                    sin_p, cos_p = np.sin(p) * nf, np.cos(p) * nf
                    acc["x_theta"], acc["x_phi"] = harp(
                        -am, alpha[ind_m], alpha[ind_m + 1],
                        acc["x_theta"], acc["x_phi"], cos_p, sin_p, pds,
                        dpms)
                    acc["x_theta"], acc["x_phi"] = harp(
                        am, alpha[ind_p], alpha[ind_p + 1],
                        acc["x_theta"], acc["x_phi"], cos_p, -sin_p, pds,
                        dpms)
                    p = -am * phi_y[i]
                    sin_p, cos_p = np.sin(p) * nf, np.cos(p) * nf
                    acc["y_theta"], acc["y_phi"] = harp(
                        -am, alpha[ind_m + 2], alpha[ind_m + 3],
                        acc["y_theta"], acc["y_phi"], cos_p, sin_p, pds,
                        dpms)
                    acc["y_theta"], acc["y_phi"] = harp(
                        am, alpha[ind_p + 2], alpha[ind_p + 3],
                        acc["y_theta"], acc["y_phi"], cos_p, -sin_p, pds,
                        dpms)
        pattern[i] = [acc["x_phi"], acc["x_theta"],
                      acc["y_phi"], acc["y_theta"]]
    return pattern


@pytest.mark.parametrize("l_max", [1, 3])
def test_spherical_wave_harp_matches_oracle(l_max):
    rng = np.random.default_rng(5)
    num = 12
    theta = rng.uniform(0.0, 1.5, num)
    phi_x = rng.uniform(0, 2 * np.pi, num)
    phi_y = phi_x + np.pi / 2
    num_coeffs = 4 * ((l_max + 1) ** 2 - 1)
    alpha = (rng.standard_normal(num_coeffs)
             + 1j * rng.standard_normal(num_coeffs))
    got = np.asarray(spherical_wave_harp(
        jnp.asarray(theta), jnp.asarray(phi_x), jnp.asarray(phi_y),
        l_max, jnp.asarray(alpha)))
    expected = _oracle_harp(theta, phi_x, phi_y, l_max, alpha)
    np.testing.assert_allclose(got, expected, atol=1e-11)


def test_spherical_wave_harp_nan_propagation():
    theta = np.array([0.5, 0.7])
    phi_x = np.array([np.nan, 0.3])
    phi_y = np.array([0.2, 0.4])
    alpha = np.ones(4 * 3, complex)
    got = np.asarray(spherical_wave_harp(
        jnp.asarray(theta), jnp.asarray(phi_x), jnp.asarray(phi_y), 1,
        jnp.asarray(alpha)))
    assert np.isnan(got[0]).all()
    assert np.isfinite(got[1]).all()
