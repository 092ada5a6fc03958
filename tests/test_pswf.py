"""PSWF tests (oracle: scipy.special.pro_ang1, as in the reference's
tests/grid_data/test_gridder_wtower_uvw.py:214-220)."""

import numpy as np
import pytest
import scipy.special

from ska_sdp_func_jax.fourier_transforms import (
    Pswf,
    generate_pswf,
    pswf_coefficients,
    pswf_evaluate,
)


def _scipy_pswf(support, size):
    x = np.arange(-(size // 2), size - size // 2) / size * 2
    vals = scipy.special.pro_ang1(0, 0, np.pi * support / 2, x)[0]
    return np.nan_to_num(vals)


@pytest.mark.parametrize("support", [5, 8, 10])
@pytest.mark.parametrize("size", [8, 10, 63, 256])
def test_generate_pswf_matches_scipy(support, size):
    c = support * np.pi / 2
    mine = generate_pswf(0, c, size)
    ref = _scipy_pswf(support, size)
    if size % 2 == 0:
        ref[0] = 0.0  # x = -1 sample is zeroed (sdp_pswf.cpp:584)
    np.testing.assert_allclose(mine, ref, atol=1e-13)


def test_generate_pswf_end_correction():
    out = generate_pswf(0, 5 * np.pi / 2, 10, end_correction=True)
    assert out[0] == 1e-15


def test_pswf_peak_is_at_centre():
    out = generate_pswf(0, 4 * np.pi / 2, 64)
    assert np.argmax(out) == 32
    # S_00(c, 0) = 1 under the Flammer normalisation.
    np.testing.assert_allclose(out[32], 1.0, atol=1e-12)


@pytest.mark.parametrize("support", [4, 8, 10, 14])
def test_device_legendre_path_matches_scipy(support):
    """The clean-room jittable Legendre expansion must agree with specfun
    to ~1e-10 absolute (plenty below kernel error budgets)."""
    c = support * np.pi / 2
    coeffs = pswf_coefficients(c)
    x = np.linspace(-0.999, 0.999, 101)
    mine = np.asarray(pswf_evaluate(x, coeffs))
    ref = scipy.special.pro_ang1(0, 0, c, x)[0]
    np.testing.assert_allclose(mine, ref, atol=5e-10)


def test_pswf_evaluate_outside_domain_is_zero():
    coeffs = pswf_coefficients(4 * np.pi / 2)
    out = np.asarray(pswf_evaluate(np.array([-1.0, 1.0, 2.0]), coeffs))
    np.testing.assert_array_equal(out, 0.0)


def test_pswf_plan_caches_values():
    plan = Pswf(0, 5 * np.pi / 2)
    v1 = plan.values(64)
    v2 = plan.values(64)
    assert v1 is v2
    np.testing.assert_allclose(
        plan.evaluate(0.5),
        scipy.special.pro_ang1(0, 0, plan.c, 0.5)[0],
        atol=1e-14,
    )
