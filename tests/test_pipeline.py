"""Major-cycle imaging solver tests.

Generates visibilities from known point sources with the exact DFT (the
reference's oracle generator pattern, tests/clean/test_hogbom_clean.py:
18-140), runs the solver, and checks source recovery and residual decay —
single-chip and on the 8-device mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.grid_data import dft, image_to_flmn
from ska_sdp_func_jax.parallel import make_mesh, plan_wstack
from ska_sdp_func_jax.pipeline import dirty_and_psf, major_cycle_imager

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
    rng = np.random.default_rng(17)
    num_rows, num_chan = 300, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * IMAGE_SIZE / 2 / PARAMS["theta"]
    uvw[:, 2] *= 1.5 * PARAMS["w_step"] * PARAMS["w_tower_height"] / 2
    freq0, dfreq = C_0, C_0 / 100
    image = np.zeros((IMAGE_SIZE, IMAGE_SIZE))
    image[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    image[IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15] = 0.4
    # Exact visibilities from the point sources.
    flux, lmn = image_to_flmn(jnp.asarray(image), PARAMS["theta"], 0.0, 0.0)
    vis = dft(jnp.asarray(uvw), jnp.asarray(flux, complex),
              jnp.asarray(lmn), freq0_hz=freq0, dfreq_hz=dfreq,
              num_chan=num_chan)
    plan = plan_wstack(uvw, freq0, dfreq, num_chan, IMAGE_SIZE, **PARAMS)
    return dict(uvw=uvw, vis=np.asarray(vis), freq0=freq0, dfreq=dfreq,
                image=image, plan=plan)


@pytest.fixture(scope="module")
def scenario_packed():
    """Packed-compatible geometry (subgrid 128) with exact DFT vis."""
    size = 256
    params = dict(PARAMS, subgrid_size=128, w_step=100.0)
    rng = np.random.default_rng(23)
    num_rows, num_chan = 250, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * size / 2 / params["theta"]
    uvw[:, 2] *= 1.2 * params["w_step"] * params["w_tower_height"] / 2
    freq0, dfreq = C_0, C_0 / 100
    image = np.zeros((size, size))
    image[size // 2 + 12, size // 2 - 9] = 1.0
    flux, lmn = image_to_flmn(jnp.asarray(image), params["theta"],
                              0.0, 0.0)
    vis = dft(jnp.asarray(uvw), jnp.asarray(flux, complex),
              jnp.asarray(lmn), freq0_hz=freq0, dfreq_hz=dfreq,
              num_chan=num_chan)
    plan = plan_wstack(uvw, freq0, dfreq, num_chan, size, **params)
    return dict(uvw=uvw, vis=np.asarray(vis).astype(np.complex64),
                plan=plan)


@pytest.mark.slow
def test_dirty_and_psf(scenario):
    s = scenario
    dirty, psf = dirty_and_psf(s["plan"], jnp.asarray(s["vis"]),
                               jnp.asarray(s["uvw"]))
    assert dirty.shape == (IMAGE_SIZE, IMAGE_SIZE)
    assert psf.shape == (2 * IMAGE_SIZE, 2 * IMAGE_SIZE)
    # PSF peak is normalised to 1 at the centre.
    np.testing.assert_allclose(float(psf[IMAGE_SIZE, IMAGE_SIZE]), 1.0,
                               rtol=1e-10)
    # With the border (CLEAN window) masked, the PSF peak is the centre.
    assert float(jnp.max(psf)) <= 1.0 + 1e-10
    assert float(psf[0, 0]) == 0.0
    # Dirty image peaks near the brightest source.
    iy, ix = np.unravel_index(np.asarray(dirty).argmax(), dirty.shape)
    assert abs(iy - (IMAGE_SIZE // 2 + 12)) <= 1
    assert abs(ix - (IMAGE_SIZE // 2 - 9)) <= 1


@pytest.mark.slow
def test_major_cycle_recovers_sources(scenario):
    s = scenario
    result = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
        n_major=5, loop_gain=0.2, threshold=1e-3, cycle_limit=300)
    model = np.asarray(result.model)
    # Component flux at the true source positions (sum over a small patch
    # to absorb sub-pixel spread).
    y1, x1 = IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9
    y2, x2 = IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15
    f1 = model[y1 - 2:y1 + 3, x1 - 2:x1 + 3].sum()
    f2 = model[y2 - 2:y2 + 3, x2 - 2:x2 + 3].sum()
    assert abs(f1 - 1.0) < 0.01, f1
    assert abs(f2 - 0.4) < 0.01, f2
    assert abs(model.sum() - 1.4) < 0.02
    # Residual peak decreases monotonically across major cycles.
    hist = result.peak_history
    assert all(b < a for a, b in zip(hist, hist[1:])), hist
    assert hist[-1] < 5e-3
    assert result.restored.shape == (IMAGE_SIZE, IMAGE_SIZE)


@pytest.mark.verylong
@pytest.mark.slow
def test_major_cycle_multichip_matches_single(scenario):
    s = scenario
    kwargs = dict(n_major=2, loop_gain=0.2, threshold=1e-3, cycle_limit=150)
    res1 = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]), **kwargs)
    res8 = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
        mesh=make_mesh(8), **kwargs)
    # N-chip result must match 1-chip (the reference's GPU-vs-CPU check).
    # CLEAN amplifies tiny float differences through argmax decisions, so
    # compare the physical outputs at modest tolerance.
    np.testing.assert_allclose(np.asarray(res8.model),
                               np.asarray(res1.model), atol=1e-6)
    np.testing.assert_allclose(np.asarray(res8.residual),
                               np.asarray(res1.residual), atol=1e-6)


@pytest.mark.slow
def test_checkpoint_resume(scenario, tmp_path):
    """Solver state persists per major cycle and resumes exactly."""
    s = scenario
    kwargs = dict(n_major=2, loop_gain=0.2, threshold=1e-3, cycle_limit=100)
    ref = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]), **kwargs)
    ckpt = str(tmp_path / "state.npz")
    # Run only the first major cycle, checkpointing.
    major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
        n_major=1, loop_gain=0.2, threshold=1e-3, cycle_limit=100,
        checkpoint_path=ckpt)
    # Resume and finish.
    res = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
        checkpoint_path=ckpt, **kwargs)
    np.testing.assert_allclose(np.asarray(res.model),
                               np.asarray(ref.model), atol=1e-12)
    assert res.peak_history == ref.peak_history


def test_orbax_checkpointer_roundtrip(tmp_path):
    """Orbax step checkpointing: save/restore state, retention, and
    sharded restore onto the mesh via a template."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from ska_sdp_func_jax.pipeline import SolverCheckpointer

    rng = np.random.default_rng(7)
    model = jnp.asarray(rng.standard_normal((32, 32)), jnp.float32)
    resid = jnp.asarray(rng.standard_normal((32, 32)), jnp.float32)
    with SolverCheckpointer(str(tmp_path / "ckpt"),
                            max_to_keep=2) as ck:
        assert ck.latest_step() is None
        for step in (1, 2, 3):
            ck.save(step, model * step, resid, peak_history=[0.5, 0.25],
                    meta={"image_size": 32})
        ck.wait()
        # Retention: only the last two steps survive.
        assert ck.latest_step() == 3
        m, r, cyc, hist, meta = ck.restore()
        np.testing.assert_allclose(np.asarray(m), np.asarray(model) * 3)
        np.testing.assert_allclose(np.asarray(r), np.asarray(resid))
        assert cyc == 3 and hist == [0.5, 0.25]
        assert meta == {"image_size": 32}
        m2, *_ = ck.restore(step=2)
        np.testing.assert_allclose(np.asarray(m2), np.asarray(model) * 2)
        with pytest.raises(Exception):
            ck.restore(step=1)          # pruned by max_to_keep
        # Sharded restore: the template's sharding lands the state on
        # the 8-device mesh (the multi-host resume path, shard-wise IO).
        mesh = make_mesh(8)
        shard = NamedSharding(mesh, PartitionSpec("rows", None))
        tmpl = {
            "model": jax.ShapeDtypeStruct((32, 32), jnp.float32,
                                          sharding=shard),
            "residual": jax.ShapeDtypeStruct((32, 32), jnp.float32,
                                             sharding=shard),
        }
        ms, rs, cyc, _, _ = ck.restore(template=tmpl)
        assert ms.sharding == shard and rs.sharding == shard
        np.testing.assert_allclose(np.asarray(ms),
                                   np.asarray(model) * 3)


@pytest.mark.slow
def test_checkpointer_solver_resume(scenario, tmp_path):
    """Solver resume through the orbax checkpointer matches the
    uninterrupted solve exactly (mirrors test_checkpoint_resume)."""
    from ska_sdp_func_jax.pipeline import SolverCheckpointer

    s = scenario
    kwargs = dict(n_major=2, loop_gain=0.2, threshold=1e-3,
                  cycle_limit=100)
    ref = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]), **kwargs)
    with pytest.raises(ValueError):
        major_cycle_imager(
            s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
            checkpoint_path="x.npz", checkpointer=object(), **kwargs)
    with SolverCheckpointer(str(tmp_path / "ck")) as ck:
        major_cycle_imager(
            s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
            n_major=1, loop_gain=0.2, threshold=1e-3, cycle_limit=100,
            checkpointer=ck)
        ck.wait()
        assert ck.latest_step() == 1
        res = major_cycle_imager(
            s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
            checkpointer=ck, **kwargs)
    np.testing.assert_allclose(np.asarray(res.model),
                               np.asarray(ref.model), atol=1e-12)
    assert res.peak_history == ref.peak_history


@pytest.mark.slow
def test_major_cycle_with_briggs_weights(scenario):
    """Weighted imaging: briggs weights plug into the solver and point
    sources are still recovered (weights reshape the PSF, not the flux)."""
    from ska_sdp_func_jax.visibility import briggs_weights, get_uv_range

    s = scenario
    num_rows, num_chan = s["vis"].shape
    freqs = s["freq0"] + s["dfreq"] * np.arange(num_chan)
    # The weighting API uses the canonical [time, baseline, chan, pol]
    # layout; flat rows map to one time slot.
    uvw4 = s["uvw"].reshape(1, num_rows, 3)
    win = np.ones((1, num_rows, num_chan, 1))
    max_abs_uv = get_uv_range(jnp.asarray(uvw4), jnp.asarray(freqs))
    _, w = briggs_weights(jnp.asarray(uvw4), jnp.asarray(freqs),
                          max_abs_uv, 0.5, jnp.asarray(win), 64)
    w = np.asarray(w).reshape(num_rows, num_chan)
    res = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
        n_major=4, loop_gain=0.2, threshold=1e-3, cycle_limit=300,
        weights=jnp.asarray(w))
    model = np.asarray(res.model)
    y1, x1 = IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9
    f1 = model[y1 - 2:y1 + 3, x1 - 2:x1 + 3].sum()
    assert abs(f1 - 1.0) < 0.05, f1


@pytest.mark.slow
def test_major_cycle_msclean_extended_emission(scenario):
    """Multi-scale minor cycles in the major loop recover an extended
    (Gaussian) source's total flux."""
    s = scenario
    yy, xx = np.mgrid[0:IMAGE_SIZE, 0:IMAGE_SIZE]
    blob = np.exp(-(((yy - IMAGE_SIZE // 2 - 8) ** 2
                     + (xx - IMAGE_SIZE // 2 + 6) ** 2) / (2 * 4.0 ** 2)))
    blob *= 2.0 / blob.sum()
    flux, lmn = image_to_flmn(jnp.asarray(blob), PARAMS["theta"], 0.0, 0.0)
    vis = dft(jnp.asarray(s["uvw"]), jnp.asarray(flux, complex),
              jnp.asarray(lmn), freq0_hz=s["freq0"], dfreq_hz=s["dfreq"],
              num_chan=2)
    res = major_cycle_imager(
        s["plan"], vis, jnp.asarray(s["uvw"]),
        n_major=5, loop_gain=0.2, threshold=1e-3, cycle_limit=300,
        clean_algorithm="msclean", scale_list=(0, 4, 8))
    model = np.asarray(res.model)
    assert abs(model.sum() - 2.0) < 0.05, model.sum()
    assert res.peak_history[-1] < 5e-3, res.peak_history


@pytest.mark.verylong
@pytest.mark.slow
def test_major_cycle_bucketed_matches(scenario):
    """The bucketed ingest path recovers the same sources (f32 path,
    modest tolerance)."""
    s = scenario
    kwargs = dict(n_major=3, loop_gain=0.2, threshold=1e-3, cycle_limit=200)
    res_b = major_cycle_imager(
        s["plan"], jnp.asarray(s["vis"], jnp.complex64),
        jnp.asarray(s["uvw"], jnp.float32), bucketed=True, **kwargs)
    model = np.asarray(res_b.model)
    y1, x1 = IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9
    y2, x2 = IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15
    f1 = model[y1 - 2:y1 + 3, x1 - 2:x1 + 3].sum()
    f2 = model[y2 - 2:y2 + 3, x2 - 2:x2 + 3].sum()
    assert abs(f1 - 1.0) < 0.02, f1
    assert abs(f2 - 0.4) < 0.02, f2


def test_ingest_flags_rfi_and_protects_image(scenario):
    """BASELINE config #4: the ingest stage flags an injected RFI spike
    and zeroes its weight, so the weighted solve recovers the true sky
    while the unflagged solve is corrupted."""
    from ska_sdp_func_jax.pipeline.ingest import ingest_to_solver

    s = scenario
    num_rows, num_chan = s["vis"].shape
    vis4d = np.asarray(s["vis"]).reshape(1, num_rows, num_chan, 1)
    vis4d = np.repeat(vis4d, 8, axis=0)  # 8 time slots for the flagger
    # Inject broadband RFI into one time/baseline.
    vis4d = vis4d.astype(np.complex128)
    vis4d[3, 7, :, 0] += 200.0 + 150.0j
    w4d = np.ones(vis4d.shape)
    vis_flat, w_flat, frac = ingest_to_solver(
        jnp.asarray(vis4d), jnp.asarray(w4d))
    assert 0 < frac < 0.05, frac
    # The RFI sample's weight is zeroed.
    assert float(w_flat[3 * num_rows + 7, :].max()) == 0.0
    # Clean samples keep weight 1.
    assert float(w_flat[0, 0]) == 1.0


def test_station_beam_power_normalised():
    from ska_sdp_func_jax.pipeline.ingest import station_beam_power

    rng = np.random.default_rng(0)
    n_elem = 64
    ex, ey = rng.uniform(-20, 20, (2, n_elem))
    ez = np.zeros(n_elem)
    w = np.ones(n_elem, complex)
    lmn = np.asarray([[0.0, 0.0, 1.0], [0.1, 0.05, np.sqrt(1 - 0.0125)]])
    p = np.asarray(station_beam_power(ex, ey, ez, w, lmn, 1.0e8))
    # Boresight gain is 1 (normalised beamformer), off-axis below it.
    np.testing.assert_allclose(p[0], 1.0, rtol=1e-6)
    assert p[1] < p[0]


@pytest.mark.verylong
@pytest.mark.slow
def test_solver_verbosity_stage_report(scenario):
    """verbosity>0 logs the per-stage Timers report (the reference
    driver's report_timing, sdp_grid_wstack_wtower.cpp:169-213).

    Captured with an explicit handler: the SKA logger binds its stream
    handlers to sys.stdout at first use, so capsys-based capture is
    test-order-dependent."""
    import io
    import logging

    from ska_sdp_func_jax.utility.logging import get_logger

    s = scenario
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    logger = get_logger()
    logger.addHandler(handler)
    try:
        major_cycle_imager(
            s["plan"], jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
            n_major=1, cycle_limit=20, bucketed=True, verbosity=1)
    finally:
        logger.removeHandler(handler)
    out = buf.getvalue()
    for stage in ("major_cycle_imager", "planning", "psf grid + sort",
                  "degrid predict", "grid residual", "minor cycle",
                  "restore"):
        assert stage in out, f"missing stage {stage!r} in report"


def test_ingest_sharded_matches_single():
    """Baseline-sharded ingest == single-device ingest (pad baselines
    to the mesh size, trim, psum only the flagged fraction)."""
    from ska_sdp_func_jax.parallel import make_mesh
    from ska_sdp_func_jax.pipeline.ingest import (
        ingest_flag_and_weight,
        ingest_flag_and_weight_sharded,
    )

    rng = np.random.default_rng(3)
    t, b, c, p = 8, 21, 16, 2    # b % 8 != 0: exercises the padding
    vis4d = (rng.standard_normal((t, b, c, p))
             + 1j * rng.standard_normal((t, b, c, p)))
    vis4d[2, 5, :, 0] += 180.0    # broadband RFI
    w4d = np.ones(vis4d.shape)
    flags0, w0, frac0 = ingest_flag_and_weight(
        jnp.asarray(vis4d), jnp.asarray(w4d))
    mesh = make_mesh(8)
    flags1, w1, frac1 = ingest_flag_and_weight_sharded(
        jnp.asarray(vis4d), jnp.asarray(w4d), mesh)
    np.testing.assert_array_equal(np.asarray(flags0),
                                  np.asarray(flags1))
    np.testing.assert_array_equal(np.asarray(w0), np.asarray(w1))
    np.testing.assert_allclose(float(frac0), float(frac1), rtol=1e-6)
    assert float(frac1) > 0


@pytest.mark.slow
def test_fista_imager_recovers_sources(scenario_packed):
    """FISTA proximal-gradient solve through the packed operators
    (the north star's CLEAN/FISTA solver family): point sources
    recovered, data residual decreasing."""
    from ska_sdp_func_jax.pipeline import fista_imager

    s = scenario_packed
    res = fista_imager(s["plan"], jnp.asarray(s["vis"]),
                       jnp.asarray(s["uvw"]), n_iter=60,
                       lam_frac=2e-3)
    model = np.asarray(res.model)
    size = s["plan"].image_size
    y1, x1 = size // 2 + 12, size // 2 - 9
    f1 = model[y1 - 2:y1 + 3, x1 - 2:x1 + 3].sum()
    assert abs(f1 - 1.0) < 0.1, f1
    # Monotone-ish residual decrease (FISTA can ripple; compare ends).
    assert res.residual_norm[-1] < 0.2 * res.residual_norm[0]


@pytest.mark.verylong
@pytest.mark.slow
def test_fista_sharded_matches_single(scenario_packed):
    """FISTA through the block-sharded packed drivers == single-chip."""
    from ska_sdp_func_jax.pipeline import fista_imager

    s = scenario_packed
    kw = dict(n_iter=8, lam_frac=2e-3)
    r1 = fista_imager(s["plan"], jnp.asarray(s["vis"]),
                      jnp.asarray(s["uvw"]), **kw)
    r8 = fista_imager(s["plan"], jnp.asarray(s["vis"]),
                      jnp.asarray(s["uvw"]), mesh=make_mesh(8), **kw)
    scale = float(np.abs(np.asarray(r1.model)).max())
    np.testing.assert_allclose(np.asarray(r8.model),
                               np.asarray(r1.model),
                               atol=2e-3 * max(scale, 1e-6))
