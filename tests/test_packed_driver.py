"""Packed whole-image drivers vs the oracle task drivers.

The packed path (parallel/packed.py) is the f32 performance path: host
bucket plan + bucket-blocked kernels + FFT drains. It is validated against the reference-faithful task drivers the way the
reference validates GPU against CPU (test_gridder_wtower_uvw.py:1848).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.parallel import plan_wstack
from ska_sdp_func_jax.parallel.packed import (
    grid_all_packed,
    degrid_all_packed,
    packed_gridder,
    plan_packed,
)
from ska_sdp_func_jax.parallel.wstack import (
    degrid_all_tasks,
    grid_all_tasks,
)

C_0 = 299792458.0

PARAMS = dict(
    subgrid_size=128,
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
IMAGE_SIZE = 256


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.default_rng(5)
    num_rows, num_chan = 150, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * IMAGE_SIZE / 2 / PARAMS["theta"]
    uvw[:, 2] *= 2.0 * PARAMS["w_step"] * PARAMS["w_tower_height"] / 2
    freq0, dfreq = C_0, C_0 / 100
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan))
           ).astype(np.complex64)
    plan = plan_wstack(uvw, freq0, dfreq, num_chan, IMAGE_SIZE, **PARAMS)
    pplan = plan_packed(plan, uvw, block_v=128)
    return dict(uvw=uvw, vis=vis, plan=plan, pplan=pplan,
                num_chan=num_chan)


def test_partition_complete_and_blocked(scenario):
    """Every (row, channel) is assigned exactly once (the reference's
    processed-vis invariant, sdp_grid_wstack_wtower.cpp:442-448)."""
    s = scenario
    pplan = s["pplan"]
    num_vis = s["uvw"].shape[0] * s["num_chan"]
    assert int(pplan.arrays["valid"].sum()) == num_vis
    assert pplan.total % pplan.block_v == 0
    assert pplan.num_blocks == pplan.arrays["block_bucket"].shape[0]
    # Buckets occupy contiguous block runs.
    bb = pplan.arrays["block_bucket"]
    changes = np.flatnonzero(np.diff(bb))
    assert np.all(np.diff(bb[np.concatenate([[0], changes + 1])]) > 0)
    # u_off stays in the octet window.
    assert pplan.arrays["u_off"].min() >= 0
    assert pplan.arrays["u_off"].max() < 8


def test_sort_unsort_roundtrip(scenario):
    s = scenario
    g = packed_gridder(s["pplan"])
    vre, vim = g.sort(jnp.asarray(s["vis"]))
    back = g.unsort((vre + 1j * vim).astype(jnp.complex64))
    np.testing.assert_allclose(np.asarray(back), s["vis"], atol=0)


@pytest.mark.slow
def test_packed_grid_matches_task_driver(scenario):
    s = scenario
    img_p = grid_all_packed(s["pplan"], jnp.asarray(s["vis"]),
                            precision="highest")
    n = s["uvw"].shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), s["num_chan"], jnp.int32)
    img_r = grid_all_tasks(s["plan"], s["plan"].kernel(),
                           jnp.asarray(s["vis"]), jnp.asarray(s["uvw"]),
                           st, en).real
    b = 24  # PSWF correction amplifies f32 noise towards the edge
    scale = float(np.abs(np.asarray(img_r)[b:-b, b:-b]).max())
    # 5e-4: f32 taps + w-pattern ladder noise at subgrid 128; the
    # round-1 bucketed driver measures 3.4e-4 on this same scenario.
    np.testing.assert_allclose(
        np.asarray(img_p)[b:-b, b:-b], np.asarray(img_r)[b:-b, b:-b],
        atol=5e-4 * scale)


def test_packed_degrid_matches_task_driver(scenario):
    s = scenario
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    img[IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15] = 0.5
    vis_p = degrid_all_packed(s["pplan"], jnp.asarray(img))
    n = s["uvw"].shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), s["num_chan"], jnp.int32)
    vis_r = degrid_all_tasks(s["plan"], s["plan"].kernel(),
                             jnp.asarray(img, jnp.complex64),
                             jnp.asarray(s["uvw"]), st, en, jnp.complex64)
    scale = float(np.abs(np.asarray(vis_r)).max())
    np.testing.assert_allclose(np.asarray(vis_p), np.asarray(vis_r),
                               atol=5e-4 * scale)


@pytest.mark.slow
def test_packed_sharded_matches_single(scenario):
    """8-device packed grid/degrid equal the 1-device results (the
    reference's GPU-vs-CPU consistency pattern)."""
    from ska_sdp_func_jax.parallel import make_mesh
    from ska_sdp_func_jax.parallel.packed import (
        degrid_all_packed_sharded,
        grid_all_packed_sharded,
    )

    s = scenario
    mesh = make_mesh(8)
    pplan8 = plan_packed(s["plan"], s["uvw"], block_v=128,
                         pad_blocks_to=8)
    # Same precision both sides: raw images of different precisions
    # differ by the 1/PSWF-amplified kernel noise near the border.
    img_1 = grid_all_packed(s["pplan"], jnp.asarray(s["vis"]),
                            precision="highest")
    img_8 = grid_all_packed_sharded(pplan8, jnp.asarray(s["vis"]), mesh,
                                    precision="highest")
    b = 24  # exclude the 1/PSWF-divergent border
    scale = float(np.abs(np.asarray(img_1)[b:-b, b:-b]).max())
    # Straddled buckets drain through separate per-shard FFT chains;
    # f32 reassociation noise lands at a few 1e-4 of peak.
    np.testing.assert_allclose(
        np.asarray(img_8)[b:-b, b:-b], np.asarray(img_1)[b:-b, b:-b],
        atol=1e-3 * scale)

    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    vis_1 = degrid_all_packed(s["pplan"], jnp.asarray(img),
                              precision="highest")
    vis_8 = degrid_all_packed_sharded(pplan8, jnp.asarray(img), mesh,
                                      precision="highest")
    vscale = float(np.abs(np.asarray(vis_1)).max())
    np.testing.assert_allclose(np.asarray(vis_8), np.asarray(vis_1),
                               atol=1e-4 * vscale)


@pytest.mark.slow
def test_major_cycle_packed_converges(scenario):
    """The solver's bucketed=True path picks the packed ingest for
    128-multiple subgrids and still converges on point sources."""
    from ska_sdp_func_jax.pipeline import major_cycle_imager

    s = scenario
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float64)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    n = s["uvw"].shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), s["num_chan"], jnp.int32)
    vis = degrid_all_tasks(s["plan"], s["plan"].kernel(),
                           jnp.asarray(img, jnp.complex128),
                           jnp.asarray(s["uvw"]), st, en,
                           jnp.complex64)
    res = major_cycle_imager(s["plan"], vis, jnp.asarray(s["uvw"]),
                             n_major=3, bucketed=True)
    model = np.asarray(res.model)
    got = model[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9]
    assert abs(got - 1.0) < 0.05
    assert res.peak_history[-1] < res.peak_history[0]


def test_packed_plan_rejects_unsupported_geometry(scenario):
    from ska_sdp_func_jax.utility.errors import SdpInvalidArgumentError

    s = scenario
    bad = plan_wstack(s["uvw"], C_0, C_0 / 100, s["num_chan"], IMAGE_SIZE,
                      **{**PARAMS, "subgrid_size": 96})
    with pytest.raises(SdpInvalidArgumentError):
        plan_packed(bad, s["uvw"])


@pytest.mark.slow
def test_report_timing_stages(scenario):
    """The per-stage device-time report runs and covers the pipeline."""
    s = scenario
    g = packed_gridder(s["pplan"])
    vre, vim = g.sort(jnp.asarray(s["vis"]))
    lines = []
    stages = g.report_timing(vre, vim, iters=2,
                             print_fn=lines.append)
    assert len(stages) == 4
    assert all(t >= 0.0 for t in stages.values())
    assert any("stack kernel" in ln for ln in lines)
    # Degrid mirror.
    size = s["plan"].image_size
    model = jnp.zeros((size, size), jnp.float32) \
        .at[size // 2 + 5, size // 2 - 3].set(1.0)
    dlines = []
    dstages = g.report_timing_degrid(model, iters=2,
                                     print_fn=dlines.append)
    assert len(dstages) == 3
    assert all(t >= 0.0 for t in dstages.values())
    assert any("degrid kernel" in ln for ln in dlines)


def test_native_planner_matches_numpy(scenario, monkeypatch):
    """The C++ two-pass packed planner produces byte-identical arrays
    to the NumPy fallback (same stable bucket order, same f32 taps)."""
    from ska_sdp_func_jax import native

    s = scenario
    if not native.available():
        pytest.skip("native runtime unavailable")
    plan_native = plan_packed(s["plan"], s["uvw"], block_v=128)
    monkeypatch.setattr(native, "packed_plan_arrays",
                        lambda *a, **k: None)
    plan_numpy = plan_packed(s["plan"], s["uvw"], block_v=128)
    assert plan_native.total == plan_numpy.total
    for name in ("sort_index", "valid", "u_off", "iv0", "uk", "vk",
                 "wk", "block_bucket", "visited"):
        np.testing.assert_array_equal(plan_native.arrays[name],
                                      plan_numpy.arrays[name], err_msg=name)
    assert plan_native.digest == plan_numpy.digest


@pytest.mark.slow
def test_boundary_tie_assignment_parity():
    """Adversarial uvws exactly on sub-grid/w-slab box edges.

    The packed planner's floor-based assignment and the task drivers'
    channel-clamp intervals may route an exact-tie row to either of the
    two adjacent boxes (the reference's clamp flips the half-open side
    when the channel ramp du < 0 — sdp_gridder_clamp_channels.h:100-178
    keeps adjacent boxes non-overlapping with ceil on both bounds).
    Both partitions are complete, so the invariant is: nothing dropped,
    and the GRIDDED IMAGES agree wherever the tie row lands.
    """
    num_chan = 2
    freq0, dfreq = C_0, 1e6
    plan0 = plan_wstack(np.zeros((1, 3)), freq0, dfreq, num_chan,
                        IMAGE_SIZE, **PARAMS)
    d = plan0.eff_sg_dist
    wd = plan0.w_stack_dist
    eps = 1e-9
    us = [0.0, d / 2, -d / 2, d / 2 - eps, d / 2 + eps, d]
    ws = [0.0, wd / 2, wd / 2 - eps, -wd / 2]
    uvw = np.asarray([[u, v, w] for u in us for v in us[:3]
                      for w in ws])
    rng = np.random.default_rng(9)
    vis = (rng.standard_normal((uvw.shape[0], num_chan))
           + 1j * rng.standard_normal((uvw.shape[0], num_chan))
           ).astype(np.complex64)

    plan = plan_wstack(uvw, freq0, dfreq, num_chan, IMAGE_SIZE, **PARAMS)
    pplan = plan_packed(plan, uvw)
    # Nothing dropped: the processed-vis invariant holds on exact ties.
    assert int(pplan.arrays["valid"].sum()) == uvw.shape[0] * num_chan

    img_p = grid_all_packed(pplan, jnp.asarray(vis),
                            precision="highest")
    n = uvw.shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), num_chan, jnp.int32)
    img_r = grid_all_tasks(plan, plan.kernel(), jnp.asarray(vis),
                           jnp.asarray(uvw), st, en).real
    b = 24
    scale = float(np.abs(np.asarray(img_r)[b:-b, b:-b]).max())
    np.testing.assert_allclose(
        np.asarray(img_p)[b:-b, b:-b], np.asarray(img_r)[b:-b, b:-b],
        atol=5e-4 * scale)


@pytest.mark.slow
def test_major_cycle_packed_sharded_matches_single(scenario):
    """bucketed=True + mesh runs the packed block-sharded solver and
    matches the single-chip packed solve (GPU-vs-CPU pattern)."""
    from ska_sdp_func_jax.parallel import make_mesh
    from ska_sdp_func_jax.pipeline import major_cycle_imager

    s = scenario
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float64)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    n = s["uvw"].shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), s["num_chan"], jnp.int32)
    vis = degrid_all_tasks(s["plan"], s["plan"].kernel(),
                           jnp.asarray(img, jnp.complex128),
                           jnp.asarray(s["uvw"]), st, en, jnp.complex64)
    kwargs = dict(n_major=2, loop_gain=0.2, cycle_limit=100)
    res_1 = major_cycle_imager(s["plan"], vis, jnp.asarray(s["uvw"]),
                               bucketed=True, **kwargs)
    res_8 = major_cycle_imager(s["plan"], vis, jnp.asarray(s["uvw"]),
                               bucketed=True, mesh=make_mesh(8), **kwargs)
    np.testing.assert_allclose(np.asarray(res_8.model),
                               np.asarray(res_1.model), atol=2e-4)


def test_packed_fast_mode_accuracy(scenario):
    """Opt-in fast mode (bf16 products) stays within its documented ~2e-3 accuracy of the exact driver on
    both grid and degrid."""
    s = scenario
    g_exact = packed_gridder(s["pplan"])
    g_fast = packed_gridder(s["pplan"], fast=True)

    vre, vim = g_exact.sort(jnp.asarray(s["vis"]))
    img_e = np.asarray(g_exact.grid_sorted(vre, vim))
    img_f = np.asarray(g_fast.grid_sorted(vre, vim))
    # Compare in the pre-correction domain: the 1/PSWF grid correction
    # amplifies the image border by many orders of magnitude (the
    # reference divides by the same 1e-15-clamped PSWF edge), so any
    # kernel-level perturbation looks unbounded there. Weighting both
    # images by the taper the correction divided out restores a
    # well-conditioned comparison.
    kern = s["plan"].kernel()
    taper = 1.0 / np.asarray(kern.grid_correct(
        jnp.ones((IMAGE_SIZE, IMAGE_SIZE), jnp.float32)))
    diff = np.abs((img_f - img_e) * taper)
    scale = float(np.abs(img_e * taper).max())
    assert diff.max() < 5e-3 * scale

    # Point-source model (what CLEAN produces). bf16's relative error
    # scales with the window/visibility conditioning: for sky-like
    # models the 8x8 window samples grid values of the visibility's
    # own magnitude, so the error stays at the documented few-1e-3; a
    # noise image with 1/PSWF-amplified border pixels is pathological
    # (windows 1e3x the visibilities) and is not a production input.
    image = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    image[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    image[IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15] = 0.5
    vis_e = np.asarray(g_exact.degrid_sorted(jnp.asarray(image)))
    vis_f = np.asarray(g_fast.degrid_sorted(jnp.asarray(image)))
    vscale = float(np.abs(vis_e).max())
    np.testing.assert_allclose(vis_f, vis_e, atol=5e-3 * vscale)


def test_packed_high_precision_accuracy(scenario):
    """precision="high" (three-piece bf16 split, six single-pass
    products with f32 accumulate) stays within 1e-5 of the HIGHEST
    driver on grid AND degrid, in the taper-weighted domain (see
    test_packed_fast_mode_accuracy for why the 1/PSWF-corrected border
    is excluded): f32-grade accuracy from bf16 products."""
    s = scenario
    g_exact = packed_gridder(s["pplan"], precision="highest")
    g_high = packed_gridder(s["pplan"], precision="high")

    vre, vim = g_exact.sort(jnp.asarray(s["vis"]))
    img_e = np.asarray(g_exact.grid_sorted(vre, vim))
    img_h = np.asarray(g_high.grid_sorted(vre, vim))
    kern = s["plan"].kernel()
    taper = 1.0 / np.asarray(kern.grid_correct(
        jnp.ones((IMAGE_SIZE, IMAGE_SIZE), jnp.float32)))
    scale = float(np.abs(img_e * taper).max())
    assert np.abs((img_h - img_e) * taper).max() < 1e-5 * scale

    image = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    image[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    image[IMAGE_SIZE // 2 - 20, IMAGE_SIZE // 2 + 15] = 0.5
    vis_e = np.asarray(g_exact.degrid_sorted(jnp.asarray(image)))
    vis_h = np.asarray(g_high.degrid_sorted(jnp.asarray(image)))
    vscale = float(np.abs(vis_e).max())
    np.testing.assert_allclose(vis_h, vis_e, atol=1e-5 * vscale)


@pytest.mark.slow
def test_major_cycle_packed_fast_converges(scenario):
    """fast=True (bf16 kernels) still converges: the major loop's
    re-prediction corrects the ~2e-3 kernel error each cycle."""
    from ska_sdp_func_jax.pipeline import major_cycle_imager

    s = scenario
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float64)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    n = s["uvw"].shape[0]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), s["num_chan"], jnp.int32)
    vis = degrid_all_tasks(s["plan"], s["plan"].kernel(),
                           jnp.asarray(img, jnp.complex128),
                           jnp.asarray(s["uvw"]), st, en,
                           jnp.complex64)
    res = major_cycle_imager(s["plan"], vis, jnp.asarray(s["uvw"]),
                             n_major=3, bucketed=True, fast=True)
    model = np.asarray(res.model)
    got = model[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9]
    assert abs(got - 1.0) < 0.05
    assert res.peak_history[-1] < res.peak_history[0]


def test_subcell_shift_changes_digest(scenario):
    """Two plans differing only in sub-oversample-cell tap fractions
    must not alias in the gridder cache (digest covers u_frac/v_frac/
    w_row, the arrays the device tap evaluation consumes)."""
    s = scenario
    theta, ov = PARAMS["theta"], PARAMS["oversampling"]
    uvw2 = np.array(s["uvw"], copy=True)
    # Shift u by ~0.43 of one oversampled kernel cell (1/(theta*ov)
    # wavelengths == metres at freq C_0): integer cell geometry stays
    # identical for almost every visibility, the tap fractions change.
    uvw2[:, 0] += 0.43 / (theta * ov)
    plan2 = plan_wstack(uvw2, C_0, C_0 / 100, s["num_chan"],
                        IMAGE_SIZE, **PARAMS)
    pplan2 = plan_packed(plan2, uvw2, block_v=128)
    assert pplan2.digest != s["pplan"].digest
    assert pplan2 != s["pplan"]
    g1 = packed_gridder(s["pplan"])
    g2 = packed_gridder(pplan2)
    assert g1 is not g2
