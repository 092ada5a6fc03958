"""Streaming (device-planned, chunked) gridder vs the host-planned
packed path.

The device planner re-derives the quantised geometry in f32; parity
with the f64 host planner is exact on bucket/plane assignment for
non-adversarial uvw and within one oversample bin on tap rows (see
parallel/streaming.py precision note), so images are compared on the
interior (the 1/PSWF grid correction amplifies f32-level noise at the
border ring — the reference tests exclude a border for the same
reason, test_gridder_wtower_uvw.py:2188-2193).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.parallel import (
    StreamingDegridder,
    StreamingGridder,
    packed_gridder,
    plan_packed,
    plan_stream,
    plan_wstack,
    stream_tasks,
)
from ska_sdp_func_jax.utility.errors import (
    SdpInvalidArgumentError,
    SdpRuntimeError,
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
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan))
           ).astype(np.complex64)
    plan = plan_wstack(uvw, C_0, C_0 / 100, num_chan, IMAGE_SIZE,
                       **PARAMS)
    boxes = stream_tasks(plan, uvw)
    return dict(uvw=uvw, vis=vis, plan=plan, boxes=boxes,
                num_chan=num_chan)


def test_stream_tasks_matches_host_planner(scenario):
    s = scenario
    pplan = plan_packed(s["plan"], s["uvw"], block_v=128)
    host_boxes = sorted((t.iw, t.iu, t.iv) for t in pplan.tasks)
    stream_boxes = sorted(map(tuple, np.asarray(s["boxes"])))
    assert host_boxes == stream_boxes


def test_streaming_matches_packed_interior(scenario):
    """Chunked device-planned gridding == host-planned packed gridding
    on the image interior (f32 floor; border ring excluded, see module
    docstring)."""
    s = scenario
    # Same (default) precision as the streaming engine.
    g = packed_gridder(plan_packed(s["plan"], s["uvw"], block_v=128))
    img_ref = np.asarray(g.grid(jnp.asarray(s["vis"])))

    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=20480)
    sg = StreamingGridder(sp)
    rows = s["uvw"].shape[0]
    for lo in range(0, rows, 64):
        hi = min(rows, lo + 64)
        sg.accumulate(s["uvw"][lo:hi], s["vis"][lo:hi])
    img = np.asarray(sg.finalize())

    m = 32
    peak = np.abs(img_ref[m:-m, m:-m]).max()
    np.testing.assert_allclose(img[m:-m, m:-m], img_ref[m:-m, m:-m],
                               atol=2e-4 * peak)
    processed, dropped, voided = (int(x) for x in sg.counters())
    assert processed == rows * s["num_chan"]
    assert dropped == 0 and voided == 0


@pytest.mark.slow
def test_streaming_chunking_invariance(scenario):
    """One chunk == three chunks (gridding is linear; identical
    quantisation per visibility either way)."""
    s = scenario
    rows = s["uvw"].shape[0]
    sp1 = plan_stream(s["plan"], s["boxes"], chunk_rows=rows,
                      block_v=128, cap_slots=40000)
    sg1 = StreamingGridder(sp1)
    sg1.accumulate(s["uvw"], s["vis"])
    img1 = np.asarray(sg1.finalize())

    sp3 = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                      block_v=128, cap_slots=40000)
    sg3 = StreamingGridder(sp3)
    for lo in range(0, rows, 64):
        hi = min(rows, lo + 64)
        sg3.accumulate(s["uvw"][lo:hi], s["vis"][lo:hi])
    img3 = np.asarray(sg3.finalize())
    # Chunking reassociates the f32 bucket sums (intermediate subgrid
    # magnitudes are ~1e4 here) and the border-adjacent correction
    # amplifies that noise — same envelope as the packed parity test.
    m = 32
    scale = np.abs(img1[m:-m, m:-m]).max()
    np.testing.assert_allclose(img3[m:-m, m:-m], img1[m:-m, m:-m],
                               atol=2e-4 * scale)


def test_streaming_weights(scenario):
    """Weights scale visibilities on the gridding side (reference
    grid_uvw_es_fft weight semantics)."""
    s = scenario
    rows = 8
    # Shares the parity test's engine shape (cached compile).
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=20480)
    sg_w = StreamingGridder(sp)
    wgt = np.full((rows, s["num_chan"]), 0.5, np.float32)
    sg_w.accumulate(s["uvw"][:rows], s["vis"][:rows], weights=wgt)
    img_w = np.asarray(sg_w.finalize())
    sg = StreamingGridder(sp)
    sg.accumulate(s["uvw"][:rows], 0.5 * s["vis"][:rows])
    img = np.asarray(sg.finalize())
    np.testing.assert_allclose(img_w, img, rtol=0, atol=1e-6
                               * max(np.abs(img).max(), 1e-9))


def test_streaming_counts_dropped_and_raises(scenario):
    """Visibilities outside the task set are counted and surfaced at
    finalize (processed-vis invariant,
    sdp_grid_wstack_wtower.cpp:442-448) — never silently dropped."""
    s = scenario
    # Same (chunk_rows, cap) as the parity test: the engine cache
    # shares the compiled step, so this test compiles nothing.
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=20480)
    sg = StreamingGridder(sp)
    uvw_bad = s["uvw"][:8].copy()
    uvw_bad[0, 0] *= 50.0     # far outside the task boxes
    sg.accumulate(uvw_bad, s["vis"][:8])
    _, dropped, _ = sg.counters()
    assert int(dropped) == s["num_chan"]
    with pytest.raises(SdpRuntimeError):
        sg.finalize()


@pytest.mark.slow
def test_streaming_overflow_voids_chunk(scenario):
    """A chunk exceeding the padded-stream capacity contributes
    nothing (no silently truncated image) and finalize raises."""
    s = scenario
    rows = s["uvw"].shape[0]
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=rows,
                     block_v=128, cap_slots=256)
    sg = StreamingGridder(sp)
    sg.accumulate(s["uvw"], s["vis"])
    assert int(sg.counters()[2]) == 1
    assert float(jnp.abs(sg.image).max()) == 0.0
    with pytest.raises(SdpRuntimeError, match="capacity"):
        sg.finalize()


def test_streaming_rejects_bad_shapes(scenario):
    s = scenario
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=16,
                     block_v=128, cap_slots=20000)
    sg = StreamingGridder(sp)
    with pytest.raises(SdpInvalidArgumentError):
        sg.accumulate(s["uvw"][:32], s["vis"][:32])     # > chunk_rows
    with pytest.raises(SdpInvalidArgumentError):
        sg.accumulate(s["uvw"][:8, :2], s["vis"][:8])   # uvw not [R,3]
    with pytest.raises(SdpInvalidArgumentError):
        sg.accumulate(s["uvw"][:8], s["vis"][:7])       # row mismatch
    with pytest.raises(SdpInvalidArgumentError):
        plan_stream(s["plan"], np.zeros((0, 3)), chunk_rows=16)
    with pytest.raises(SdpInvalidArgumentError):
        plan_stream(s["plan"], s["boxes"], chunk_rows=0)


@pytest.mark.slow
def test_streaming_partial_chunk_padding(scenario):
    """Short chunks are padded+masked: same image as exact-size
    chunks."""
    s = scenario
    rows = 96
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=40000)
    sg_a = StreamingGridder(sp)
    sg_a.accumulate(s["uvw"][:64], s["vis"][:64])
    sg_a.accumulate(s["uvw"][64:rows], s["vis"][64:rows])  # 32 rows
    img_a = np.asarray(sg_a.finalize())

    sp_b = plan_stream(s["plan"], s["boxes"], chunk_rows=48,
                       block_v=128, cap_slots=40000)
    sg_b = StreamingGridder(sp_b)
    sg_b.accumulate(s["uvw"][:48], s["vis"][:48])
    sg_b.accumulate(s["uvw"][48:rows], s["vis"][48:rows])
    img_b = np.asarray(sg_b.finalize())
    m = 32
    scale = max(np.abs(img_a[m:-m, m:-m]).max(), 1e-9)
    np.testing.assert_allclose(img_b[m:-m, m:-m], img_a[m:-m, m:-m],
                               atol=2e-4 * scale)


def test_streaming_predict_matches_packed(scenario):
    """Chunked device-planned predict == host-planned packed degrid
    (same f32 kernels; geometry quantisation jitter only)."""
    s = scenario
    rng = np.random.default_rng(11)
    model = rng.standard_normal(
        (IMAGE_SIZE, IMAGE_SIZE)).astype(np.float32)
    # Zero the border ring: the degrid correction divides by the PSWF,
    # which diverges there (~1e9 amplification) — physical models are
    # border-free and the packed parity tests exclude it likewise.
    m = 32
    model[:m], model[-m:], model[:, :m], model[:, -m:] = 0, 0, 0, 0
    g = packed_gridder(plan_packed(s["plan"], s["uvw"], block_v=128))
    vis_ref = np.asarray(g.degrid(jnp.asarray(model)))

    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=20480)
    sd = StreamingDegridder(sp).set_model(model)
    rows = s["uvw"].shape[0]
    out = np.concatenate([
        np.asarray(sd.predict(s["uvw"][lo:min(rows, lo + 64)]))
        for lo in range(0, rows, 64)])
    sd.check()
    scale = np.abs(vis_ref).max()
    np.testing.assert_allclose(out, vis_ref, atol=2e-4 * scale)


def test_streaming_predict_dropped_raises(scenario):
    s = scenario
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=20480)
    sd = StreamingDegridder(sp).set_model(
        np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32))
    uvw_bad = s["uvw"][:4].copy()
    uvw_bad[1, 1] *= 50.0
    vis = np.asarray(sd.predict(uvw_bad))
    assert vis.shape == (4, s["num_chan"])
    with pytest.raises(SdpRuntimeError):
        sd.check()
    with pytest.raises(SdpRuntimeError):
        StreamingDegridder(sp).predict(s["uvw"][:4])   # no model set


@pytest.mark.slow
def test_streaming_sharded_matches_single(scenario):
    """Row-sharded chunk step over the virtual mesh == single-device
    streaming (planes psum; counters psum; same f32 plan per shard)."""
    from ska_sdp_func_jax.parallel import make_mesh

    s = scenario
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=4 * 20480)
    rows = 128
    sg1 = StreamingGridder(sp)
    sg1.accumulate(s["uvw"][:64], s["vis"][:64])
    sg1.accumulate(s["uvw"][64:rows], s["vis"][64:rows])
    img1 = np.asarray(sg1.finalize())

    mesh = make_mesh(4)
    sgm = StreamingGridder(sp, mesh=mesh)
    sgm.accumulate(s["uvw"][:64], s["vis"][:64])
    sgm.accumulate(s["uvw"][64:rows], s["vis"][64:rows])
    imgm = np.asarray(sgm.finalize())
    m = 32
    scale = np.abs(img1[m:-m, m:-m]).max()
    np.testing.assert_allclose(imgm[m:-m, m:-m], img1[m:-m, m:-m],
                               atol=2e-4 * scale)


@pytest.mark.slow
def test_streaming_sharded_predict_matches_single(scenario):
    """Row-sharded predict over the virtual mesh == single-device
    predict (embarrassingly row-parallel; counters psum)."""
    from ska_sdp_func_jax.parallel import make_mesh

    s = scenario
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=4 * 20480)
    model = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    model[100, 120], model[170, 90] = 1.0, 0.6
    sd1 = StreamingDegridder(sp).set_model(model)
    v1 = np.asarray(sd1.predict(s["uvw"][:64]))
    sd1.check()
    sdm = StreamingDegridder(sp, mesh=make_mesh(4)).set_model(model)
    vm = np.asarray(sdm.predict(s["uvw"][:64]))
    sdm.check()
    scale = max(np.abs(v1).max(), 1e-9)
    np.testing.assert_allclose(vm, v1, atol=1e-5 * scale)


@pytest.mark.slow
def test_streaming_ingest_composition_flags_rfi(scenario):
    """Production ingest chain: RFI flagging + weighting
    (pipeline.ingest_to_solver) feeds StreamingGridder chunk by chunk
    — the flagged sample's zeroed weight keeps the streamed image
    equal to the clean-data image."""
    from ska_sdp_func_jax.pipeline.ingest import ingest_to_solver

    s = scenario
    num_rows, num_chan = s["vis"].shape
    n_t = 8
    vis4d = np.repeat(
        np.asarray(s["vis"]).reshape(1, num_rows, num_chan, 1),
        n_t, axis=0).astype(np.complex128)
    vis4d_rfi = vis4d.copy()
    vis4d_rfi[3, 7, :, 0] += 200.0 + 150.0j      # broadband RFI
    w4d = np.ones(vis4d.shape)

    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=num_rows,
                     block_v=128, cap_slots=40000)

    def run(v4d, wgt4d):
        vis_flat, w_flat, _ = ingest_to_solver(
            jnp.asarray(v4d), jnp.asarray(wgt4d))
        sg = StreamingGridder(sp)
        for t in range(n_t):     # one chunk per time slot
            sl = slice(t * num_rows, (t + 1) * num_rows)
            sg.accumulate(s["uvw"], vis_flat[sl], weights=w_flat[sl])
        return np.asarray(sg.finalize())

    img_rfi = run(vis4d_rfi, w4d)
    # Reference: clean data with the SAME sample's weight zeroed by
    # hand — flagging must be equivalent to removing the sample.
    w4d_ref = w4d.copy()
    w4d_ref[3, 7, :, 0] = 0.0
    img_ref = run(vis4d, w4d_ref)
    m = 32
    scale = np.abs(img_ref[m:-m, m:-m]).max()
    np.testing.assert_allclose(img_rfi[m:-m, m:-m],
                               img_ref[m:-m, m:-m],
                               atol=2e-4 * scale)
    # Sanity: had the 200-unit RFI NOT been excluded, the image would
    # differ by far more than the envelope above.
    img_clean_full = run(vis4d, w4d)
    rfi_effect = np.abs(img_clean_full[m:-m, m:-m]
                        - img_ref[m:-m, m:-m]).max()
    assert rfi_effect < 0.05 * scale   # one sample of 2400 removed


@pytest.mark.slow
def test_streaming_sharded_multi_axis_mesh(scenario):
    """On a 2-D mesh only the named axis shards rows; the per-shard
    capacity is budgeted from mesh.shape[axis], not the device count
    (a (4,2) mesh must behave exactly like a 4-device 1-D mesh)."""
    import jax
    from jax.sharding import Mesh

    s = scenario
    sp = plan_stream(s["plan"], s["boxes"], chunk_rows=64,
                     block_v=128, cap_slots=4 * 20480)
    sg1 = StreamingGridder(sp)
    sg1.accumulate(s["uvw"][:64], s["vis"][:64])
    img1 = np.asarray(sg1.finalize())

    mesh2 = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                 ("rows", "cols"))
    sgm = StreamingGridder(sp, mesh=mesh2)
    sgm.accumulate(s["uvw"][:64], s["vis"][:64])
    imgm = np.asarray(sgm.finalize())
    m = 32
    scale = np.abs(img1[m:-m, m:-m]).max()
    np.testing.assert_allclose(imgm[m:-m, m:-m], img1[m:-m, m:-m],
                               atol=2e-4 * scale)


def test_box_membership_fma_hull():
    """Adversarial hull-boundary agreement (round-3 verdict, weak #3):
    visibilities whose f32 box coordinate sits within a few ulps of a
    box edge must land in a stream_tasks box on the device backend too.
    The f32 "identical by construction" claim is FMA-fragile — XLA may
    contract `u * inv_d + 0.5` into one fused rounding — so
    _plan_chunk pins the two-step rounding with an optimization
    barrier; this drives the boundary through both paths end-to-end
    (finalize raises on any membership disagreement)."""
    num_chan = 1
    # freq0 = C_0 and a single channel make scale exactly 1.0: the
    # wavelength conversion multiplies by 1.0 (exact), so the crafted
    # ulp placements reach the quantisation untouched.
    probe = plan_wstack(np.asarray([[1.0, 1.0, 1.0]]), C_0, 10.0,
                        num_chan, IMAGE_SIZE, **PARAMS)
    d = float(probe.eff_sg_dist)
    us = []
    for k in (-2, -1, 0, 1, 2):
        edge = np.float32((k - 0.5) * d)
        lo = hi = edge
        us.append(edge)
        for _ in range(8):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            us.extend((lo, hi))
    us = np.asarray(us, np.float64)
    rows = us.shape[0]
    uvw = np.zeros((rows, 3))
    uvw[:, 0] = us
    # Mirror the same placements on v; keep w at 0 (same formula per
    # component).
    uvw[:, 1] = us[::-1]

    plan = plan_wstack(uvw, C_0, 10.0, num_chan, IMAGE_SIZE, **PARAMS)
    boxes = stream_tasks(plan, uvw)
    sp = plan_stream(plan, boxes, chunk_rows=rows, block_v=128,
                     cap_slots=81920)
    sg = StreamingGridder(sp)
    vis = np.ones((rows, num_chan), np.complex64)
    sg.accumulate(uvw, vis)
    sg.finalize(check=True)      # raises on any dropped visibility
    processed, dropped, voided = (int(x) for x in sg.counters())
    assert processed == rows * num_chan
    assert dropped == 0 and voided == 0


@pytest.mark.slow
def test_streaming_nonpackable_fallback_matches_packed(scenario):
    """A finer uv oversampling (65536) streams through the same device
    plan and kernels — pin it against the packed reference the same
    way as the default geometry."""
    from ska_sdp_func_jax.parallel.packed import plan_packed
    from ska_sdp_func_jax.parallel.wstack import plan_wstack

    s = scenario
    plan = plan_wstack(
        s["uvw"], s["plan"].freq0_hz, s["plan"].dfreq_hz,
        s["plan"].num_chan, s["plan"].image_size,
        s["plan"].subgrid_size, s["plan"].theta, s["plan"].w_step,
        support=8, oversampling=65536, w_support=4,
        w_oversampling=16384,
        w_tower_height=s["plan"].w_tower_height)
    g = packed_gridder(plan_packed(plan, s["uvw"], block_v=128))
    img_ref = np.asarray(g.grid(jnp.asarray(s["vis"])))

    sp = plan_stream(plan, s["boxes"], chunk_rows=64, block_v=128,
                     cap_slots=20480)
    sg = StreamingGridder(sp)
    rows = s["uvw"].shape[0]
    for lo in range(0, rows, 64):
        hi = min(rows, lo + 64)
        sg.accumulate(s["uvw"][lo:hi], s["vis"][lo:hi])
    img = np.asarray(sg.finalize())
    m = 32
    d = np.abs(img[m:-m, m:-m] - img_ref[m:-m, m:-m]).max()
    pk = np.abs(img_ref[m:-m, m:-m]).max()
    assert d / pk < 2e-4
