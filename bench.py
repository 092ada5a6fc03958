"""Benchmark: whole-image w-towers imaging on one NVIDIA GPU.

Runs the packed ingest path (parallel/packed.py — bucket-sorted
visibility stream, bucket-blocked gridding kernels) in one process:

- ``gridding_throughput``: WHOLE-IMAGE gridding Mvis/s — 512^2 image,
  ~1M visibilities spread over the full (u, v, w) box grid (multiple
  sub-grid tasks and w-stacking planes), f32, end to end (kernel +
  FFT drains + ladder + sub-grid adds + grid corrections).
- ``degrid_mvis_s``: the mirror whole-image degridding rate.
- ``major_cycle_iters_s``: solver iterations/s on the same data —
  degrid prediction -> residual -> grid -> Hogbom minor cycle -> model
  update.
- ``dense_grid_mvis_s`` / ``dense_fast_grid_mvis_s``: gridding of a
  4.2M-visibility stream (256 channels) at the default and bf16
  precisions.
- ``stream_ingest_mvis_s``: device-planned streaming ingest of the
  dense stream, measured after the dense gridders are freed.

Each rate is the median of three timed loops, each call timed to
``block_until_ready``. Needs a GPU: on any other platform it exits
non-zero. Prints ONE JSON line naming the device it ran on.

    python bench.py            # the benchmark
    python bench.py --smoke    # one call of every kernel mode
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

C_0 = 299792458.0

IMAGE, SUBGRID = 512, 128
THETA, W_STEP, HEIGHT = 0.002, 100.0, 4.0
ROWS, CHANS = 16384, 64


def _grid_stream_bytes_per_slot(g) -> float:
    """Device-memory bytes the grid kernel reads per padded stream slot
    (the per-slot taps of kernels/packed_tap.Taps plus the visibility):
    ``u_off`` and ``iv0`` (4 B each), S u-taps and S v-taps, Sw w-taps
    (f32) and the re/im visibility (8 B). The same in every precision
    mode: the kernels split or round the operands in registers."""
    wplan = g.pplan.wplan
    return 8.0 + 4.0 * (2 * wplan.support + wplan.w_support) + 8.0


def _measure(step, finish, iters: int, n_meas: int = 3):
    """Median + relative spread of ``n_meas`` timed loops.

    ``step()`` runs one iteration; ``finish()`` blocks until its
    output is ready. One extra leading loop warms up and is discarded.
    Returns (median_dt, spread) where spread = (max - min) / median
    over the measured loops.
    """
    dts = []
    for _m in range(n_meas + 1):
        t0 = time.perf_counter()
        for _i in range(iters):
            step()
        finish()
        dts.append((time.perf_counter() - t0) / iters)
    dts = sorted(dts[1:])
    med = dts[len(dts) // 2]
    return med, (dts[-1] - dts[0]) / med


def _device_fields() -> dict:
    """The device every output line names: JAX's view plus the card's
    name and power limit as nvidia-smi reports them."""
    d = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "card": card}


def _require_gpu():
    from ska_sdp_func_jax.utility.device import platform, \
        use_compile_cache

    name = platform()
    if name != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX runs on {name}")
    use_compile_cache(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".jax_cache"))


def _scenario(chans: int, rng):
    uvw = rng.uniform(-1, 1, (ROWS, 3))
    uvw[:, :2] *= 0.45 * IMAGE / 2 / THETA     # 3x3 sub-grid boxes
    uvw[:, 2] *= 1.5 * W_STEP * HEIGHT          # several w planes
    return uvw


def _smoke() -> dict:
    """One call of the packed grid and degrid at every precision mode
    and one streaming step, each checked finite; raises on any
    failure."""
    from ska_sdp_func_jax.kernels.packed_tap import PRECISIONS
    from ska_sdp_func_jax.parallel import (
        StreamingGridder,
        plan_stream,
        plan_wstack,
        stream_tasks,
    )
    from ska_sdp_func_jax.parallel.packed import (
        packed_gridder,
        plan_packed,
    )

    rng = np.random.default_rng(5)
    rows, chans, image, subgrid = 512, 4, 256, 128
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.4 * image / 2 / THETA
    uvw[:, 2] *= 1.2 * W_STEP * HEIGHT
    vis = (rng.standard_normal((rows, chans))
           + 1j * rng.standard_normal((rows, chans))
           ).astype(np.complex64)
    plan = plan_wstack(uvw, C_0, C_0 / (100 * chans), chans, image,
                       subgrid, THETA, W_STEP, support=8, w_support=4,
                       w_tower_height=HEIGHT)
    pplan = plan_packed(plan, uvw)
    passed = []

    def check(name, val):
        if not np.isfinite(float(val)):
            raise AssertionError(f"smoke {name}: non-finite result")
        passed.append(name)

    # Degrid a bounded point-source model, not a raw dirty image (the
    # 1/PSWF-corrected border of a dirty image is unbounded).
    model = jnp.zeros((image, image), jnp.float32).at[150, 100].set(1.0)
    for precision in PRECISIONS:
        gs = packed_gridder(pplan, precision=precision)
        check(f"grid[{precision}]",
              jnp.sum(jnp.abs(gs.grid(jnp.asarray(vis)))))
        check(f"degrid[{precision}]",
              jnp.sum(jnp.abs(gs.degrid_sorted(model))))

    sp = plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=rows,
                     block_v=64, cap_factor=40.0)
    sg = StreamingGridder(sp)
    sg.accumulate(uvw, vis)
    check("streaming_step", jnp.sum(jnp.abs(sg.finalize())))
    return {"smoke": "ok", "families": passed, **_device_fields()}


def main():
    from ska_sdp_func_jax.clean.hogbom import _minor_cycle
    from ska_sdp_func_jax.parallel import (
        StreamingGridder,
        plan_stream,
        plan_wstack,
        stream_tasks,
    )
    from ska_sdp_func_jax.parallel.packed import (
        packed_gridder,
        plan_packed,
    )
    from ska_sdp_func_jax.pipeline.major_cycle import (
        _norm_mask,
        make_psf_plan,
    )

    rng = np.random.default_rng(1)
    uvw = _scenario(CHANS, rng)
    freq0, dfreq = C_0, C_0 / (100 * CHANS)
    vis = (rng.standard_normal((ROWS, CHANS))
           + 1j * rng.standard_normal((ROWS, CHANS))).astype(np.complex64)
    num_vis = ROWS * CHANS

    plan = plan_wstack(uvw, freq0, dfreq, CHANS, IMAGE, SUBGRID, THETA,
                       W_STEP, support=8, w_support=4,
                       w_tower_height=HEIGHT)
    pplan = plan_packed(plan, uvw)
    g = packed_gridder(pplan)
    vre0, vim0 = g.sort(jnp.asarray(vis))
    iters = 50

    # ---- whole-image grid ------------------------------------------
    state = {"img": g.grid_sorted(vre0, vim0)}
    jax.block_until_ready(state["img"])

    def grid_step():
        state["img"] = g.grid_sorted(vre0, vim0)

    grid_dt, grid_spread = _measure(
        grid_step, lambda: jax.block_until_ready(state["img"]), iters)
    grid_mvis = num_vis / grid_dt / 1e6

    # ---- whole-image degrid ----------------------------------------
    model = jnp.zeros((IMAGE, IMAGE), jnp.float32).at[300, 200].set(1.0)
    dstate = {"vis": g.degrid_sorted(model)}
    jax.block_until_ready(dstate["vis"])

    def degrid_step():
        dstate["vis"] = g.degrid_sorted(model)

    degrid_dt, degrid_spread = _measure(
        degrid_step, lambda: jax.block_until_ready(dstate["vis"]), iters)
    degrid_mvis = num_vis / degrid_dt / 1e6

    # ---- major-cycle iteration rate --------------------------------
    psf_plan = make_psf_plan(plan, uvw)
    pg = packed_gridder(plan_packed(psf_plan, uvw))
    psf = pg.grid(jnp.ones((ROWS, CHANS), jnp.complex64))
    peak = psf[IMAGE, IMAGE]
    border = IMAGE // 16
    psf = _norm_mask(psf, peak, 2 * border)
    res_fn = jax.jit(lambda vre, vim, pred: (vre - pred.real,
                                             vim - pred.imag))
    upd = jax.jit(lambda m, d: m + d)
    stop = jnp.asarray(0.0, jnp.float32)

    def step(model):
        pred = g.degrid_sorted(model)
        rre, rim = res_fn(vre0, vim0, pred)
        dirty = _norm_mask(g.grid_sorted(rre, rim), peak, border)
        delta, _resid = _minor_cycle(dirty, psf, 0.1, stop, 50)
        return upd(model, delta)

    mstate = {"model": step(jnp.zeros((IMAGE, IMAGE), jnp.float32))}
    jax.block_until_ready(mstate["model"])

    def mc_step():
        mstate["model"] = step(mstate["model"])

    mc_dt, mc_spread = _measure(
        mc_step, lambda: jax.block_until_ready(mstate["model"]), 20)
    del pg, psf

    if os.environ.get("SKA_SDP_FUNC_JAX_BENCH_REPORT"):
        g.report_timing(vre0, vim0,
                        print_fn=lambda s: print(s, file=sys.stderr))
        g.report_timing_degrid(
            mstate["model"], print_fn=lambda s: print(s, file=sys.stderr))

    # ---- dense stream (4.2M vis) at the default and bf16 precisions -
    chans_d = 256
    vis_d = (rng.standard_normal((ROWS, chans_d))
             + 1j * rng.standard_normal((ROWS, chans_d))
             ).astype(np.complex64)
    nvis_d = ROWS * chans_d
    plan_d = plan_wstack(uvw, freq0, C_0 / (100 * chans_d), chans_d,
                         IMAGE, SUBGRID, THETA, W_STEP, support=8,
                         w_support=4, w_tower_height=HEIGHT)
    pplan_d = plan_packed(plan_d, uvw)
    dense = {}
    for label, precision in (("default", None), ("bf16", "bf16")):
        gd = packed_gridder(pplan_d, precision=precision)
        dre, dim = gd.sort(jnp.asarray(vis_d))
        out = {"img": gd.grid_sorted(dre, dim)}
        jax.block_until_ready(out["img"])

        def dense_step(gd=gd, dre=dre, dim=dim, out=out):
            out["img"] = gd.grid_sorted(dre, dim)

        dt, spread = _measure(
            dense_step, lambda out=out: jax.block_until_ready(out["img"]),
            20)
        dense[label] = (nvis_d / dt / 1e6, spread)
        del gd, dre, dim, out

    # ---- streaming ingest of the dense stream ----------------------
    # Same process, after the dense gridders are freed.
    from ska_sdp_func_jax.parallel.packed import _GRIDDER_CACHE

    _GRIDDER_CACHE.clear()
    gc.collect()
    sp = plan_stream(plan_d, stream_tasks(plan_d, uvw), chunk_rows=ROWS,
                     block_v=64, cap_factor=1.5)
    sg = StreamingGridder(sp)
    uvw32 = uvw.astype(np.float32)
    sg.accumulate(uvw32, vis_d)
    jax.block_until_ready(sg.image)

    def stream_step():
        sg.accumulate(uvw32, vis_d)

    stream_dt, stream_spread = _measure(
        stream_step, lambda: jax.block_until_ready(sg.image), 10)
    sg.finalize()                      # raises on dropped / voided
    stream_mvis = nvis_d / stream_dt / 1e6

    print(json.dumps({
        "metric": "gridding_throughput",
        "value": grid_mvis,
        "unit": "Mvis/s",
        "value_spread": grid_spread,
        "scenario": "whole-image 512^2, %d tasks, %d w-planes, %.2gM vis"
                    % (len(pplan.tasks), len(pplan.w_plane_ids),
                       num_vis / 1e6),
        "precision": g.precision,
        "degrid_mvis_s": degrid_mvis,
        "degrid_spread": degrid_spread,
        "major_cycle_iters_s": 1.0 / mc_dt,
        "major_cycle_spread": mc_spread,
        "dense_grid_mvis_s": dense["default"][0],
        "dense_spread": dense["default"][1],
        "dense_fast_grid_mvis_s": dense["bf16"][0],
        "dense_scenario": "whole-image 512^2, %.2gM vis, block %d"
                          % (nvis_d / 1e6, pplan_d.block_v),
        "stream_ingest_mvis_s": stream_mvis,
        "stream_spread": stream_spread,
        **_device_fields(),
    }))


if __name__ == "__main__":
    _require_gpu()
    if "--smoke" in sys.argv:
        print(json.dumps(_smoke()))
    else:
        main()
