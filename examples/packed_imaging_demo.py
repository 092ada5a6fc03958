"""Packed whole-image imaging demo.

Runs the performance ingest path end to end on synthetic data:

  plan_wstack -> plan_packed (host bucket sort + tap tables)
  -> PackedGridder (device taps built once)
  -> sorted-stream major-cycle iterations (degrid -> residual -> grid
     -> on-device Hogbom minor cycle)
  -> per-stage device-time report

Works on the CPU (the XLA formulations) and on an NVIDIA GPU (the
compiled kernels). On the CPU:

  JAX_PLATFORMS=cpu python examples/packed_imaging_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from ska_sdp_func_jax.clean.hogbom import _minor_cycle
from ska_sdp_func_jax.parallel import plan_wstack
from ska_sdp_func_jax.parallel.packed import packed_gridder, plan_packed
from ska_sdp_func_jax.parallel.wstack import degrid_all_tasks
from ska_sdp_func_jax.pipeline.major_cycle import (
    _norm_mask,
    _stop_level,
    make_psf_plan,
)

C_0 = 299792458.0


def main():
    image_size, subgrid = 256, 128
    theta, w_step, height = 0.002, 100.0, 4.0
    rows, chans = 600, 4

    rng = np.random.default_rng(7)
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.35 * image_size / 2 / theta
    uvw[:, 2] *= 1.2 * w_step * height
    freq0, dfreq = C_0, C_0 / 100

    # Synthetic sky + exact prediction through the oracle task driver.
    sky = np.zeros((image_size, image_size))
    sources = [(100, 120, 1.0), (170, 90, 0.6)]
    for (i, j, f) in sources:
        sky[i, j] = f
    plan = plan_wstack(uvw, freq0, dfreq, chans, image_size, subgrid,
                       theta, w_step, support=8, w_support=4,
                       w_tower_height=height)
    st = jnp.zeros((rows,), jnp.int32)
    en = jnp.full((rows,), chans, jnp.int32)
    vis = degrid_all_tasks(plan, plan.kernel(),
                           jnp.asarray(sky, jnp.complex64),
                           jnp.asarray(uvw), st, en, jnp.complex64)

    # Packed ingest: one plan per uvw distribution.
    pplan = plan_packed(plan, uvw)
    print(f"packed plan: {len(pplan.tasks)} tasks, "
          f"{pplan.num_layers} tower layers, {pplan.num_buckets} "
          f"buckets, stream {pplan.total} "
          f"({pplan.total / vis.size:.2f}x padding)")
    gridder = packed_gridder(pplan)

    psf_pplan = plan_packed(make_psf_plan(plan, uvw), uvw)
    psf_gridder = packed_gridder(psf_pplan)
    psf = psf_gridder.grid(jnp.ones_like(vis))
    peak = psf[image_size, image_size]
    # Exclude the 1/PSWF-divergent border ring from the CLEAN window.
    border = image_size // 8
    psf = _norm_mask(psf, peak, 2 * border)

    vre, vim = gridder.sort(vis)
    model = jnp.zeros((image_size, image_size), jnp.float32)
    for cycle in range(4):
        pred = gridder.degrid_sorted(model)
        raw = gridder.grid_sorted(vre - pred.real, vim - pred.imag)
        dirty = _norm_mask(raw, peak, border)
        # mgain guard: stop each minor cycle above the sidelobe level
        # (over-cleaning sparse uv coverage diverges the major loop).
        stop = _stop_level(dirty, jnp.asarray(1e-3, jnp.float32),
                           jnp.asarray(0.8, jnp.float32))
        delta, resid = _minor_cycle(dirty, psf, 0.1, stop, 300)
        model = model + delta
        print(f"cycle {cycle}: residual peak "
              f"{float(jnp.max(jnp.abs(resid))):.2e}")

    for (i, j, f) in sources:
        got = float(model[i, j])
        print(f"source ({i},{j}) flux {f}: recovered {got:.4f}")

    print("\nPer-stage device time (one grid pass):")
    gridder.report_timing(vre, vim, iters=3)


if __name__ == "__main__":
    main()
