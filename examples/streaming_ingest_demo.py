"""Streaming whole-survey ingest demo: planning on the device.

Simulates an observation arriving in time chunks and grids it into a
dirty image WITHOUT any host planning in the loop:

  stream_tasks (one host pre-scan of the uvw metadata)
  -> plan_stream (static task geometry, once per observation)
  -> StreamingGridder.accumulate per chunk: the per-visibility plan —
     quantised geometry, bucket sort, padded placement, tap
     evaluation — runs inside the jitted chunk step on device
  -> finalize() checks the processed-visibility count invariant
  -> StreamingDegridder predicts model visibilities chunk by chunk
     (the selfcal/calibration direction)

Works on the CPU (the XLA formulations) and on an NVIDIA GPU:

  JAX_PLATFORMS=cpu python examples/streaming_ingest_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from ska_sdp_func_jax.parallel import (  # noqa: E402
    StreamingDegridder,
    StreamingGridder,
    plan_stream,
    plan_wstack,
    stream_tasks,
)
from ska_sdp_func_jax.parallel.wstack import degrid_all_tasks  # noqa: E402

C_0 = 299792458.0
IMAGE, SUBGRID, THETA = 256, 128, 0.002
ROWS, CHANS, CHUNK_ROWS = 384, 2, 128


def main():
    rng = np.random.default_rng(8)
    uvw = rng.uniform(-1, 1, (ROWS, 3))
    uvw[:, :2] *= 0.3 * IMAGE / 2 / THETA
    uvw[:, 2] *= 200.0

    # Sky: two point sources; exact prediction through the oracle
    # task driver (reference-faithful conventions).
    sky = np.zeros((IMAGE, IMAGE), np.float32)
    sky[100, 120], sky[170, 90] = 1.0, 0.6
    plan = plan_wstack(uvw, C_0, C_0 / 100, CHANS, IMAGE, SUBGRID,
                       THETA, 50.0, support=8, w_support=4,
                       w_tower_height=4.0)
    st = jnp.zeros((ROWS,), jnp.int32)
    en = jnp.full((ROWS,), CHANS, jnp.int32)
    vis = np.asarray(degrid_all_tasks(
        plan, plan.kernel(), jnp.asarray(sky, jnp.complex64),
        jnp.asarray(uvw), st, en, jnp.complex64))

    boxes = stream_tasks(plan, uvw)        # host pre-scan, once
    sp = plan_stream(plan, boxes, chunk_rows=CHUNK_ROWS, block_v=128,
                     cap_slots=40960)
    print(f"stream: {len(sp.tasks)} task boxes, {sp.num_buckets} "
          f"buckets, capacity {sp.cap} slots")

    # Dirty image + PSF (unit visibilities) in the same chunked pass
    # structure; PSF peak normalises the dirty image.
    sg = StreamingGridder(sp)
    sg_psf = StreamingGridder(sp)
    for lo in range(0, ROWS, CHUNK_ROWS):
        hi = min(ROWS, lo + CHUNK_ROWS)
        sg.accumulate(uvw[lo:hi], vis[lo:hi])
        sg_psf.accumulate(uvw[lo:hi], np.ones_like(vis[lo:hi]))
        print(f"  chunk rows [{lo}, {hi}) accumulated")
    image = np.asarray(sg.finalize())      # raises if any vis dropped
    psf = np.asarray(sg_psf.finalize())
    image = image / psf[IMAGE // 2, IMAGE // 2]
    p, d, v = (int(x) for x in sg.counters())
    print(f"gridded {p} visibilities (dropped {d}, voided chunks {v})")
    for (px, py), f in (((100, 120), 1.0), ((170, 90), 0.6)):
        print(f"  source at ({px},{py}) flux {f}: dirty peak "
              f"{image[px, py]:.4f}")

    # Predict direction (model -> visibilities), chunk by chunk.
    sd = StreamingDegridder(sp).set_model(sky)
    pred = np.concatenate([
        np.asarray(sd.predict(uvw[lo:min(ROWS, lo + CHUNK_ROWS)]))
        for lo in range(0, ROWS, CHUNK_ROWS)])
    sd.check()
    err = np.abs(pred - vis).max() / np.abs(vis).max()
    print(f"predicted visibilities vs oracle degridder: max rel err "
          f"{err:.2e}")


if __name__ == "__main__":
    main()
