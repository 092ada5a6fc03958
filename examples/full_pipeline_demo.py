"""Full production pipeline: ingest -> weights -> bucketed solve.

BASELINE configs #4 + #5 end to end: simulate a sky + RFI, run the
fused flagging/weighting ingest, Briggs-weight, bucket-sort the
visibilities through the native host runtime, and solve with the
major-cycle imager (single-chip bucketed path; pass a mesh for the
sharded path).

    JAX_PLATFORMS=cpu python examples/full_pipeline_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from ska_sdp_func_jax.grid_data import dft, image_to_flmn
from ska_sdp_func_jax.parallel import plan_wstack
from ska_sdp_func_jax.pipeline import ingest_to_solver, major_cycle_imager
from ska_sdp_func_jax.visibility import briggs_weights, get_uv_range

C_0 = 299792458.0


def main():
    rng = np.random.default_rng(2)
    image_size, times, baselines, num_chan = 128, 16, 40, 2
    theta = 0.002
    num_rows = times * baselines

    sky = np.zeros((image_size, image_size))
    sky[image_size // 2 + 12, image_size // 2 - 9] = 1.0
    sky[image_size // 2 - 20, image_size // 2 + 15] = 0.4

    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * image_size / 2 / theta
    uvw[:, 2] *= 250.0
    freq0, dfreq = C_0, C_0 / 100

    flux, lmn = image_to_flmn(jnp.asarray(sky), theta)
    vis = np.asarray(dft(jnp.asarray(uvw), jnp.asarray(flux, complex),
                         jnp.asarray(lmn), freq0_hz=freq0, dfreq_hz=dfreq,
                         num_chan=num_chan))

    # Corrupt two samples with broadband RFI, then ingest.
    vis4d = vis.reshape(times, baselines, num_chan, 1).copy()
    # (The FluctuFlagger's recursive statistics need a few time samples
    # of history before a transient stands out — reference behaviour.)
    vis4d[9, 11, :, 0] += 120.0 - 80.0j
    vis4d[13, 33, :, 0] += -90.0 + 60.0j
    w4d = np.ones(vis4d.shape)
    vis_flat, w_flat, frac = ingest_to_solver(jnp.asarray(vis4d),
                                              jnp.asarray(w4d))
    print(f"ingest: flagged fraction {frac:.4f}")

    # Briggs robust weighting on the surviving samples.
    freqs = freq0 + dfreq * np.arange(num_chan)
    uvw4 = uvw.reshape(times, baselines, 3)
    max_uv = get_uv_range(jnp.asarray(uvw4), jnp.asarray(freqs))
    _, bw = briggs_weights(jnp.asarray(uvw4), jnp.asarray(freqs), max_uv,
                           0.5, jnp.asarray(w4d), 64)
    weights = np.asarray(bw)[..., 0].reshape(num_rows, num_chan) \
        * np.asarray(w_flat)

    plan = plan_wstack(uvw, freq0, dfreq, num_chan, image_size,
                       subgrid_size=32, theta=theta, w_step=50.0,
                       support=8, oversampling=16384, w_support=4,
                       w_oversampling=16384, w_tower_height=4.0)
    result = major_cycle_imager(
        plan, jnp.asarray(vis_flat, jnp.complex64),
        jnp.asarray(uvw, jnp.float32), n_major=4, loop_gain=0.2,
        threshold=1e-3, cycle_limit=300,
        weights=jnp.asarray(weights, jnp.float32), bucketed=True)

    model = np.asarray(result.model)
    y1, x1 = image_size // 2 + 12, image_size // 2 - 9
    y2, x2 = image_size // 2 - 20, image_size // 2 + 15
    print("residual history:", [f"{p:.4f}" for p in result.peak_history])
    print("recovered fluxes:",
          model[y1 - 2:y1 + 3, x1 - 2:x1 + 3].sum(),
          model[y2 - 2:y2 + 3, x2 - 2:x2 + 3].sum())


if __name__ == "__main__":
    main()
