"""End-to-end imaging demo: simulate -> plan -> solve -> restore.

Run on any backend:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/imaging_demo.py

This is the framework analogue of the reference's CLEAN integration test
pipeline (tests/clean/test_hogbom_clean.py:18-140: DFT predict ->
gridder -> dirty image -> CLEAN), with the gridding/solving distributed
over a device mesh.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from ska_sdp_func_jax.grid_data import dft, image_to_flmn
from ska_sdp_func_jax.parallel import make_mesh, plan_wstack
from ska_sdp_func_jax.pipeline import major_cycle_imager, save_result

C_0 = 299792458.0


def main():
    rng = np.random.default_rng(1)
    image_size, num_rows, num_chan = 128, 600, 2
    theta = 0.002

    # Sky: three point sources.
    sky = np.zeros((image_size, image_size))
    sky[image_size // 2 + 12, image_size // 2 - 9] = 1.0
    sky[image_size // 2 - 20, image_size // 2 + 15] = 0.4
    sky[image_size // 2 + 30, image_size // 2 + 28] = 0.2

    # Array: random snapshot uvw coverage.
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * image_size / 2 / theta
    uvw[:, 2] *= 300.0
    freq0, dfreq = C_0, C_0 / 100

    # Exact visibilities (the accuracy oracle).
    flux, lmn = image_to_flmn(jnp.asarray(sky), theta)
    vis = dft(jnp.asarray(uvw), jnp.asarray(flux, complex),
              jnp.asarray(lmn), freq0_hz=freq0, dfreq_hz=dfreq,
              num_chan=num_chan)

    # Static task plan (native host runtime) + device mesh.
    plan = plan_wstack(uvw, freq0, dfreq, num_chan, image_size,
                       subgrid_size=32, theta=theta, w_step=50.0,
                       support=8, oversampling=16384, w_support=4,
                       w_oversampling=16384, w_tower_height=4.0)
    mesh = make_mesh()  # all available devices
    print(f"devices: {mesh.devices.size}, tasks: {len(plan.tasks)}, "
          f"w-planes: {plan.w_plane_ids}")

    result = major_cycle_imager(plan, vis, jnp.asarray(uvw), n_major=5,
                                loop_gain=0.2, threshold=1e-3,
                                cycle_limit=300, mesh=mesh)
    model = np.asarray(result.model)
    print("residual peak per major cycle:",
          [f"{p:.4f}" for p in result.peak_history])
    print("recovered fluxes:",
          model[image_size // 2 + 10:image_size // 2 + 15,
                image_size // 2 - 11:image_size // 2 - 6].sum(),
          model[image_size // 2 - 22:image_size // 2 - 17,
                image_size // 2 + 13:image_size // 2 + 18].sum(),
          model[image_size // 2 + 28:image_size // 2 + 33,
                image_size // 2 + 26:image_size // 2 + 31].sum())
    save_result("/tmp/ska_sdp_func_jax_demo_result.npz", result)
    print("saved /tmp/ska_sdp_func_jax_demo_result.npz")


if __name__ == "__main__":
    main()
