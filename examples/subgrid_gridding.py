"""Plan-based subgrid (de)gridding — the framework's create/exec pattern.

The analogue of the reference's plan-template example
(examples/sdp_function_example_a.cpp: create -> exec -> free) for the
flagship w-towers gridder: build a plan once, run jitted grid/degrid
against it, check the adjoint identity.

    JAX_PLATFORMS=cpu python examples/subgrid_gridding.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from ska_sdp_func_jax.grid_data import GridderWtowerUVW

C_0 = 299792458.0


def main():
    rng = np.random.default_rng(0)
    subgrid_size, num_rows, num_chan = 64, 256, 4
    theta, w_step = 0.002, 100.0
    freq0, dfreq = C_0, C_0 / (100 * num_chan)

    # Plan: oversampled PSWF uv/w kernels + w_pattern, computed once.
    plan = GridderWtowerUVW(subgrid_size, subgrid_size, theta, w_step,
                            0.0, 0.0, support=8, oversampling=16384,
                            w_support=4, w_oversampling=16384)

    uvw = rng.uniform(-1, 1, (num_rows, 3)).astype(np.float32)
    uvw[:, :2] *= 0.4 * subgrid_size / 2 / theta
    uvw[:, 2] *= 1.5 * w_step
    uvw_d = jnp.asarray(uvw)
    start = jnp.zeros((num_rows,), jnp.int32)
    end = jnp.full((num_rows,), num_chan, jnp.int32)

    # Forward: image -> visibilities.
    image = jnp.asarray((rng.standard_normal((subgrid_size, subgrid_size))
                        + 1j * rng.standard_normal(
                            (subgrid_size, subgrid_size))
                        ).astype(np.complex64))
    vis = plan.degrid_subgrid(image, (0, 0, 0), num_chan, freq0, dfreq,
                              uvw_d, start, end)

    # Adjoint: visibilities -> image.
    y = jnp.asarray((rng.standard_normal((num_rows, num_chan))
                    + 1j * rng.standard_normal((num_rows, num_chan))
                    ).astype(np.complex64))
    img_adj = plan.grid_subgrid(
        y, uvw_d, start, end, num_chan, freq0, dfreq,
        jnp.asarray(np.zeros((subgrid_size, subgrid_size), np.complex64)),
        (0, 0, 0))

    # <y, A x> == <A^T y, x>
    lhs = np.vdot(np.asarray(jnp.real(y)) + 1j * np.asarray(jnp.imag(y)),
                  np.asarray(jnp.real(vis)) + 1j * np.asarray(jnp.imag(vis)))
    rhs = np.vdot(
        np.asarray(jnp.real(img_adj)) + 1j * np.asarray(jnp.imag(img_adj)),
        np.asarray(jnp.real(image)) + 1j * np.asarray(jnp.imag(image)))
    print(f"adjointness: <y, Ax> = {lhs:.6f}  <A^T y, x> = {rhs:.6f}  "
          f"rel = {abs(lhs - rhs) / abs(lhs):.2e}")
    print(f"w-planes processed (degrid, grid): "
          f"{plan.num_w_planes(0)}, {plan.num_w_planes(1)}")


if __name__ == "__main__":
    main()
