"""Gridding/degridding as dense banded matmuls (plain XLA formulation).

The w-towers inner kernel applies a separable support x support x
w_support tap per (row, channel) (reference
grid_data/sdp_gridder_wtower_uvw.cpp:124-173 degrid, :429-481 grid;
CUDA twins use one thread per row + atomicAdd).

Observation: with `A_u[v, u] = uv_kernel[u_row_v, u - iu0_v]` (zero
outside the support band) and similarly `A_v`, the scatter of all
visibilities into one subgrid layer `l` is exactly

    subgrid_l += A_u^T @ diag(vis * w_kernel[w_row, l]) @ A_v

i.e. two dense [N, V] x [V, N] matmuls per layer instead of a
scatter. Degridding is the adjoint:

    vis_l = w_k_l * sum_v ( (A_u @ subgrid_l) * A_v )    (row-sum)

The banded matrices are built with `support` vectorized one-hot
compare-selects (no gather). All addressing matches the reference
exactly, so oracle tolerances hold in f64.
"""

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


def _band_matrix(i0: Array, taps: Array, size: int) -> Array:
    """A[v, u] = taps[v, u - i0[v]] for u in [i0, i0+S), else 0.

    Built with S compare-selects on a [V, size] iota — no gather/scatter.
    """
    num_v, support = taps.shape
    u_ids = jax.lax.broadcasted_iota(jnp.int32, (num_v, size), 1)
    band = jnp.zeros((num_v, size), taps.dtype)
    for s in range(support):
        band = band + jnp.where(u_ids == (i0[:, None] + s),
                                taps[:, s:s + 1],
                                jnp.zeros((), taps.dtype))
    return band


def _flatten_geom(geom, uv_kernel, w_kernel):
    """[R, C] geometry -> flat [V] arrays + gathered kernel rows."""
    mask, iu0, iv0, u_row, v_row, w_row = geom
    mask = mask.reshape(-1)
    iu0 = iu0.reshape(-1)
    iv0 = iv0.reshape(-1)
    uk = uv_kernel[u_row.reshape(-1)]      # [V, S]
    vk = uv_kernel[v_row.reshape(-1)]      # [V, S]
    wk = w_kernel[w_row.reshape(-1)]       # [V, Sw]
    return mask, iu0, iv0, uk, vk, wk


@partial(jax.jit, static_argnames=("support", "w_support"))
def grid_plane_dense(subgrids: Array, vis: Array, uv_kernel: Array,
                     w_kernel: Array, geom, support: int,
                     w_support: int) -> Array:
    """Scatter all (row, channel) taps of one w-plane into the subgrid
    stack via banded matmuls. Drop-in for the scatter formulation
    (adjoint of :func:`degrid_plane_dense`)."""
    size = subgrids.shape[-1]
    mask, iu0, iv0, uk, vk, wk = _flatten_geom(geom, uv_kernel, w_kernel)
    vis_flat = jnp.where(mask, vis.reshape(-1), jnp.zeros((), vis.dtype))

    a_u = _band_matrix(iu0, uk, size)                     # [V, N] real
    a_v = _band_matrix(iv0, vk, size)                     # [V, N] real
    wk = wk.astype(vis.dtype)

    out = []
    for layer in range(w_support):
        scaled = a_u.astype(vis.dtype) * (vis_flat * wk[:, layer])[:, None]
        # HIGHEST: a TF32 product keeps ~1e-3 relative error, far
        # above the accuracy budget.
        contrib = jnp.einsum("vu,vw->uw", scaled, a_v.astype(vis.dtype),
                             preferred_element_type=vis.dtype,
                             precision=jax.lax.Precision.HIGHEST)
        out.append(contrib)
    return subgrids + jnp.stack(out)


@partial(jax.jit, static_argnames=("support", "w_support"))
def degrid_plane_dense(subgrids: Array, uv_kernel: Array, w_kernel: Array,
                       geom, support: int, w_support: int) -> Array:
    """Gather one w-plane's visibilities from the subgrid stack via
    banded matmuls; returns [R, C] (masked lanes zero)."""
    mask, iu0, iv0, u_row, v_row, w_row = geom
    shape_rc = mask.shape
    size = subgrids.shape[-1]
    cdtype = subgrids.dtype
    mask_f, iu0_f, iv0_f, uk, vk, wk = _flatten_geom(
        geom, uv_kernel, w_kernel)

    a_u = _band_matrix(iu0_f, uk, size).astype(cdtype)    # [V, N]
    a_v = _band_matrix(iv0_f, vk, size).astype(cdtype)    # [V, N]

    acc = None
    for layer in range(w_support):
        t = jnp.einsum("vu,uw->vw", a_u, subgrids[layer],
                       preferred_element_type=cdtype,
                       precision=jax.lax.Precision.HIGHEST)  # [V, N]
        contrib = jnp.sum(t * a_v, axis=1)                # [V]
        term = wk[:, layer].astype(cdtype) * contrib
        acc = term if acc is None else acc + term
    acc = jnp.where(mask_f, acc, jnp.zeros((), cdtype))
    return acc.reshape(shape_rc)


# ---------------------------------------------------------------------------
# All-layer entry points (absolute w-layer formulation)
#
# A visibility belongs to exactly one w-slab j; its tap touches absolute
# layers k = j .. j+Sw-1 with weight w_kernel[w_row, k - j]. One pass
# covers the whole tower: grid accumulates [K, N, N] layers (drained by
# ONE batched iFFT + w_pattern power ladder outside), degrid samples from
# K pre-FFT'd layers.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("num_layers", "size"))
def grid_all_layers_dense(vis_re, vis_im, iu0, iv0, uk, vk, weights,
                          num_layers: int, size: int) -> Array:
    """All-layer gridding: flat taps -> [K, size, size] complex64.

    vis_re/vis_im/iu0/iv0: [V]; uk/vk: [V, S]; weights: [V, K]
    (w-kernel value of each vis for each absolute layer, zero outside
    its slab window).
    """
    del num_layers                                     # = weights.shape[1]
    a_u = _band_matrix(iu0, uk.astype(jnp.float32), size)     # [V, N]
    a_v = _band_matrix(iv0, vk.astype(jnp.float32), size)
    w = weights.astype(jnp.float32)
    out = [jnp.einsum("vu,vk,vw->kuw", a_u, w * x[:, None], a_v,
                      precision=jax.lax.Precision.HIGHEST)
           for x in (vis_re.astype(jnp.float32),
                     vis_im.astype(jnp.float32))]
    return jax.lax.complex(out[0], out[1])


@jax.jit
def degrid_all_layers_dense(layers: Array, iu0, iv0, uk, vk,
                            weights) -> Array:
    """All-layer degridding: [K, N, N] complex layers -> [V] complex64."""
    size = layers.shape[-1]
    a_u = _band_matrix(iu0, uk.astype(jnp.float32), size)
    a_v = _band_matrix(iv0, vk.astype(jnp.float32), size)
    w = weights.astype(jnp.float32)
    parts = []
    for plane in (layers.real, layers.imag):
        t = jnp.einsum("vu,kuw->vkw", a_u, plane.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)
        parts.append(jnp.einsum("vkw,vw,vk->v", t, a_v, w,
                                precision=jax.lax.Precision.HIGHEST))
    return jax.lax.complex(parts[0], parts[1])
