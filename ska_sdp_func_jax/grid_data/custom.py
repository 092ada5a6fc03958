"""Legacy custom degridder from a 5-D grid with supplied kernels.

Reference: grid_data/sdp_degrid_uvw_custom.{h,cpp,cu}: degrids
``vis[time, baseline, chan, pol]`` from a grid
``[chan, w, v, u, pol]`` using caller-supplied oversampled uv and w
kernels, with the idiosyncratic coordinate snapping of
`calculate_coordinates` (sdp_degrid_uvw_custom.cpp:22-63): the fractional
kernel row is mirrored (``oversample - 1 - (i % oversample)``) and the w
coordinate is offset by one wstep.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..utility.constants import C_0
from ..utility.data_model import check_uvw, check_vis
from ..utility.errors import SdpShapeError

Array = jax.Array


@jax.jit
def _degrid_core(grid, uvw, uv_kernel, w_kernel, theta, wstep,
                 channel_start_hz, channel_step_hz, conjugate):
    num_chan, z_size, y_size, x_size, num_pols = grid.shape
    uv_k_size = uv_kernel.shape[-1]
    w_k_size = w_kernel.shape[-1]
    uv_os = uv_kernel.shape[0]
    w_os = w_kernel.shape[0]
    half_uv = uv_k_size // 2
    fdtype = uvw.dtype

    chan = jnp.arange(num_chan, dtype=fdtype)
    inv_wave = (channel_start_hz + chan * channel_step_hz) / C_0  # [C]
    # u,v,w per (time, baseline, chan)
    u = uvw[..., 0:1] * inv_wave
    v = uvw[..., 1:2] * inv_wave
    w = uvw[..., 2:3] * inv_wave

    def snap(coord, size, os):
        o = theta * coord * os
        i = jnp.round(o).astype(jnp.int32) + (size // 2 + 1) * os - 1
        home = i // os
        frac = os - 1 - jnp.mod(i, os)
        return home, frac

    home_x, frac_x = snap(u, x_size, uv_os)
    home_y, frac_y = snap(v, y_size, uv_os)
    oz = (1.0 + w / wstep) * w_os
    ioz = jnp.round(oz).astype(jnp.int32) + w_os - 1
    frac_z = w_os - 1 - jnp.mod(ioz, w_os)

    ok = ((home_x > half_uv) & (home_x < x_size - half_uv)
          & (home_y > half_uv) & (home_y < y_size - half_uv))
    hx = jnp.clip(home_x, half_uv, x_size - half_uv - 1)
    hy = jnp.clip(home_y, half_uv, y_size - half_uv - 1)

    ku = uv_kernel[frac_x]            # [T,B,C,ks]
    kv = uv_kernel[frac_y]            # [T,B,C,ks]
    kw = w_kernel[frac_z]             # [T,B,C,kw]

    ix = hx[..., None] + jnp.arange(uv_k_size) - half_uv   # [T,B,C,ks]
    iy = hy[..., None] + jnp.arange(uv_k_size) - half_uv

    # taps[t,b,c,z,ky,kx,p] = grid[c, z, iy[t,b,c,ky], ix[t,b,c,kx], p]
    c_b = jnp.arange(num_chan)[None, None, :, None, None, None]
    z_b = jnp.arange(z_size)[None, None, None, :, None, None]
    iy_b = iy[:, :, :, None, :, None]
    ix_b = ix[:, :, :, None, None, :]
    taps = grid[c_b, z_b, iy_b, ix_b]
    vis = jnp.einsum("tbcz,tbcy,tbcx,tbczyxp->tbcp",
                     kw.astype(grid.dtype), kv.astype(grid.dtype),
                     ku.astype(grid.dtype), taps,
                     precision=jax.lax.Precision.HIGHEST)
    vis = jnp.where(ok[..., None], vis, jnp.zeros((), vis.dtype))
    return jnp.where(conjugate, jnp.conj(vis), vis)


def degrid_uvw_custom(grid: Array, uvw: Array, uv_kernel: Array,
                      w_kernel: Array, theta: float, wstep: float,
                      channel_start_hz: float, channel_step_hz: float,
                      conjugate: bool = False) -> Array:
    """Degrid visibilities from a 5-D grid with custom kernels.

    Equivalent of `sdp_degrid_uvw_custom` (sdp_degrid_uvw_custom.h:15-44).

    :param grid: ``complex[chan, w, v, u, pol]``.
    :param uvw: ``float[time, baseline, 3]`` in metres.
    :param uv_kernel: ``float[oversampling, support]`` (flat also accepted).
    :param w_kernel: ``float[w_oversampling, w_support]``.
    :returns: ``complex[time, baseline, chan, pol]``.
    """
    grid = jnp.asarray(grid)
    uvw = jnp.asarray(uvw)
    check_uvw(uvw)
    if grid.ndim != 5:
        raise SdpShapeError("grid must be 5D [chan, w, v, u, pol]")
    uv_kernel = jnp.asarray(uv_kernel)
    w_kernel = jnp.asarray(w_kernel)
    if uv_kernel.ndim != 2 or w_kernel.ndim != 2:
        raise SdpShapeError(
            "kernels must be 2D [oversampling, support]")
    return _degrid_core(grid, uvw, uv_kernel, w_kernel, float(theta),
                        float(wstep), float(channel_start_hz),
                        float(channel_step_hz), bool(conjugate))
