"""Phase rotation of uvw coordinates and visibilities to a new phase centre.

Reference: visibility/sdp_phase_rotate.{h,cpp,cu}:

- `sdp_phase_rotate_uvw` (sdp_phase_rotate.h:41-60): rotate uvw by
  -delta_ra about v then +delta_dec about u (matrix at
  sdp_phase_rotate.cpp:120-135).
- `sdp_phase_rotate_vis` (sdp_phase_rotate.h:62-84): multiply each
  visibility by ``exp(+2 pi i (u dl + v dm + w dn) f_c / c)`` where
  (dl, dm, dn) is the tangent-plane offset of the old centre from the new
  (sdp_phase_rotate.cpp:259-275).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..utility.constants import C_0
from ..utility.data_model import check_uvw, check_vis
from ..utility.sky_coord import SkyCoord

Array = jax.Array


def _rotation_matrix(orig: SkyCoord, new: SkyCoord) -> np.ndarray:
    d_a = -(new.ra - orig.ra)
    d_d = new.dec - orig.dec
    sin_d_a, cos_d_a = np.sin(d_a), np.cos(d_a)
    sin_d_d, cos_d_d = np.sin(d_d), np.cos(d_d)
    return np.array([
        [cos_d_a, 0.0, sin_d_a],
        [sin_d_a * sin_d_d, cos_d_d, -cos_d_a * sin_d_d],
        [-sin_d_a * cos_d_d, sin_d_d, cos_d_a * cos_d_d],
    ])


def phase_rotate_uvw(phase_centre_orig: SkyCoord, phase_centre_new: SkyCoord,
                     uvw_in: Array) -> Array:
    """Rotate ``[time, baseline, 3]`` uvw coordinates to a new centre."""
    uvw_in = jnp.asarray(uvw_in)
    check_uvw(uvw_in)
    matrix = jnp.asarray(
        _rotation_matrix(phase_centre_orig, phase_centre_new), uvw_in.dtype)
    # HIGHEST: rotated uvw feed phases; TF32 would keep ~3 digits.
    return jnp.einsum("ij,tbj->tbi", matrix, uvw_in, precision=jax.lax.Precision.HIGHEST)


def _delta_lmn(orig: SkyCoord, new: SkyCoord):
    d_a = -(new.ra - orig.ra)
    sin_d_a, cos_d_a = np.sin(d_a), np.cos(d_a)
    sin_dec0, cos_dec0 = np.sin(orig.dec), np.cos(orig.dec)
    sin_dec, cos_dec = np.sin(new.dec), np.cos(new.dec)
    l1 = cos_dec * -sin_d_a
    m1 = cos_dec0 * sin_dec - sin_dec0 * cos_dec * cos_d_a
    n1 = sin_dec0 * sin_dec + cos_dec0 * cos_dec * cos_d_a
    return -l1, -m1, 1.0 - n1


def phase_rotate_vis(phase_centre_orig: SkyCoord, phase_centre_new: SkyCoord,
                     channel_start_hz: float, channel_step_hz: float,
                     uvw: Array, vis_in: Array) -> Array:
    """Rotate visibilities ``[time, baseline, chan, pol]`` to a new centre.

    The uvw coordinates are those of the ORIGINAL phase centre (in metres).
    """
    uvw = jnp.asarray(uvw)
    vis_in = jnp.asarray(vis_in)
    check_uvw(uvw)
    check_vis(vis_in)
    delta_l, delta_m, delta_n = _delta_lmn(
        phase_centre_orig, phase_centre_new)
    fdtype = uvw.dtype
    num_chan = vis_in.shape[2]
    inv_wave = (channel_start_hz + channel_step_hz
                * jnp.arange(num_chan, dtype=fdtype)) / C_0
    dot = (uvw[..., 0] * delta_l + uvw[..., 1] * delta_m
           + uvw[..., 2] * delta_n)
    phase = 2.0 * jnp.pi * dot[:, :, None] * inv_wave[None, None, :]
    phasor = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    return vis_in * phasor[..., None].astype(vis_in.dtype)
