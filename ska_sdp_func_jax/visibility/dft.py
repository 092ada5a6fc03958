"""Point-source direct-Fourier-transform visibility prediction.

Reference: visibility/sdp_dft.{h,cpp,cu}:

- v00 (`sdp_dft_point_v00`, sdp_dft.h:53-72): uvw already in wavelengths,
  per channel: ``uvw_lambda[time, baseline, chan, 3]``.
- v01 (`sdp_dft_point_v01`, sdp_dft.h:74-97): uvw in metres
  ``[time, baseline, 3]`` plus a channel frequency ramp.

Both: ``vis[t,b,c,p] = sum_comp flux[comp,c,p] *
exp(-2 pi i (l u + m v + n w))`` — OVERWRITING vis (the reference kernels
assign, not accumulate).

Design: the component sum is a matmul over sources — the phasor matrix
[t*b*c, comp] times the flux [comp, p].
"""

import jax
import jax.numpy as jnp

from ..utility.constants import C_0
from ..utility.data_model import check_uvw, check_vis
from ..utility.errors import SdpShapeError

Array = jax.Array


@jax.jit
def _dft_from_phase(phase: Array, fluxes: Array) -> Array:
    """phase [T,B,C,S] -> vis [T,B,C,P] = phasor @ flux, per channel."""
    phasor = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    # fluxes: [S, C, P] -> per channel matmul:
    # vis[t,b,c,p] = sum_s phasor[t,b,c,s] * fluxes[s,c,p]
    return jnp.einsum("tbcs,scp->tbcp", phasor.astype(fluxes.dtype), fluxes,
                      precision=jax.lax.Precision.HIGHEST)


def dft_point_v00(source_directions: Array, source_fluxes: Array,
                  uvw_lambda: Array) -> Array:
    """DFT prediction with uvw in wavelengths per channel.

    :param source_directions: ``[num_components, 3]`` (l, m, n-1) cosines.
    :param source_fluxes: ``complex[num_components, num_channels, num_pols]``.
    :param uvw_lambda: ``[num_times, num_baselines, num_channels, 3]``.
    :returns: ``complex[num_times, num_baselines, num_channels, num_pols]``.
    """
    source_directions = jnp.asarray(source_directions)
    source_fluxes = jnp.asarray(source_fluxes)
    uvw_lambda = jnp.asarray(uvw_lambda)
    if uvw_lambda.ndim != 4 or uvw_lambda.shape[-1] != 3:
        raise SdpShapeError("uvw_lambda must be [time, baseline, chan, 3]")
    if source_fluxes.ndim != 3:
        raise SdpShapeError("fluxes must be [component, channel, pol]")
    if source_fluxes.shape[2] not in (1, 4):
        raise SdpShapeError("num_pols must be 1 or 4")
    # HIGHEST: phases of thousands of radians need f32, not TF32.
    phase = -2.0 * jnp.pi * jnp.einsum(
        "tbck,sk->tbcs", uvw_lambda, source_directions, precision=jax.lax.Precision.HIGHEST)
    return _dft_from_phase(phase, source_fluxes)


def dft_point_v01(source_directions: Array, source_fluxes: Array,
                  uvw_metres: Array, channel_start_hz: float,
                  channel_step_hz: float, num_channels: int = None) -> Array:
    """DFT prediction with uvw in metres and a channel frequency ramp.

    :param source_directions: ``[num_components, 3]`` (l, m, n-1) cosines.
    :param source_fluxes: ``complex[num_components, num_channels, num_pols]``.
    :param uvw_metres: ``[num_times, num_baselines, 3]``.
    :returns: ``complex[num_times, num_baselines, num_channels, num_pols]``.
    """
    source_directions = jnp.asarray(source_directions)
    source_fluxes = jnp.asarray(source_fluxes)
    uvw_metres = jnp.asarray(uvw_metres)
    check_uvw(uvw_metres)
    if source_fluxes.ndim != 3:
        raise SdpShapeError("fluxes must be [component, channel, pol]")
    num_chan = source_fluxes.shape[1] if num_channels is None \
        else int(num_channels)
    fdtype = uvw_metres.dtype
    inv_wave = (channel_start_hz
                + channel_step_hz * jnp.arange(num_chan, dtype=fdtype)) / C_0
    dot = jnp.einsum("tbk,sk->tbs", uvw_metres, source_directions,
                     precision=jax.lax.Precision.HIGHEST)
    phase = -2.0 * jnp.pi * dot[:, :, None, :] \
        * inv_wave[None, None, :, None]
    return _dft_from_phase(phase, source_fluxes)
