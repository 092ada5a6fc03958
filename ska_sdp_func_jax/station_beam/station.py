"""Aperture-array station beam: beamforming DFT over elements.

Reference: station_beam/sdp_station.{h,cpp,cu}:

    beam[p] = norm * sum_i w_i * exp(i k (x_i px + y_i py + z_i pz))
                  * element_response_i(p)

with optional per-element beam data indexed by element type
(`sdp_station_beam_aperture_array`, sdp_station.h:121-140; kernel
sdp_station.cu:9-170). Scalar (1-pol) or fully polarised (4-pol,
Jones 2x2 flattened) outputs.

Design: the element sum is expressed as an einsum so XLA maps it onto
a matrix product (phasor matrix [points, elements] x weights/data), replacing the
reference's shared-memory chunked CUDA loop.
"""

from typing import Optional

import jax
import jax.numpy as jnp

from ..utility.errors import SdpDataTypeError, SdpShapeError

Array = jax.Array


def aperture_array(wavenumber: float, element_weights: Array,
                   element_x: Array, element_y: Array, element_z: Array,
                   point_x: Array, point_y: Array,
                   point_z: Optional[Array] = None,
                   element_beam_index: Optional[Array] = None,
                   element_beam: Optional[Array] = None,
                   normalise: bool = True, eval_x: bool = True,
                   eval_y: bool = True, num_pols: int = 1) -> Array:
    """Evaluate a station beam by direct Fourier transform over elements.

    :param wavenumber: 2 pi / lambda.
    :param element_weights: ``complex[num_elements]`` beamforming weights.
    :param element_x/y/z: ``float[num_elements]`` coordinates (metres).
    :param point_x/y/z: ``float[num_points]`` direction cosines
        (z may be None, treated as 0 — matching the reference).
    :param element_beam_index: optional ``int[num_elements]`` row index
        into ``element_beam`` (defaults to the element index).
    :param element_beam: optional ``complex[num_beams, num_points]``
        (scalar) or ``complex[num_beams, num_points, 4]`` (polarised)
        element responses.
    :param normalise: divide by the number of elements.
    :returns: ``complex[num_points]`` (scalar) or
        ``complex[num_points, 4]`` when the element beam is polarised.
    """
    element_weights = jnp.asarray(element_weights)
    if not jnp.issubdtype(element_weights.dtype, jnp.complexfloating):
        raise SdpDataTypeError("element_weights must be complex")
    ex = jnp.asarray(element_x)
    ey = jnp.asarray(element_y)
    ez = jnp.asarray(element_z)
    px = jnp.asarray(point_x)
    py = jnp.asarray(point_y)
    num_elements = ex.shape[0]
    fdtype = ex.dtype
    k = jnp.asarray(wavenumber, fdtype)
    # phase[p, i] = k * (px_p x_i + py_p y_i + pz_p z_i)
    phase = k * (px[:, None] * ex[None, :] + py[:, None] * ey[None, :])
    if point_z is not None:
        phase = phase + k * jnp.asarray(point_z)[:, None] * ez[None, :]
    phasor = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    weighted = phasor.astype(element_weights.dtype) \
        * element_weights[None, :]                       # [P, I]
    norm = (1.0 / num_elements) if normalise else 1.0

    if element_beam is None:
        out = jnp.sum(weighted, axis=1) * norm           # [P]
        if num_pols == 4:
            out = jnp.broadcast_to(out[:, None], out.shape + (4,))
            mask = jnp.asarray([eval_x, eval_x, eval_y, eval_y])
            return jnp.where(mask[None, :], out, jnp.zeros((), out.dtype))
        return out

    element_beam = jnp.asarray(element_beam)
    if not jnp.issubdtype(element_beam.dtype, jnp.complexfloating):
        raise SdpDataTypeError("element_beam must be complex")
    if element_beam_index is None:
        idx = jnp.arange(num_elements)
    else:
        idx = jnp.asarray(element_beam_index)
    responses = element_beam[idx]                        # [I, P(, 4)]
    if responses.ndim == 2:
        # Scalar element response (contraction over elements).
        return jnp.einsum("pi,ip->p", weighted, responses,
                          precision=jax.lax.Precision.HIGHEST) * norm
    if responses.ndim != 3 or responses.shape[-1] != 4:
        raise SdpShapeError(
            "element_beam must be [beams, points] or [beams, points, 4]")
    out = jnp.einsum("pi,ipk->pk", weighted, responses,
                     precision=jax.lax.Precision.HIGHEST) * norm
    mask = jnp.asarray([eval_x, eval_x, eval_y, eval_y])
    return jnp.where(mask[None, :], out, jnp.zeros((), out.dtype))
