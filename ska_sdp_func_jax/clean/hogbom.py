"""Hogbom CLEAN.

Reference: clean/sdp_hogbom_clean.{h,cpp,cu}. Minor cycle: find the peak of
the residual, record ``loop_gain * peak`` as a component, subtract the
shifted scaled PSF, repeat until threshold or cycle limit; then convolve
the component model with an elliptical-Gaussian clean beam (FFT
convolution) and add the residual (sdp_hogbom_clean.cpp:113-280).

Design: the reference's GPU path crosses the device boundary on
every minor-cycle iteration (one kernel launch per step; SURVEY.md §3.3).
Here the whole minor cycle is a `jax.lax.while_loop` that stays on the device:
argmax -> dynamic-slice PSF subtract, compiled once, no host round-trips.
"""

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..numeric_functions.fft_convolution import fft_convolution
from ..utility.errors import SdpShapeError

Array = jax.Array


@partial(jax.jit, static_argnames=("size",))
def _create_cbeam(cbeam_details: Array, size: int) -> Array:
    """Elliptical Gaussian clean beam (sdp_create_cbeam,
    sdp_hogbom_clean.cpp:33-80): details = [bmaj, bmin, theta_deg, _]."""
    sigma_x = cbeam_details[0]
    sigma_y = cbeam_details[1]
    theta = (jnp.pi / 180.0) * cbeam_details[2]
    a = (jnp.cos(theta) ** 2 / (2 * sigma_x ** 2)
         + jnp.sin(theta) ** 2 / (2 * sigma_y ** 2))
    b = (jnp.sin(2 * theta) / (4 * sigma_x ** 2)
         - jnp.sin(2 * theta) / (4 * sigma_y ** 2))
    c = (jnp.sin(theta) ** 2 / (2 * sigma_x ** 2)
         + jnp.cos(theta) ** 2 / (2 * sigma_y ** 2))
    x0 = size // 2
    x = jnp.arange(size, dtype=cbeam_details.dtype) - x0
    xx, yy = jnp.meshgrid(x, x, indexing="ij")
    return jnp.exp(-(a * xx ** 2 + 2 * b * xx * yy + c * yy ** 2))


def create_cbeam(cbeam_details, size: int) -> Array:
    """Public clean-beam constructor; returns a real [size, size] beam.

    ``cbeam_details`` must hold [bmaj, bmin, theta_deg, size] — the
    reference's 4-element contract (sdp_hogbom_clean.cpp:33-80).
    """
    cbeam_details = jnp.asarray(cbeam_details)
    if cbeam_details.ndim != 1 or cbeam_details.shape[0] < 3:
        raise SdpShapeError(
            "create_cbeam: cbeam_details must be a vector "
            f"[bmaj, bmin, theta_deg, ...]; got {cbeam_details.shape}")
    return _create_cbeam(cbeam_details, int(size))


@partial(jax.jit, static_argnames=("cycle_limit",))
def _minor_cycle(dirty: Array, psf: Array, loop_gain, threshold,
                 cycle_limit: int) -> Tuple[Array, Array]:
    """On-chip Hogbom minor cycle; returns (clean_model, residual)."""
    size = dirty.shape[0]
    loop_gain = jnp.asarray(loop_gain, dirty.dtype)
    threshold = jnp.asarray(threshold, dirty.dtype)

    def cond(state):
        residual, _, cycle = state
        return jnp.logical_and(cycle < cycle_limit,
                               jnp.max(residual) >= threshold)

    def body(state):
        residual, model, cycle = state
        flat_idx = jnp.argmax(residual)
        peak = residual.reshape(-1)[flat_idx]
        x = flat_idx // size
        y = flat_idx % size
        model = model.reshape(-1).at[flat_idx].add(
            loop_gain * peak).reshape(size, size)
        # PSF window: psf[N - x : 2N - x, N - y : 2N - y] of the 2N PSF
        # (sdp_hogbom_clean.cpp:217-240).
        window = jax.lax.dynamic_slice(psf, (size - x, size - y),
                                       (size, size))
        residual = residual - loop_gain * peak * window
        return residual, model, cycle + 1

    model = jnp.zeros_like(dirty)
    residual, model, _ = jax.lax.while_loop(
        cond, body, (dirty, model, jnp.asarray(0, jnp.int32)))
    return model, residual


def hogbom_clean(dirty_img: Array, psf: Array, cbeam_details,
                 loop_gain: float, threshold: float,
                 cycle_limit: int) -> Tuple[Array, Array, Array]:
    """Run Hogbom CLEAN; returns ``(clean_model, residual, skymodel)``.

    Equivalent of `sdp_hogbom_clean` (sdp_hogbom_clean.h:36-47) with the
    outputs returned instead of written in place. ``cbeam_details`` is
    ``[bmaj, bmin, theta_deg, size]`` (size is host-read to fix shapes).
    """
    dirty_img = jnp.asarray(dirty_img)
    psf = jnp.asarray(psf)
    if dirty_img.ndim != 2:
        raise SdpShapeError("dirty image must be 2D")
    if psf.shape[0] < 2 * dirty_img.shape[0]:
        raise SdpShapeError(
            f"psf (size {psf.shape[0]}) must be at least twice the dirty "
            f"image size ({dirty_img.shape[0]})")
    details = np.asarray(cbeam_details, dtype=np.float64)
    cbeam_size = int(details[3])
    model, residual = _minor_cycle(dirty_img, psf, float(loop_gain),
                                   float(threshold), int(cycle_limit))
    cbeam = create_cbeam(jnp.asarray(details, dirty_img.dtype), cbeam_size)
    convolved = fft_convolution(model.astype(
        jnp.result_type(model.dtype, jnp.complex64)), cbeam)
    skymodel = convolved.real.astype(dirty_img.dtype) + residual
    return model, residual, skymodel
