"""W-stacking drivers: whole image <-> full visibility set.

Reference: grid_data/sdp_grid_wstack_wtower.{h,cpp}. The image is
decomposed into w-stacking planes (spacing ``w_tower_height * w_step``)
and uv sub-grids (effective size ``floor(subgrid_size * subgrid_frac)``,
default fraction 2/3); visibilities are routed to (plane, sub-grid) boxes
by channel clamping, processed by the w-towers kernel, and reduced back
(grid side: sub-grid FFT + wrap-around add scaled by
``(image_size/subgrid_size)^2``; degrid side: cut-out + normalised iFFT).

Parallelism mapping: the reference self-schedules sub-grid x row-chunk
tasks over an OpenMP pool with a mutex queue and reduces into the shared
grid under `omp critical` (sdp_grid_wstack_wtower.cpp:140-165, 388-440,
672-690). Here each sub-grid task is one jitted XLA computation; the
multi-chip version (visibility shards + `psum` of partial grids) lives in
:mod:`ska_sdp_func_jax.parallel`.

The processed-visibility cross-check (reference :442-448, which calls
exit(1)!) is reproduced as a raised :class:`SdpRuntimeError`.
"""

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..fourier_transforms.fft import fft_shifted, ifft_shifted_norm
from ..utility.errors import SdpInvalidArgumentError, SdpRuntimeError
from ..utility.logging import log_info
from ..utility.timers import Timers
from .clamp_channels import clamp_channels_single, clamp_channels_uv
from .gridder_utils import subgrid_add, subgrid_cut_out, uvw_bounds_all
from .wtower import GridderWtowerUVW

Array = jax.Array


def _plane_and_subgrid_ranges(uvw, freq0_hz, dfreq_hz, start_ch, end_ch,
                              eff_sg_dist, w_stack_dist):
    """Sub-grid and w-plane index ranges (reference :316-330)."""
    eta = 1e-5
    uvw_min, uvw_max = uvw_bounds_all(uvw, freq0_hz, dfreq_hz,
                                      start_ch, end_ch)
    uvw_min = np.asarray(uvw_min)
    uvw_max = np.asarray(uvw_max)
    min_iu = int(math.floor(uvw_min[0] / eff_sg_dist + 0.5 - eta))
    max_iu = int(math.floor(uvw_max[0] / eff_sg_dist + 0.5 + eta))
    min_iv = int(math.floor(uvw_min[1] / eff_sg_dist + 0.5 - eta))
    max_iv = int(math.floor(uvw_max[1] / eff_sg_dist + 0.5 + eta))
    min_iw = int(math.floor(uvw_min[2] / w_stack_dist + 0.5 - eta))
    max_iw = int(math.floor(uvw_max[2] / w_stack_dist + 0.5 + eta))
    return (min_iu, max_iu, min_iv, max_iv, min_iw, max_iw)


def _check_args(vis, uvw, w_tower_height):
    if vis.ndim != 2 or uvw.ndim != 2:
        raise SdpInvalidArgumentError(
            "Visibilities and (u,v,w)-coordinates must be 2D")
    if w_tower_height == 0.0:
        raise SdpInvalidArgumentError(
            "Automatic w-tower height not yet implemented")


def _resolve_engine(engine: str, template, subgrid_size: int,
                    support: int, w_support: int,
                    subgrid_frac: float) -> str:
    """Pick the driver engine (see wstack_wtower_degrid_all docstring)."""
    if engine == "reference":
        return "reference"
    from ..parallel.packed import packed_geometry_ok

    compatible = packed_geometry_ok(subgrid_size, support, w_support,
                                    subgrid_frac)
    if engine == "packed":
        if not compatible:
            raise SdpInvalidArgumentError(
                "packed engine requires subgrid_size % 128 == 0, "
                "support <= 8, w_support <= 4 and "
                "eff_sg_size + support <= subgrid_size")
        return "packed"
    if engine == "auto":
        # dtype sniffed without materialising/transferring the array
        # (templates may be large host arrays).
        dt = getattr(template, "dtype", None)
        single = dt is not None and jnp.dtype(dt) in (
            jnp.dtype(jnp.complex64), jnp.dtype(jnp.float32))
        return "packed" if (compatible and single) else "reference"
    raise SdpInvalidArgumentError(f"unknown engine {engine!r}")


def _packed_plan(uvw, freq0_hz, dfreq_hz, num_chan, image_size,
                 subgrid_size, theta, w_step, shear_u, shear_v, support,
                 oversampling, w_support, w_oversampling, subgrid_frac,
                 w_tower_height):
    from ..parallel.packed import packed_gridder, plan_packed
    from ..parallel.wstack import plan_wstack

    plan = plan_wstack(
        np.asarray(uvw), freq0_hz, dfreq_hz, num_chan, image_size,
        subgrid_size, theta, w_step, shear_u, shear_v, support,
        oversampling, w_support, w_oversampling,
        subgrid_frac or (2.0 / 3.0), w_tower_height)
    return packed_gridder(plan_packed(plan, np.asarray(uvw)))


def _packed_grid_all(vis, freq0_hz, dfreq_hz, uvw, subgrid_size, theta,
                     w_step, shear_u, shear_v, support, oversampling,
                     w_support, w_oversampling, subgrid_frac,
                     w_tower_height, image):
    vis = jnp.asarray(vis)
    uvw_j = jnp.asarray(uvw)
    if image is None:
        raise SdpInvalidArgumentError("image template required")
    _check_args(vis, uvw_j, w_tower_height)
    template = jnp.asarray(image)
    gridder = _packed_plan(
        uvw, freq0_hz, dfreq_hz, vis.shape[1], int(template.shape[0]),
        subgrid_size, theta, w_step, shear_u, shear_v, support,
        oversampling, w_support, w_oversampling, subgrid_frac,
        w_tower_height)
    return gridder.grid(vis).astype(template.dtype)


def _packed_degrid_all(image, freq0_hz, dfreq_hz, uvw, subgrid_size,
                       theta, w_step, shear_u, shear_v, support,
                       oversampling, w_support, w_oversampling,
                       subgrid_frac, w_tower_height, vis):
    image = jnp.asarray(image)
    uvw_j = jnp.asarray(uvw)
    if vis is None:
        raise SdpInvalidArgumentError(
            "vis template required (shape [num_rows, num_chan])")
    vis_t = jnp.asarray(vis)
    _check_args(vis_t, uvw_j, w_tower_height)
    gridder = _packed_plan(
        uvw, freq0_hz, dfreq_hz, vis_t.shape[1], int(image.shape[0]),
        subgrid_size, theta, w_step, shear_u, shear_v, support,
        oversampling, w_support, w_oversampling, subgrid_frac,
        w_tower_height)
    return gridder.degrid(image.astype(jnp.complex64)) \
        .astype(vis_t.dtype)


def wstack_wtower_degrid_all(image: Array, freq0_hz: float, dfreq_hz: float,
                             uvw: Array, subgrid_size: int, theta: float,
                             w_step: float, shear_u: float, shear_v: float,
                             support: int, oversampling: int,
                             w_support: int, w_oversampling: int,
                             subgrid_frac: float, w_tower_height: float,
                             verbosity: int = 0,
                             vis: Optional[Array] = None,
                             num_threads: int = 0,
                             engine: str = "reference") -> Array:
    """Degrid a whole image into visibilities (forward operator).

    Equivalent of `sdp_grid_wstack_wtower_degrid_all`
    (sdp_grid_wstack_wtower.h:44-76). ``vis`` is required and provides
    only shape/dtype (the reference's output array, zeroed on entry).

    ``engine``: "reference" (default) runs the reference-faithful
    per-task oracle loop at the template precision; "packed" routes
    through the packed production path (one Pallas kernel pass over all
    tasks, f32 taps — ~2.5e-4 of image peak vs the f64 oracle) and
    raises SdpInvalidArgumentError on incompatible geometry
    (subgrid_size % 128, support > 8, w_support > 4); "auto" picks
    packed for single-precision templates when the geometry allows,
    else falls back to the reference loop.
    """
    eng = _resolve_engine(engine, vis, subgrid_size, support, w_support,
                          subgrid_frac)
    if eng == "packed":
        return _packed_degrid_all(
            image, freq0_hz, dfreq_hz, uvw, subgrid_size, theta, w_step,
            shear_u, shear_v, support, oversampling, w_support,
            w_oversampling, subgrid_frac, w_tower_height, vis)
    image = jnp.asarray(image)
    uvw = jnp.asarray(uvw)
    num_rows = uvw.shape[0]
    if vis is None:
        raise SdpInvalidArgumentError(
            "vis template required (shape [num_rows, num_chan])")
    vis = jnp.zeros_like(jnp.asarray(vis))
    _check_args(vis, uvw, w_tower_height)
    if subgrid_frac == 0.0:
        subgrid_frac = 2.0 / 3.0
    num_chan = vis.shape[1]
    image_size = image.shape[0]

    timers = Timers("Degridding")
    kernel = GridderWtowerUVW(image_size, subgrid_size, theta, w_step,
                              shear_u, shear_v, support, oversampling,
                              w_support, w_oversampling)

    start_ch = jnp.zeros((num_rows,), jnp.int32)
    end_ch = jnp.full((num_rows,), num_chan, jnp.int32)
    eff_sg_size = int(math.floor(subgrid_size * subgrid_frac))
    eff_sg_dist = eff_sg_size / theta
    w_stack_dist = w_tower_height * w_step

    (min_iu, max_iu, min_iv, max_iv, min_iw, max_iw) = \
        _plane_and_subgrid_ranges(uvw, freq0_hz, dfreq_hz, start_ch, end_ch,
                                  eff_sg_dist, w_stack_dist)
    if verbosity > 0:
        log_info("using %d w-planes and %d sub-grids",
                 1 + max_iw - min_iw,
                 (1 + max_iu - min_iu) * (1 + max_iv - min_iv))

    for iw in range(min_iw, max_iw + 1):
        min_w = iw * w_stack_dist - w_stack_dist / 2
        max_w = (iw + 1) * w_stack_dist - w_stack_dist / 2
        start_ch_w, end_ch_w = clamp_channels_single(
            uvw, 2, freq0_hz, dfreq_hz, start_ch, end_ch, min_w, max_w)
        num_vis = int(jnp.sum(end_ch_w - start_ch_w))
        if num_vis == 0:
            continue

        # Image correction / w-stacking, then FFT to the full grid.
        timers.push("Degrid correct")
        grid = kernel.degrid_correct(
            image.astype(vis.dtype), 0, 0, int(iw * w_tower_height))
        timers.pop_push("FFT(grid)")
        grid = fft_shifted(grid)
        timers.pop()

        vis_count_check = 0
        timers.push("Process sub-grid stack")
        for iu in range(min_iu, max_iu + 1):
            for iv in range(min_iv, max_iv + 1):
                min_u = iu * eff_sg_dist - eff_sg_dist / 2
                max_u = (iu + 1) * eff_sg_dist - eff_sg_dist / 2
                min_v = iv * eff_sg_dist - eff_sg_dist / 2
                max_v = (iv + 1) * eff_sg_dist - eff_sg_dist / 2
                s_uv, e_uv = clamp_channels_uv(
                    uvw, freq0_hz, dfreq_hz, start_ch_w, end_ch_w,
                    min_u, max_u, min_v, max_v)
                n_sub = int(jnp.sum(e_uv - s_uv))
                if n_sub == 0:
                    continue
                vis_count_check += n_sub
                subgrid = subgrid_cut_out(
                    grid, iu * eff_sg_size, iv * eff_sg_size, subgrid_size)
                subgrid = ifft_shifted_norm(subgrid)
                vis = kernel.degrid_subgrid(
                    subgrid, (iu * eff_sg_size, iv * eff_sg_size,
                              int(iw * w_tower_height)),
                    num_chan, freq0_hz, dfreq_hz, uvw, s_uv, e_uv, vis)
        timers.pop()
        if vis_count_check != num_vis:
            raise SdpRuntimeError(
                f"Processed {vis_count_check} but expected {num_vis} "
                f"visibilities")
    if verbosity > 0:
        timers.report(log_info)
    return vis


def wstack_wtower_grid_all(vis: Array, freq0_hz: float, dfreq_hz: float,
                           uvw: Array, subgrid_size: int, theta: float,
                           w_step: float, shear_u: float, shear_v: float,
                           support: int, oversampling: int, w_support: int,
                           w_oversampling: int, subgrid_frac: float,
                           w_tower_height: float, verbosity: int = 0,
                           image: Optional[Array] = None,
                           num_threads: int = 0,
                           engine: str = "reference") -> Array:
    """Grid all visibilities into a whole image (adjoint operator).

    Equivalent of `sdp_grid_wstack_wtower_grid_all`
    (sdp_grid_wstack_wtower.h:78-109). ``image`` provides shape/dtype
    (real or complex); the output is freshly accumulated (the reference
    zeroes it on entry).

    ``engine``: see :func:`wstack_wtower_degrid_all` — "reference"
    (default, oracle loop at template precision), "packed" (the f32
    packed production path), or "auto".
    """
    eng = _resolve_engine(engine, image, subgrid_size, support,
                          w_support, subgrid_frac)
    if eng == "packed":
        return _packed_grid_all(
            vis, freq0_hz, dfreq_hz, uvw, subgrid_size, theta, w_step,
            shear_u, shear_v, support, oversampling, w_support,
            w_oversampling, subgrid_frac, w_tower_height, image)
    vis = jnp.asarray(vis)
    uvw = jnp.asarray(uvw)
    if image is None:
        raise SdpInvalidArgumentError("image template required")
    image = jnp.zeros_like(jnp.asarray(image))
    _check_args(vis, uvw, w_tower_height)
    if subgrid_frac == 0.0:
        subgrid_frac = 2.0 / 3.0
    num_rows, num_chan = vis.shape
    image_size = image.shape[0]

    timers = Timers("Gridding")
    kernel = GridderWtowerUVW(image_size, subgrid_size, theta, w_step,
                              shear_u, shear_v, support, oversampling,
                              w_support, w_oversampling)

    start_ch = jnp.zeros((num_rows,), jnp.int32)
    end_ch = jnp.full((num_rows,), num_chan, jnp.int32)
    eff_sg_size = int(math.floor(subgrid_size * subgrid_frac))
    eff_sg_dist = eff_sg_size / theta
    w_stack_dist = w_tower_height * w_step
    sg_factor = (image_size / subgrid_size) ** 2

    (min_iu, max_iu, min_iv, max_iv, min_iw, max_iw) = \
        _plane_and_subgrid_ranges(uvw, freq0_hz, dfreq_hz, start_ch, end_ch,
                                  eff_sg_dist, w_stack_dist)
    if verbosity > 0:
        log_info("using %d w-planes and %d sub-grids",
                 1 + max_iw - min_iw,
                 (1 + max_iu - min_iu) * (1 + max_iv - min_iv))

    for iw in range(min_iw, max_iw + 1):
        min_w = iw * w_stack_dist - w_stack_dist / 2
        max_w = (iw + 1) * w_stack_dist - w_stack_dist / 2
        start_ch_w, end_ch_w = clamp_channels_single(
            uvw, 2, freq0_hz, dfreq_hz, start_ch, end_ch, min_w, max_w)
        num_vis = int(jnp.sum(end_ch_w - start_ch_w))
        if num_vis == 0:
            continue
        grid = jnp.zeros((image_size, image_size), vis.dtype)

        vis_count_check = 0
        timers.push("Process sub-grid stack")
        for iu in range(min_iu, max_iu + 1):
            for iv in range(min_iv, max_iv + 1):
                min_u = iu * eff_sg_dist - eff_sg_dist / 2
                max_u = (iu + 1) * eff_sg_dist - eff_sg_dist / 2
                min_v = iv * eff_sg_dist - eff_sg_dist / 2
                max_v = (iv + 1) * eff_sg_dist - eff_sg_dist / 2
                s_uv, e_uv = clamp_channels_uv(
                    uvw, freq0_hz, dfreq_hz, start_ch_w, end_ch_w,
                    min_u, max_u, min_v, max_v)
                n_sub = int(jnp.sum(e_uv - s_uv))
                if n_sub == 0:
                    continue
                vis_count_check += n_sub
                subgrid = kernel.grid_subgrid(
                    vis, uvw, s_uv, e_uv, num_chan, freq0_hz, dfreq_hz,
                    jnp.zeros((subgrid_size, subgrid_size), vis.dtype),
                    (iu * eff_sg_size, iv * eff_sg_size,
                     int(iw * w_tower_height)))
                subgrid = fft_shifted(subgrid)
                grid = subgrid_add(grid, -iu * eff_sg_size,
                                   -iv * eff_sg_size, subgrid, sg_factor)
        timers.pop()
        if vis_count_check != num_vis:
            raise SdpRuntimeError(
                f"Processed {vis_count_check} but expected {num_vis} "
                f"visibilities")

        # image += grid_correct(ifft(grid), 0, 0, iw * w_tower_height)
        timers.push("FFT(grid)")
        grid = ifft_shifted_norm(grid)
        timers.pop_push("Grid correct")
        grid = kernel.grid_correct(grid, 0, 0, int(iw * w_tower_height))
        timers.pop()
        if jnp.issubdtype(image.dtype, jnp.complexfloating):
            image = image + grid.astype(image.dtype)
        else:
            image = image + grid.real.astype(image.dtype)
    if verbosity > 0:
        timers.report(log_info)
    return image
