"""W-towers sub-grid (de)gridder — the centrepiece of the framework.

Reference: grid_data/sdp_gridder_wtower_uvw.{h,cpp,cu}. The plan holds an
oversampled PSWF uv-kernel ``[oversampling+1, support]``, a w-kernel
``[w_oversampling+1, w_support]`` and the complex ``w_pattern`` (iDFT of a
unit visibility at (0, 0, w_step)) (sdp_gridder_wtower_uvw.cpp:660-723).

(De)gridding processes one sub-grid: per w-plane a rolling stack of
``w_support`` FFT'd sub-grid layers is maintained; stepping between planes
divides the running image by ``w_pattern`` and FFTs one new layer — one FFT
per plane instead of ``w_support`` (degrid loop :854-899; grid
accumulate/shift/clear :1023-1100). The inner kernel snaps each visibility
to an oversampled kernel offset and applies a separable
support x support x w_support tap (:124-173 degrid, :429-481 grid).

Design notes:
- The per-row OpenMP/CUDA loops become one fully vectorised computation
  over (rows, channels): kernel-row gathers + windowed sub-grid
  gathers/scatter-adds, inside `lax.scan` over w-planes (the rolling
  w-tower state stays on the device).
- The w-plane count is data-dependent in the reference; here it is computed
  host-side (like the reference does) and baked static per call so the
  scanned loop has static trip count. Use :func:`degrid_num_planes` /
  :func:`grid_num_planes` to pre-compute it when managing jit caches.
- All integer snapping matches the C exactly (round-half-away-from-zero,
  truncating integer division on non-negative values).
"""

import os
from functools import lru_cache as functools_lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fourier_transforms.fft import fft_shifted, ifft_shifted
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError
from .clamp_channels import clamp_channels_inline
from .grid_correct import grid_correct_pswf, grid_correct_w_stack
from .gridder_utils import shift_subgrids, uvw_bounds_all
from .kernels import make_pswf_kernel, make_w_pattern

Array = jax.Array

# Inner-tap implementation:
#   "dense"   — banded matmuls in XLA (kernels/dense_tap.py; any dtype)
#   "scatter" — XLA scatter/gather reference formulation
#   "auto"    — dense
TAP_IMPL = os.environ.get("SKA_SDP_FUNC_JAX_TAP_IMPL", "auto")


def _round_half_away(x: Array) -> Array:
    """Match C round(): halves away from zero (jnp.round is half-to-even)."""
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))


def _complex_dtype(dtype):
    return jnp.result_type(dtype, jnp.complex64)


class GridderWtowerUVW:
    """Plan for w-towers / w-stacking uvw (de)gridding.

    Mirrors `sdp_gridder_wtower_uvw_create`
    (sdp_gridder_wtower_uvw.h:59-100): precomputes the oversampled PSWF
    uv/w kernels and the w-pattern. All parameters are exposed as read-only
    attributes (reference accessors :1171-1228).
    """

    def __init__(self, image_size: int, subgrid_size: int, theta: float,
                 w_step: float, shear_u: float, shear_v: float,
                 support: int, oversampling: int, w_support: int,
                 w_oversampling: int):
        if subgrid_size % 2 != 0:
            # If subgrid_size isn't even the FFT shift won't be correct
            # (sdp_gridder_wtower_uvw.cpp:674-682).
            raise SdpInvalidArgumentError(
                f"Subgrid size must be even (value given was {subgrid_size})."
            )
        self.image_size = int(image_size)
        self.subgrid_size = int(subgrid_size)
        self.theta = float(theta)
        self.w_step = float(w_step)
        self.shear_u = float(shear_u)
        self.shear_v = float(shear_v)
        self.support = int(support)
        self.oversampling = int(oversampling)
        self.w_support = int(w_support)
        self.w_oversampling = int(w_oversampling)
        self._num_w_planes = [0, 0]  # [degridding, gridding] counters

        # Oversampled convolution kernels, kept as host numpy (float64):
        # under jit they embed as trace-time constants without any
        # device round-trip.
        self.uv_kernel = np.ascontiguousarray(
            make_pswf_kernel(self.support, self.support, self.oversampling))
        self.w_kernel = np.ascontiguousarray(
            make_pswf_kernel(self.w_support, self.w_support,
                             self.w_oversampling))
        # w_pattern: iDFT of a sole visibility at (0, 0, w_step).
        self.w_pattern = np.ascontiguousarray(
            make_w_pattern(self.subgrid_size, self.theta, self.shear_u,
                           self.shear_v, self.w_step))
        self._w_pattern_dev = None

    @property
    def w_pattern_device(self):
        """Cached on-device w_pattern."""
        if self._w_pattern_dev is None:
            self._w_pattern_dev = jnp.asarray(self.w_pattern)
        return self._w_pattern_dev

    # -- plan accessors ----------------------------------------------------
    def num_w_planes(self, gridding: int) -> int:
        """Processed w-plane counter (0: degridding, 1: gridding)."""
        if gridding in (0, 1):
            return self._num_w_planes[gridding]
        return 0

    # -- static geometry helpers -------------------------------------------
    def _w_plane_range(self, uvws, start_chs, end_chs, freq0_hz, dfreq_hz,
                       subgrid_offset_w: int) -> Tuple[int, int]:
        """Host computation of [first_w_plane, last_w_plane] from the data
        bounds (sdp_gridder_wtower_uvw.cpp:780-800)."""
        uvw_min, uvw_max = uvw_bounds_all(
            jnp.asarray(uvws), freq0_hz, dfreq_hz,
            jnp.asarray(start_chs), jnp.asarray(end_chs))
        # Single device->host transfer for both bounds.
        bounds = np.asarray(jnp.stack([uvw_min[2], uvw_max[2]]))
        c_min, c_max = float(bounds[0]), float(bounds[1])
        eta = 1e-5
        if not np.isfinite(c_min) or not np.isfinite(c_max):
            # No selected visibilities: a single (empty) plane.
            return -subgrid_offset_w, 1 - subgrid_offset_w
        first = int(np.floor(c_min / self.w_step - eta)) - subgrid_offset_w
        last = int(np.ceil(c_max / self.w_step + eta)) - subgrid_offset_w + 1
        return first, last

    def degrid_num_planes(self, uvws, start_chs, end_chs, freq0_hz,
                          dfreq_hz, subgrid_offset_w: int = 0) -> int:
        first, last = self._w_plane_range(
            uvws, start_chs, end_chs, freq0_hz, dfreq_hz or 10.0,
            subgrid_offset_w)
        return 1 + last - first

    grid_num_planes = degrid_num_planes

    def _check_inputs(self, uvws, subgrid_image=None, vis=None,
                      vis_required: bool = False) -> None:
        """Input contracts of the (de)gridding entry points — the
        reference's sdp_mem_check_* discipline
        (sdp_gridder_wtower_uvw.cpp:743-770)."""
        from ..utility.errors import SdpDataTypeError, SdpShapeError

        if uvws.ndim != 2 or uvws.shape[-1] != 3:
            raise SdpShapeError(
                f"uvws must be [num_rows, 3]; got {uvws.shape}")
        if not jnp.issubdtype(uvws.dtype, jnp.floating):
            raise SdpDataTypeError(
                f"uvws must be real floating; got {uvws.dtype}")
        if subgrid_image is not None:
            shape = jnp.shape(subgrid_image)
            if shape != (self.subgrid_size, self.subgrid_size):
                raise SdpShapeError(
                    "subgrid image must be "
                    f"[{self.subgrid_size}, {self.subgrid_size}]; "
                    f"got {shape}")
        if vis_required and vis is not None and \
                not jnp.issubdtype(jnp.asarray(vis).dtype,
                                   jnp.complexfloating):
            raise SdpDataTypeError(
                f"vis must be complex; got {jnp.asarray(vis).dtype}")
        if vis is not None and jnp.asarray(vis).dtype == jnp.complex128 \
                and uvws.dtype == jnp.float32:
            # The reference's template set supports (cf64, f64),
            # (cf32, f64) and (cf32, f32) — cf64 vis over f32 uvw is
            # an expected failure (sdp_gridder_wtower_uvw.cpp:201-230):
            # f32 coordinates cannot place double-precision data.
            raise SdpDataTypeError(
                "complex128 vis with float32 uvws is unsupported "
                "(mixed-precision combos follow "
                "sdp_gridder_wtower_uvw.cpp:201-230)")

    # -- degrid -------------------------------------------------------------
    def degrid(self, subgrid_image: Array, subgrid_offset_u: int,
               subgrid_offset_v: int, subgrid_offset_w: int,
               freq0_hz: float, dfreq_hz: float, uvws: Array,
               start_chs: Array, end_chs: Array, vis: Array,
               start_row: int = -1, end_row: int = -1) -> Array:
        """Deprecated pre-1.2 signature (gridder_wtower_uvw.py:62-79);
        forwards to :meth:`degrid_subgrid`. Functional semantics:
        returns the visibilities instead of writing ``vis`` in place
        (jax arrays are immutable)."""
        return self.degrid_subgrid(
            subgrid_image,
            (subgrid_offset_u, subgrid_offset_v, subgrid_offset_w),
            jnp.asarray(vis).shape[1], freq0_hz, dfreq_hz, uvws,
            start_chs, end_chs, vis, start_row, end_row)

    def degrid_subgrid(self, subgrid_image: Array,
                       subgrid_offset: Tuple[int, int, int],
                       ch_count: int, freq0_hz: float, dfreq_hz: float,
                       uvws: Array, start_chs: Array, end_chs: Array,
                       vis: Optional[Array] = None,
                       start_row: int = -1, end_row: int = -1,
                       w_plane_range: Optional[Tuple[int, int]] = None
                       ) -> Array:
        """Degrid visibilities from one sub-grid image.

        Equivalent of `sdp_gridder_wtower_uvw_degrid`
        (sdp_gridder_wtower_uvw.cpp:726-909). Returns the visibilities
        (accumulated onto ``vis`` when given). ``w_plane_range`` (first,
        last) skips the per-call device->host bounds readback when the
        caller has already planned the tower (see plan_wstack).
        """
        if dfreq_hz == 0.0:
            dfreq_hz = 10.0  # Prevent divide-by-zero (reference :744).
        off_u, off_v, off_w = (int(o) for o in subgrid_offset)
        uvws = jnp.asarray(uvws)
        self._check_inputs(uvws, subgrid_image=subgrid_image, vis=vis)
        start_chs = jnp.asarray(start_chs)
        end_chs = jnp.asarray(end_chs)
        if vis is None:
            cdtype = _complex_dtype(uvws.dtype)
            vis = jnp.zeros((uvws.shape[0], ch_count), cdtype)
        num_rows = uvws.shape[0]
        if start_row < 0 or end_row < 0:
            start_row, end_row = 0, num_rows
        if w_plane_range is None:
            first, last = self._w_plane_range(
                uvws, start_chs, end_chs, freq0_hz, dfreq_hz, off_w)
        else:
            first, last = (int(w_plane_range[0]), int(w_plane_range[1]))
        num_planes = 1 + last - first
        self._num_w_planes[0] += num_planes
        w_pattern = self.w_pattern_device.astype(vis.dtype)
        subgrid_image = jnp.asarray(subgrid_image).astype(vis.dtype)
        rdt = np.dtype(jnp.real(vis).dtype)
        return _degrid_all_planes(
            subgrid_image, w_pattern,
            self.uv_kernel.astype(rdt),
            self.w_kernel.astype(rdt),
            uvws, start_chs, end_chs, vis,
            jnp.asarray(off_u), jnp.asarray(off_v), jnp.asarray(off_w),
            jnp.asarray(first),
            freq0_hz, dfreq_hz,
            num_planes, self.theta, self.w_step, self.support,
            self.oversampling, self.w_support, self.w_oversampling,
            self.subgrid_size, int(start_row), int(end_row))

    # -- grid ---------------------------------------------------------------
    def grid(self, vis: Array, uvw: Array, start_chs: Array,
             end_chs: Array, freq0_hz: float, dfreq_hz: float,
             subgrid_image: Array, subgrid_offset_u: int,
             subgrid_offset_v: int, subgrid_offset_w: int,
             start_row: int = -1, end_row: int = -1) -> Array:
        """Deprecated pre-1.2 signature (gridder_wtower_uvw.py:212-229);
        forwards to :meth:`grid_subgrid`. Functional semantics: returns
        ``subgrid_image + contribution`` instead of accumulating in
        place."""
        return self.grid_subgrid(
            vis, uvw, start_chs, end_chs, jnp.asarray(vis).shape[1],
            freq0_hz, dfreq_hz, subgrid_image,
            (subgrid_offset_u, subgrid_offset_v, subgrid_offset_w),
            start_row, end_row)

    def grid_subgrid(self, vis: Array, uvws: Array, start_chs: Array,
                     end_chs: Array, ch_count: int, freq0_hz: float,
                     dfreq_hz: float, subgrid_image: Array,
                     subgrid_offset: Tuple[int, int, int],
                     start_row: int = -1, end_row: int = -1,
                     w_plane_range: Optional[Tuple[int, int]] = None
                     ) -> Array:
        """Grid visibilities onto one sub-grid image (adjoint of degrid).

        Equivalent of `sdp_gridder_wtower_uvw_grid`
        (sdp_gridder_wtower_uvw.cpp:935-1123). Returns
        ``subgrid_image + contribution``.
        """
        if dfreq_hz == 0.0:
            dfreq_hz = 10.0
        if ch_count and vis.shape[1] != ch_count:
            raise SdpInvalidArgumentError("Inconsistent channel dimensions")
        off_u, off_v, off_w = (int(o) for o in subgrid_offset)
        vis = jnp.asarray(vis)
        uvws = jnp.asarray(uvws)
        self._check_inputs(uvws, subgrid_image=subgrid_image, vis=vis,
                           vis_required=True)
        start_chs = jnp.asarray(start_chs)
        end_chs = jnp.asarray(end_chs)
        num_rows = uvws.shape[0]
        if start_row < 0 or end_row < 0:
            start_row, end_row = 0, num_rows
        if w_plane_range is None:
            first, last = self._w_plane_range(
                uvws, start_chs, end_chs, freq0_hz, dfreq_hz, off_w)
        else:
            first, last = (int(w_plane_range[0]), int(w_plane_range[1]))
        num_planes = 1 + last - first
        self._num_w_planes[1] += num_planes
        subgrid_image = jnp.asarray(subgrid_image)
        # The running w image is always complex double in the reference
        # (sdp_gridder_wtower_uvw.cpp:1008); here: widest available complex.
        w_img_dtype = _complex_dtype(self.w_pattern_device.dtype)
        rdt = np.dtype(jnp.real(vis).dtype)
        return _grid_all_planes(
            vis, self.w_pattern_device.astype(w_img_dtype),
            self.uv_kernel.astype(rdt),
            self.w_kernel.astype(rdt),
            uvws, start_chs, end_chs, subgrid_image,
            jnp.asarray(off_u), jnp.asarray(off_v), jnp.asarray(off_w),
            jnp.asarray(first),
            freq0_hz, dfreq_hz,
            num_planes, self.theta, self.w_step, self.support,
            self.oversampling, self.w_support, self.w_oversampling,
            self.subgrid_size, int(start_row), int(end_row))

    # -- corrections ---------------------------------------------------------
    def degrid_correct(self, facet: Array, facet_offset_l: int = 0,
                       facet_offset_m: int = 0, w_offset: int = 0) -> Array:
        """Degrid correction (sdp_gridder_wtower_uvw_degrid_correct,
        sdp_gridder_wtower_uvw.cpp:912-932)."""
        facet = grid_correct_pswf(
            self.image_size, self.theta, self.w_step, self.shear_u,
            self.shear_v, self.support, self.w_support, facet,
            facet_offset_l, facet_offset_m)
        if jnp.issubdtype(facet.dtype, jnp.complexfloating):
            facet = grid_correct_w_stack(
                self.image_size, self.theta, self.w_step, self.shear_u,
                self.shear_v, facet, facet_offset_l, facet_offset_m,
                w_offset, inverse=False)
        return facet

    def grid_correct(self, facet: Array, facet_offset_l: int = 0,
                     facet_offset_m: int = 0, w_offset: int = 0) -> Array:
        """Grid correction (sdp_gridder_wtower_uvw_grid_correct,
        sdp_gridder_wtower_uvw.cpp:1126-1146)."""
        facet = grid_correct_pswf(
            self.image_size, self.theta, self.w_step, self.shear_u,
            self.shear_v, self.support, self.w_support, facet,
            facet_offset_l, facet_offset_m)
        if jnp.issubdtype(facet.dtype, jnp.complexfloating):
            facet = grid_correct_w_stack(
                self.image_size, self.theta, self.w_step, self.shear_u,
                self.shear_v, facet, facet_offset_l, facet_offset_m,
                w_offset, inverse=True)
        return facet


# ---------------------------------------------------------------------------
# Vectorised per-plane visibility <-> sub-grid taps
# ---------------------------------------------------------------------------

def _plane_geometry(uvws, start_chs, end_chs, w_plane, off_u, off_v, off_w,
                    freq0_hz, dfreq_hz, num_chan: int, theta: float,
                    w_step: float, support: int, oversampling: int,
                    w_support: int, w_oversampling: int,
                    subgrid_size: int, start_row: int, end_row: int):
    """Shared degrid/grid addressing (sdp_gridder_wtower_uvw.cpp:86-142).

    Returns (mask[R,C], iu0[R,C], iv0[R,C], uk[R,C,S], vk[R,C,S],
    wk[R,C,Sw]) index/taps data with all indices clipped in-bounds (masked
    lanes carry mask == False).
    """
    fdtype = uvws.dtype
    half_subgrid = subgrid_size // 2
    theta_ov = theta * oversampling
    w_step_ov = (1.0 / w_step) * w_oversampling
    half_sg_size_ov = (half_subgrid - support // 2 + 1) * oversampling

    w_coord = uvws[:, 2]
    min_w = (w_plane + off_w - 1).astype(fdtype) * w_step
    max_w = (w_plane + off_w).astype(fdtype) * w_step
    start_ch, end_ch = clamp_channels_inline(
        w_coord, freq0_hz, dfreq_hz, start_chs, end_chs, min_w, max_w)

    row_ids = jnp.arange(uvws.shape[0])
    row_sel = (row_ids >= start_row) & (row_ids < end_row)
    row_active = row_sel & (start_ch < end_ch)

    s_uvw0 = freq0_hz / C_0
    s_duvw = dfreq_hz / C_0
    uvw0 = uvws * s_uvw0
    duvw = uvws * s_duvw
    uvw0 = uvw0 - jnp.stack([
        off_u.astype(fdtype) / theta,
        off_v.astype(fdtype) / theta,
        (off_w + w_plane - 1).astype(fdtype) * w_step])[None, :]

    # Row bounds check (reference :112-121).
    start_f = start_ch.astype(fdtype)
    end1_f = (end_ch - 1).astype(fdtype)
    u_min = jnp.floor(theta * (uvw0[:, 0] + start_f * duvw[:, 0]))
    u_max = jnp.ceil(theta * (uvw0[:, 0] + end1_f * duvw[:, 0]))
    v_min = jnp.floor(theta * (uvw0[:, 1] + start_f * duvw[:, 1]))
    v_max = jnp.ceil(theta * (uvw0[:, 1] + end1_f * duvw[:, 1]))
    in_bounds = ((u_min >= -half_subgrid) & (u_max < half_subgrid)
                 & (v_min >= -half_subgrid) & (v_max < half_subgrid))
    row_active = row_active & in_bounds

    chan = jnp.arange(num_chan)
    cmask = ((chan[None, :] >= start_ch[:, None])
             & (chan[None, :] < end_ch[:, None]))
    mask = row_active[:, None] & cmask

    chan_f = chan.astype(fdtype)
    # u,v,w per (row, channel)
    u = uvw0[:, 0:1] + chan_f[None, :] * duvw[:, 0:1]
    v = uvw0[:, 1:2] + chan_f[None, :] * duvw[:, 1:2]
    w = uvw0[:, 2:3] + chan_f[None, :] * duvw[:, 2:3]

    iu0_ov = _round_half_away(u * theta_ov).astype(jnp.int32) \
        + half_sg_size_ov
    iv0_ov = _round_half_away(v * theta_ov).astype(jnp.int32) \
        + half_sg_size_ov
    iw0_ov = _round_half_away(w * w_step_ov).astype(jnp.int32)

    iu0 = jnp.clip(iu0_ov // oversampling, 0, subgrid_size - support)
    iv0 = jnp.clip(iv0_ov // oversampling, 0, subgrid_size - support)
    u_row = jnp.mod(iu0_ov, oversampling)
    v_row = jnp.mod(iv0_ov, oversampling)
    w_row = jnp.mod(iw0_ov, w_oversampling)
    return mask, iu0, iv0, u_row, v_row, w_row


def _degrid_plane(subgrids, uv_kernel, w_kernel, geom, support: int,
                  w_support: int):
    """vis[r, c] = separable taps over the stack (reference :144-172)."""
    mask, iu0, iv0, u_row, v_row, w_row = geom
    uk = uv_kernel[u_row]                       # [R, C, S]
    vk = uv_kernel[v_row]                       # [R, C, S]
    wk = w_kernel[w_row]                        # [R, C, Sw]
    iu = iu0[..., None] + jnp.arange(support)   # [R, C, S]
    iv = iv0[..., None] + jnp.arange(support)   # [R, C, S]
    acc = None
    for layer in range(w_support):
        taps = subgrids[layer][iu[..., :, None], iv[..., None, :]]
        contrib = jnp.einsum("rcu,rcv,rcuv->rc",
                             uk.astype(taps.dtype),
                             vk.astype(taps.dtype), taps,
                             precision=jax.lax.Precision.HIGHEST)
        term = wk[..., layer].astype(taps.dtype) * contrib
        acc = term if acc is None else acc + term
    return jnp.where(mask, acc, jnp.zeros((), acc.dtype))


def _grid_plane_scatter(subgrids, vis, uv_kernel, w_kernel, geom,
                        support: int, w_support: int):
    """Adjoint scatter of `_degrid_plane` (reference :429-481)."""
    mask, iu0, iv0, u_row, v_row, w_row = geom
    uk = uv_kernel[u_row]
    vk = uv_kernel[v_row]
    wk = w_kernel[w_row]
    iu = iu0[..., None] + jnp.arange(support)
    iv = iv0[..., None] + jnp.arange(support)
    local_vis = jnp.where(mask, vis, jnp.zeros((), vis.dtype))
    outer = (uk[..., :, None] * vk[..., None, :]).astype(vis.dtype) \
        * local_vis[..., None, None]
    for layer in range(w_support):
        vals = outer * wk[..., layer, None, None].astype(vis.dtype)
        subgrids = subgrids.at[layer, iu[..., :, None],
                               iv[..., None, :]].add(vals)
    return subgrids


# ---------------------------------------------------------------------------
# Full multi-plane drivers (scan over w-planes with rolling tower state)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=(
    "num_planes", "theta", "w_step", "support", "oversampling",
    "w_support", "w_oversampling", "subgrid_size", "start_row", "end_row",
    "freq0_hz", "dfreq_hz"))
def _degrid_all_planes(subgrid_image, w_pattern, uv_kernel, w_kernel,
                       uvws, start_chs, end_chs, vis,
                       off_u, off_v, off_w, first_w_plane,
                       freq0_hz, dfreq_hz, num_planes: int, theta: float,
                       w_step: float, support: int, oversampling: int,
                       w_support: int, w_oversampling: int,
                       subgrid_size: int, start_row: int, end_row: int):
    num_chan = vis.shape[1]

    # w_subgrid_image = subgrid_image / w_pattern**(first - w_support//2)
    exponent = (first_w_plane - w_support // 2).astype(
        jnp.real(w_pattern).dtype)
    w_img = subgrid_image / (w_pattern ** exponent)

    # Fill the initial tower stack: FFT layers while dividing by w_pattern.
    def fill(img, _):
        layer = fft_shifted(img)
        return img / w_pattern, layer

    w_img, subgrids = jax.lax.scan(fill, w_img, None, length=w_support)

    def plane_contrib(subgrids, w_plane):
        geom = _plane_geometry(
            uvws, start_chs, end_chs, w_plane, off_u, off_v, off_w,
            freq0_hz, dfreq_hz, num_chan, theta, w_step, support,
            oversampling, w_support, w_oversampling, subgrid_size,
            start_row, end_row)
        if TAP_IMPL != "scatter":
            from ..kernels.dense_tap import degrid_plane_dense
            return degrid_plane_dense(subgrids, uv_kernel, w_kernel,
                                      geom, support, w_support)
        return _degrid_plane(subgrids, uv_kernel, w_kernel, geom,
                             support, w_support)

    vis_acc = vis + plane_contrib(subgrids, first_w_plane).astype(vis.dtype)

    def step(carry, w_plane):
        w_img, subgrids, vis_acc = carry
        subgrids = shift_subgrids(subgrids)
        subgrids = subgrids.at[-1].set(fft_shifted(w_img))
        w_img = w_img / w_pattern
        vis_acc = vis_acc + plane_contrib(subgrids, w_plane).astype(vis.dtype)
        return (w_img, subgrids, vis_acc), None

    if num_planes > 1:
        planes = first_w_plane + jnp.arange(1, num_planes)
        (w_img, subgrids, vis_acc), _ = jax.lax.scan(
            step, (w_img, subgrids, vis_acc), planes)
    return vis_acc


@functools_lru_cache(maxsize=16)
def _tap_coeffs_cached(support: int, oversampling: int):
    from .kernels import kernel_tap_coeffs
    return kernel_tap_coeffs(support, support, oversampling)


@partial(jax.jit, static_argnames=(
    "num_planes", "theta", "w_step", "support", "oversampling",
    "w_support", "w_oversampling", "subgrid_size", "start_row", "end_row",
    "freq0_hz", "dfreq_hz"))
def _grid_all_planes(vis, w_pattern, uv_kernel, w_kernel,
                     uvws, start_chs, end_chs, subgrid_image,
                     off_u, off_v, off_w, first_w_plane,
                     freq0_hz, dfreq_hz, num_planes: int, theta: float,
                     w_step: float, support: int, oversampling: int,
                     w_support: int, w_oversampling: int,
                     subgrid_size: int, start_row: int, end_row: int):
    num_chan = vis.shape[1]
    w_img = jnp.zeros((subgrid_size, subgrid_size), w_pattern.dtype)
    subgrids = jnp.zeros((w_support, subgrid_size, subgrid_size), vis.dtype)

    def plane_scatter(subgrids, w_plane):
        geom = _plane_geometry(
            uvws, start_chs, end_chs, w_plane, off_u, off_v, off_w,
            freq0_hz, dfreq_hz, num_chan, theta, w_step, support,
            oversampling, w_support, w_oversampling, subgrid_size,
            start_row, end_row)
        if TAP_IMPL != "scatter":
            from ..kernels.dense_tap import grid_plane_dense
            return grid_plane_dense(subgrids, vis, uv_kernel, w_kernel,
                                    geom, support, w_support)
        return _grid_plane_scatter(subgrids, vis, uv_kernel, w_kernel,
                                   geom, support, w_support)

    subgrids = plane_scatter(subgrids, first_w_plane)

    def step(carry, w_plane):
        w_img, subgrids = carry
        # Accumulate zero-th plane, shift, clear top (reference :1029-1059).
        w_img = w_img / w_pattern
        w_img = w_img + ifft_shifted(subgrids[0]).astype(w_img.dtype)
        subgrids = shift_subgrids(subgrids)
        subgrids = subgrids.at[-1].set(
            jnp.zeros((subgrid_size, subgrid_size), vis.dtype))
        subgrids = plane_scatter(subgrids, w_plane)
        return (w_img, subgrids), None

    if num_planes > 1:
        planes = first_w_plane + jnp.arange(1, num_planes)
        (w_img, subgrids), _ = jax.lax.scan(step, (w_img, subgrids), planes)

    # Drain the remaining tower layers (reference :1077-1100).
    def drain(w_img, layer):
        w_img = w_img / w_pattern
        w_img = w_img + ifft_shifted(layer).astype(w_img.dtype)
        return w_img, None

    w_img, _ = jax.lax.scan(drain, w_img, subgrids)

    # subgrid_image += w_img * w_pattern**(last + w_support//2 - 1)
    # (iFFT already carries the subgrid_size**2 factor; reference
    # :1102-1113).
    last_w_plane = first_w_plane + num_planes - 1
    exponent = (last_w_plane + w_support // 2 - 1).astype(
        jnp.real(w_pattern).dtype)
    contribution = w_img * (w_pattern ** exponent)
    return subgrid_image + contribution.astype(subgrid_image.dtype)
