"""Gridder helper operations.

Reference: grid_data/sdp_gridder_utils.{h,cpp,cu} — the 17-helper family
used by the w-towers gridder and w-stacking drivers. Here each helper is a
pure, jittable function over jax arrays (no in-place mutation: callers
rebind). Host-only helpers (nonzero-pixel extraction, scalar tuning) use
numpy where dynamic output sizes make them unjittable by nature.
"""

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpShapeError
from .kernels import lm_to_n

Array = jax.Array


# ---------------------------------------------------------------------------
# Elementwise array algebra
# ---------------------------------------------------------------------------

def _check_uvw_rows(uvws, fn: str):
    """Row-form uvw contract ``float[n, 3]`` (the subgrid-level helpers
    take flattened rows, not the [time, baseline, 3] data-model form) —
    expected-failure parity with the reference's per-function
    sdp_mem_check_* sweeps (tests/.../test_*.cpp pattern)."""
    uvws = jnp.asarray(uvws)
    if uvws.ndim != 2 or uvws.shape[-1] != 3:
        raise SdpShapeError(
            f"{fn}: uvws must be [n, 3]; got {uvws.shape}")
    if not jnp.issubdtype(uvws.dtype, jnp.floating):
        raise SdpInvalidArgumentError(
            f"{fn}: uvws must be float; got {uvws.dtype}")
    return uvws


def _pow_int(base: Array, exponent) -> Array:
    """base ** exponent with the 0/1 fast paths of the reference
    (sdp_gridder_utils.h:22-46)."""
    if isinstance(exponent, int):
        if exponent == 0:
            return jnp.ones_like(base)
        if exponent == 1:
            return base
        return base ** exponent
    return base ** exponent


def accumulate_scaled_arrays(out: Array, in1: Array,
                             in2: Optional[Array] = None,
                             exponent=0) -> Array:
    """Return ``out + in1 * in2 ** exponent``; in2 ignored when exponent 0.

    Equivalent of `sdp_gridder_accumulate_scaled_arrays`
    (sdp_gridder_utils.h:40-46). When `out` is real and the product is
    complex, only the real part accumulates (matching the reference's
    complex->real store).
    """
    if in2 is None or (isinstance(exponent, int) and exponent == 0):
        term = in1
    else:
        term = in1 * _pow_int(in2, exponent)
    if not jnp.issubdtype(out.dtype, jnp.complexfloating) and \
            jnp.issubdtype(jnp.result_type(term), jnp.complexfloating):
        term = term.real
    return out + term.astype(out.dtype)


def scale_inv_array(in1: Array, in2: Array, exponent=1) -> Array:
    """Return ``in1 / in2 ** exponent``
    (`sdp_gridder_scale_inv_array`, sdp_gridder_utils.h:296-302)."""
    return in1 / _pow_int(in2, exponent)


def residual(a: Array, b: Array) -> Array:
    """Elementwise difference a - b (`sdp_gridder_residual`)."""
    if a.shape != b.shape:
        raise SdpShapeError(f"shape mismatch: {a.shape} vs {b.shape}")
    return a - b


def rms_diff(a: Array, b: Array) -> Array:
    """RMS of (a - b) (`sdp_gridder_rms_diff`)."""
    if a.shape != b.shape:
        raise SdpShapeError(f"shape mismatch: {a.shape} vs {b.shape}")
    diff = a - b
    return jnp.sqrt(jnp.mean(jnp.abs(diff) ** 2))


def sum_diff(a: Array, b: Array, start_row: int = 0,
             end_row: Optional[int] = None) -> Array:
    """sum(a - b) over [start_row, end_row)
    (`sdp_gridder_sum_diff`, sdp_gridder_utils.h:358-365)."""
    if end_row is None:
        end_row = a.shape[0]
    return jnp.sum(a[start_row:end_row].astype(jnp.int64)
                   - b[start_row:end_row].astype(jnp.int64))


# ---------------------------------------------------------------------------
# Sub-grid stack manipulation
# ---------------------------------------------------------------------------

def shift_subgrids(subgrids: Array) -> Array:
    """Shift the w-tower stack down one plane: out[:-1] = in[1:].

    The last plane is left unchanged (the caller overwrites or clears it),
    matching `sdp_gridder_shift_subgrids` (sdp_gridder_utils.cpp:529-550).
    """
    return jnp.concatenate([subgrids[1:], subgrids[-1:]], axis=0)


def _wrap_indices(sub_size: int, grid_size: int, offset: int,
                  sign: int) -> Array:
    idx = (jnp.arange(sub_size) + grid_size // 2 - sub_size // 2
           + sign * offset)
    return jnp.mod(idx, grid_size)


@partial(jax.jit, static_argnames=())
def _subgrid_add(grid, subgrid, offset_u, offset_v, factor):
    su, sv = subgrid.shape
    gu, gv = grid.shape
    iu = jnp.mod(jnp.arange(su) + gu // 2 - su // 2 - offset_u, gu)
    iv = jnp.mod(jnp.arange(sv) + gv // 2 - sv // 2 - offset_v, gv)
    contrib = (subgrid * factor).astype(grid.dtype)
    return grid.at[iu[:, None], iv[None, :]].add(contrib)


def subgrid_add(grid: Array, offset_u: int, offset_v: int,
                subgrid: Array, factor=1.0) -> Array:
    """Add a sub-grid into the grid with wrap-around (torus) indexing.

    Equivalent of `sdp_gridder_subgrid_add` (sdp_gridder_utils.cpp:553-600):
    subgrid pixel (i, j) lands on grid pixel
    ``(i + G/2 - S/2 - offset_u) mod G`` (note the *minus* offset — the
    reverse of `subgrid_cut_out`).
    """
    grid = jnp.asarray(grid)
    subgrid = jnp.asarray(subgrid)
    if grid.ndim != 2 or subgrid.ndim != 2:
        raise SdpShapeError("subgrid_add: grid and subgrid must be 2D")
    if subgrid.shape[0] > grid.shape[0] or \
            subgrid.shape[1] > grid.shape[1]:
        raise SdpShapeError(
            f"subgrid_add: subgrid {subgrid.shape} larger than grid "
            f"{grid.shape}")
    return _subgrid_add(grid, subgrid,
                        jnp.asarray(offset_u), jnp.asarray(offset_v),
                        jnp.asarray(factor))


@partial(jax.jit, static_argnames=("su", "sv"))
def _subgrid_cut_out(grid, offset_u, offset_v, su: int, sv: int):
    gu, gv = grid.shape
    iu = jnp.mod(jnp.arange(su) + gu // 2 - su // 2 + offset_u, gu)
    iv = jnp.mod(jnp.arange(sv) + gv // 2 - sv // 2 + offset_v, gv)
    return grid[iu[:, None], iv[None, :]]


def _wrap_runs(start: int, size: int, n: int):
    """Contiguous runs covering indices (start + arange(size)) mod n.

    Yields (grid_start, sub_start, length) triples — at most two when
    size <= n.
    """
    start %= n
    runs = []
    pos = 0
    while pos < size:
        s = (start + pos) % n
        length = min(n - s, size - pos)
        runs.append((s, pos, length))
        pos += length
    return runs


def subgrid_add_static(grid: Array, offset_u: int, offset_v: int,
                       subgrid: Array, factor=1.0) -> Array:
    """`subgrid_add` for *static* (Python int) offsets.

    The wrap-around is decomposed into at most 4 contiguous static
    slice-adds, which XLA lowers to dynamic-update-slice fusions
    instead of the general scatter the fancy-indexed version produces
    (used by the packed whole-image drivers where all offsets are plan
    constants).
    """
    su, sv = subgrid.shape
    gu, gv = grid.shape
    contrib = (subgrid * factor).astype(grid.dtype)
    runs_u = _wrap_runs(gu // 2 - su // 2 - int(offset_u), su, gu)
    runs_v = _wrap_runs(gv // 2 - sv // 2 - int(offset_v), sv, gv)
    for gs_u, ss_u, lu in runs_u:
        for gs_v, ss_v, lv in runs_v:
            grid = grid.at[gs_u:gs_u + lu, gs_v:gs_v + lv].add(
                contrib[ss_u:ss_u + lu, ss_v:ss_v + lv])
    return grid


def subgrid_cut_out_static(grid: Array, offset_u: int, offset_v: int,
                           subgrid_size: int) -> Array:
    """`subgrid_cut_out` for *static* offsets (slice + concat, no
    gather)."""
    gu, gv = grid.shape
    su = sv = subgrid_size
    runs_u = _wrap_runs(gu // 2 - su // 2 + int(offset_u), su, gu)
    runs_v = _wrap_runs(gv // 2 - sv // 2 + int(offset_v), sv, gv)
    rows = jnp.concatenate(
        [grid[gs:gs + lu, :] for gs, _, lu in runs_u], axis=0) \
        if len(runs_u) > 1 else grid[runs_u[0][0]:runs_u[0][0] + su, :]
    out = jnp.concatenate(
        [rows[:, gs:gs + lv] for gs, _, lv in runs_v], axis=1) \
        if len(runs_v) > 1 else rows[:, runs_v[0][0]:runs_v[0][0] + sv]
    return out


def subgrid_cut_out(grid: Array, offset_u: int, offset_v: int,
                    subgrid_size: int) -> Array:
    """Cut a sub-grid out of the grid with wrap-around indexing.

    Equivalent of `sdp_gridder_subgrid_cut_out`
    (sdp_gridder_utils.cpp:603-650); returns the ``subgrid_size``-square
    block centred at (+offset_u, +offset_v) relative to the grid centre.
    """
    grid = jnp.asarray(grid)
    if grid.ndim != 2:
        raise SdpShapeError("subgrid_cut_out: grid must be 2D")
    if subgrid_size > min(grid.shape):
        raise SdpShapeError(
            f"subgrid_cut_out: subgrid_size {subgrid_size} larger "
            f"than grid {grid.shape}")
    return _subgrid_cut_out(grid, jnp.asarray(offset_u),
                            jnp.asarray(offset_v),
                            subgrid_size, subgrid_size)


# ---------------------------------------------------------------------------
# UVW bounds
# ---------------------------------------------------------------------------

@jax.jit
def uvw_bounds_all(uvws: Array, freq0_hz, dfreq_hz,
                   start_chs: Array, end_chs: Array
                   ) -> Tuple[Array, Array]:
    """Scaled (u,v,w) min/max over all rows and selected channels.

    Equivalent of `sdp_gridder_uvw_bounds_all`
    (sdp_gridder_utils.cpp:682-720): per row, the channel endpoints
    ``u0 + start_ch*du`` and ``u0 + (end_ch-1)*du`` bound the range (the
    sign of uvw decides which end is the min). Rows with empty channel
    ranges are skipped. Returns ``(uvw_min[3], uvw_max[3])``.
    """
    uvws = _check_uvw_rows(uvws, "uvw_bounds_all")
    compute_dtype = jnp.result_type(uvws.dtype, jnp.float32)
    uvw = jnp.asarray(uvws, compute_dtype)
    u0 = freq0_hz * uvw / C_0
    du = dfreq_hz * uvw / C_0
    start = jnp.asarray(start_chs, compute_dtype)[:, None]
    end1 = jnp.asarray(end_chs, compute_dtype)[:, None] - 1.0
    at_start = u0 + start * du
    at_end = u0 + end1 * du
    lo = jnp.where(uvw >= 0, at_start, at_end)
    hi = jnp.where(uvw >= 0, at_end, at_start)
    active = (jnp.asarray(start_chs) < jnp.asarray(end_chs))[:, None]
    inf = jnp.asarray(jnp.inf, compute_dtype)
    lo = jnp.where(active, lo, inf)
    hi = jnp.where(active, hi, -inf)
    return jnp.min(lo, axis=0), jnp.max(hi, axis=0)


# ---------------------------------------------------------------------------
# Image <-> component list
# ---------------------------------------------------------------------------

def image_lmn(image_shape: Tuple[int, int], theta: float,
              shear_u: float = 0.0, shear_v: float = 0.0) -> Array:
    """(l, m, n) coordinates for every pixel (row-major), jittable.

    Full-image variant of `sdp_gridder_image_to_flmn`
    (sdp_gridder_utils.cpp:317-382, flux == NULL branch):
    ``l = (il - size_l//2) * theta / size_l``.
    """
    size_l, size_m = image_shape
    l = (jnp.arange(size_l) - size_l // 2) * (theta / size_l)
    m = (jnp.arange(size_m) - size_m // 2) * (theta / size_m)
    ll, mm = jnp.meshgrid(l, m, indexing="ij")
    nn = lm_to_n(ll, mm, shear_u, shear_v)
    return jnp.stack([ll.ravel(), mm.ravel(), nn.ravel()], axis=-1)


def count_nonzero_pixels(image) -> int:
    """Number of non-zero pixels (`sdp_gridder_count_nonzero_pixels`)."""
    return int(np.count_nonzero(np.asarray(image)))


def image_to_flmn(image, theta: float, shear_u: float = 0.0,
                  shear_v: float = 0.0,
                  image_taper_1d=None) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (flux, lmn) for all non-zero pixels (host, dynamic size).

    Equivalent of `sdp_gridder_image_to_flmn` with flux output
    (sdp_gridder_utils.cpp:317-382). Returns numpy
    ``(flux[k], lmn[k, 3])``; flux includes the separable taper when given.
    """
    img = np.asarray(image)
    size_l, size_m = img.shape
    il, im = np.nonzero(img)
    l = (il - size_l // 2) * theta / size_l
    m = (im - size_m // 2) * theta / size_m
    flux = np.real(img[il, im])
    if image_taper_1d is not None:
        taper = np.asarray(image_taper_1d)
        flux = flux * taper[il] * taper[im]
    n = np.asarray(lm_to_n(l, m, shear_u, shear_v))
    return flux, np.stack([l, m, n], axis=-1)


# ---------------------------------------------------------------------------
# Tuning helpers
# ---------------------------------------------------------------------------

def determine_w_step(theta: float, fov: float, shear_u: float = 0.0,
                     shear_v: float = 0.0, x0: float = 0.0) -> float:
    """Choose the w-plane spacing (`sdp_gridder_determine_w_step`,
    sdp_gridder_utils.cpp:1016-1040): 1 / theta_n where theta_n is the
    image-space extent along the n axis scaled by x0 (default fov/theta)."""
    if x0 == 0.0:
        x0 = fov / theta
    corners = [
        lm_to_n(-fov / 2.0, -fov / 2.0, shear_u, shear_v),
        lm_to_n(fov / 2.0, -fov / 2.0, shear_u, shear_v),
        lm_to_n(-fov / 2.0, fov / 2.0, shear_u, shear_v),
        lm_to_n(fov / 2.0, fov / 2.0, shear_u, shear_v),
    ]
    fov_n = 2.0 * -min(corners)
    theta_n = fov_n / x0
    return 1.0 / theta_n


# ---------------------------------------------------------------------------
# Direct Fourier transforms (accuracy oracles and predict primitives)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("num_chan",))
def _dft_core(uvws, flux, lmn, offsets_scaled, freq0_hz, dfreq_hz,
              active, num_chan: int):
    compute_dtype = jnp.result_type(uvws.dtype, jnp.float32)
    chan = jnp.arange(num_chan, dtype=compute_dtype)
    inv_wave = (freq0_hz + dfreq_hz * chan) / C_0        # [chans]
    # uvw_scaled[r, c, k] = uvw[r, k] * inv_wave[c] - offsets_scaled[k]
    uvw_scaled = (uvws[:, None, :] * inv_wave[None, :, None]
                  - offsets_scaled[None, None, :])
    # phase[r, c, s] = -2 pi (lmn[s] . uvw_scaled[r, c])
    # HIGHEST on every product here: a phase of thousands of radians
    # needs f32 (TF32 keeps ~3 digits).
    phase = -2.0 * jnp.pi * jnp.einsum("rck,sk->rcs", uvw_scaled,
                                       jnp.asarray(lmn, compute_dtype),
                                       precision=jax.lax.Precision.HIGHEST)
    phasor = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    vis = jnp.matmul(phasor, jnp.asarray(flux, phasor.dtype),
                     precision=jax.lax.Precision.HIGHEST)
    return vis * active[:, None]


def dft(uvws: Array, flux: Array, lmn: Array,
        start_chs: Optional[Array] = None,
        end_chs: Optional[Array] = None,
        subgrid_offset_u: int = 0, subgrid_offset_v: int = 0,
        subgrid_offset_w: int = 0, theta: float = 0.0, w_step: float = 0.0,
        freq0_hz: float = C_0, dfreq_hz: float = 0.0,
        num_chan: int = 1, vis: Optional[Array] = None) -> Array:
    """Point-source DFT prediction (`sdp_gridder_dft`,
    sdp_gridder_utils.cpp:126-211):

        vis[r, c] += sum_s flux[s] exp(-2 pi i (l u + m v + n w))

    with u = uvw[r,0]*(freq_c/C0) - subgrid_offset_u/theta, etc. Rows whose
    channel range is empty contribute zero. Returns the accumulated
    visibilities (``vis + contribution`` if ``vis`` given).
    """
    uvws = _check_uvw_rows(uvws, "dft")
    flux = jnp.asarray(flux)
    lmn = jnp.asarray(lmn)
    if lmn.ndim != 2 or lmn.shape[-1] != 3:
        raise SdpShapeError(f"dft: lmn must be [sources, 3]; got {lmn.shape}")
    if flux.shape[0] != lmn.shape[0]:
        raise SdpShapeError(
            f"dft: flux ({flux.shape[0]}) and lmn ({lmn.shape[0]}) "
            "source counts differ")
    num_rows = uvws.shape[0]
    if vis is not None:
        num_chan = vis.shape[1]
    du = dv = dw = 0.0
    if theta > 0:
        du = subgrid_offset_u / theta
        dv = subgrid_offset_v / theta
        dw = subgrid_offset_w * w_step
    compute_dtype = jnp.result_type(uvws.dtype, jnp.float32)
    offsets = jnp.asarray([du, dv, dw], compute_dtype)
    if start_chs is None or end_chs is None:
        active = jnp.ones((num_rows,), compute_dtype)
    else:
        active = (jnp.asarray(start_chs)
                  < jnp.asarray(end_chs)).astype(compute_dtype)
    contribution = _dft_core(jnp.asarray(uvws, compute_dtype),
                             flux, lmn, offsets, freq0_hz, dfreq_hz,
                             active, int(num_chan))
    if vis is not None:
        return vis + contribution.astype(vis.dtype)
    return contribution


@jax.jit
def _idft_core(uvws, vis, lmn, offsets_scaled, freq0_hz, dfreq_hz, active):
    compute_dtype = jnp.result_type(uvws.dtype, jnp.float32)
    num_chan = vis.shape[1]
    chan = jnp.arange(num_chan, dtype=compute_dtype)
    inv_wave = (freq0_hz + dfreq_hz * chan) / C_0
    uvw_scaled = (uvws[:, None, :] * inv_wave[None, :, None]
                  - offsets_scaled[None, None, :])
    phase = 2.0 * jnp.pi * jnp.einsum("sk,rck->src",
                                      jnp.asarray(lmn, compute_dtype),
                                      uvw_scaled, precision=jax.lax.Precision.HIGHEST)
    phasor = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    masked_vis = vis * active[:, None]
    return jnp.einsum("src,rc->s", phasor, masked_vis, precision=jax.lax.Precision.HIGHEST)


def idft(uvws: Array, vis: Array, lmn: Array,
         start_chs: Optional[Array] = None,
         end_chs: Optional[Array] = None,
         image_taper_1d: Optional[Array] = None,
         subgrid_offset_u: int = 0, subgrid_offset_v: int = 0,
         subgrid_offset_w: int = 0, theta: float = 0.0, w_step: float = 0.0,
         freq0_hz: float = C_0, dfreq_hz: float = 0.0,
         image: Optional[Array] = None,
         image_shape: Optional[Tuple[int, int]] = None) -> Array:
    """Direct-Fourier imaging (`sdp_gridder_idft`,
    sdp_gridder_utils.cpp:215-314):

        image[p] += taper(p) * sum_{r,c} vis[r, c] exp(+2 pi i lmn_p . uvw)

    ``lmn`` must hold one row per pixel (row-major; see
    :func:`image_lmn`). Returns the accumulated image.
    """
    if image is not None:
        image_shape = image.shape
    if image_shape is None:
        raise SdpInvalidArgumentError("image or image_shape required")
    du = dv = dw = 0.0
    if theta > 0:
        du = subgrid_offset_u / theta
        dv = subgrid_offset_v / theta
        dw = subgrid_offset_w * w_step
    compute_dtype = jnp.result_type(uvws.dtype, jnp.float32)
    offsets = jnp.asarray([du, dv, dw], compute_dtype)
    num_rows = uvws.shape[0]
    if start_chs is None or end_chs is None:
        active = jnp.ones((num_rows,), vis.dtype)
    else:
        active = (jnp.asarray(start_chs)
                  < jnp.asarray(end_chs)).astype(vis.dtype)
    flat = _idft_core(jnp.asarray(uvws, compute_dtype), vis, lmn,
                      offsets, freq0_hz, dfreq_hz, active)
    result = flat.reshape(image_shape)
    if image_taper_1d is not None:
        taper = jnp.asarray(image_taper_1d)
        result = result * taper[:, None] * taper[None, :]
    if image is not None:
        if jnp.issubdtype(image.dtype, jnp.complexfloating):
            return image + result.astype(image.dtype)
        return image + result.real.astype(image.dtype)
    return result
