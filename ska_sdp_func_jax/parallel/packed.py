"""Packed w-stacking drivers: the whole-image performance path.

Pipeline (single kernel invocation per grid/degrid call, all tasks):

1. **Plan** (host, once per uvw distribution): every (row, channel)
   visibility is assigned to its (w-plane, sub-grid) task box, its
   w-slab ``k0`` (first absolute tower layer touched) and u-octet
   ``g = iu0 // 8``; the stream is bucket-sorted by (task, slab,
   octet) and each bucket padded to a block multiple. All kernel tap
   values are table lookups on the host (f64) — the host is the single
   source of truth for the quantised geometry, so the device never
   re-derives (and can never disagree about) bucket membership.
2. **Taps** (device, once per plan): the u/v/w kernel taps of every
   slot are evaluated from their Chebyshev fits
   (:class:`~ska_sdp_func_jax.kernels.packed_tap.Taps`) and reused by
   every call.
3. **Grid** (device, per call): one
   :func:`~ska_sdp_func_jax.kernels.packed_tap.grid_stack` pass over
   all blocks into per-task tower stacks -> batched iFFT -> shared
   w-pattern ladder contraction (one complex einsum; the per-task
   prefactor ``w_pattern**e0`` is a host-precomputed constant) ->
   wrap-around subgrid adds -> per-plane grid correction. Degrid
   mirrors it.

Compared to :mod:`.bucketed`, this removes the per-task Python/dispatch
loop around the kernels, drops the dense-band matmul formulation (~10x
FLOPs), and hoists all tap computation out of the per-iteration path.

Reference equivalents: the OpenMP task queue + per-task gridder calls
(sdp_grid_wstack_wtower.cpp:388-440) and the GPU bucket-sort tiling
(sdp_tiled_functions.cu); the vis-count invariant mirrors
sdp_grid_wstack_wtower.cpp:442-448 (raises instead of exit(1)).
"""

import hashlib
import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..fourier_transforms.fft import fft_shifted, ifft_shifted, \
    ifft_shifted_norm
from ..grid_data.grid_correct import grid_correct_pswf, \
    w_screen_stack
from ..grid_data.gridder_utils import (
    subgrid_add_static,
    subgrid_cut_out_static,
)
from ..kernels.packed_tap import (
    LANE_CHUNK,
    MAX_SUPPORT,
    MAX_W_SUPPORT,
    Taps,
    degrid_stack,
    grid_stack,
)
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpRuntimeError
from .wstack import WStackPlan

Array = jax.Array


@dataclass(frozen=True)
class PackedTask:
    iu: int
    iv: int
    iw: int
    first_w_plane: int


@dataclass(frozen=True)
class PackedPlan:
    """Static packed-ingest geometry + host index/tap arrays.

    Equality/hash cover the geometry and a content digest of the index
    arrays, so value-equal plans share compiled drivers while plans
    with different permutations never collide (a cache-identity
    hazard).
    """

    wplan: WStackPlan
    tasks: Tuple[PackedTask, ...]
    num_rows: int
    num_layers: int          # Kmax: uniform padded tower depth
    num_slabs: int           # Kmax - w_support + 1
    num_octets: int
    block_v: int
    total: int               # padded sorted-stream length
    num_blocks: int
    num_buckets: int
    digest: str
    arrays: Dict[str, np.ndarray] = field(compare=False, hash=False,
                                          repr=False, default=None)

    @property
    def w_plane_ids(self):
        return tuple(sorted({t.iw for t in self.tasks}))


def _round_half_away_np(x):
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _plane_screens(kernel, w_offsets, inverse: bool):
    """Stacked w-stacking screens ``[P, G, G]`` (complex64, in-jit).

    ``exp(+i 2 pi w_step w_offset n)`` per plane when ``inverse`` (the
    grid correction multiplies by the screen,
    sdp_gridder_grid_correct.cpp:77-115); the degrid correction divides,
    i.e. multiplies by the conjugate (offset sign flip — unit modulus).
    Batching the screens lets all per-plane corrections ride ONE
    image-sized elementwise pass and the plane FFTs ONE batched
    transform instead of a per-plane loop. Screen construction is
    shared with :func:`..grid_data.grid_correct.w_screen_stack`.
    """
    offs = np.asarray(w_offsets, np.float64)
    if not inverse:
        offs = -offs
    return w_screen_stack(kernel.image_size, kernel.theta,
                          kernel.w_step, kernel.shear_u, kernel.shear_v,
                          offs, dtype=jnp.complex64)


def _planes_to_image(kernel, planes, w_offsets, screens=None):
    """Per-w-plane uv grids ``[P, G, G]`` -> corrected real image.

    One batched iFFT + one stacked-screen contraction + the shared
    PSWF correction (hoisted out of the plane sum — it is w-independent,
    sdp_gridder_grid_correct.cpp:19-74).  ``screens`` lets the caller
    pass the PRECOMPUTED stack as a jit argument — the screens are
    static per plan, and rebuilding them in-jit costs ~P*N^2 sin/cos
    per call.
    """
    stack = ifft_shifted_norm(planes)
    if screens is None:
        screens = _plane_screens(kernel, w_offsets, inverse=True)
    # HIGHEST: the screens carry w phases; a TF32 product would keep
    # three digits of them.
    image = jnp.einsum("puv,puv->uv", screens, stack,
                       precision=jax.lax.Precision.HIGHEST)
    image = grid_correct_pswf(
        kernel.image_size, kernel.theta, kernel.w_step, kernel.shear_u,
        kernel.shear_v, kernel.support, kernel.w_support, image)
    return image.real.astype(jnp.float32)


def _image_to_plane_stack(kernel, image, w_offsets, screens=None):
    """Real image -> per-w-plane degrid-corrected uv grids ``[P, G, G]``
    via one shared PSWF multiply, one stacked conjugate screen and ONE
    batched FFT (mirror of :func:`_planes_to_image`, same precomputed
    ``screens`` option)."""
    base = grid_correct_pswf(
        kernel.image_size, kernel.theta, kernel.w_step, kernel.shear_u,
        kernel.shear_v, kernel.support, kernel.w_support,
        image.astype(jnp.complex64))
    if screens is None:
        screens = _plane_screens(kernel, w_offsets, inverse=False)
    return fft_shifted(base[None] * screens)


# Stream slots per block: the bucket padding quantum. A multiple of the
# kernels' tile (packed_tap.TILE_V); the kernel walks each bucket's
# blocks inside one program, so smaller blocks cost padding, not launches.
_BLOCK_V = 64


def packed_geometry_ok(subgrid_size: int, support: int, w_support: int,
                       subgrid_frac: float) -> bool:
    """True when the packed formulation can express the geometry.

    The single source of the packed-path constraints (used by
    plan_packed and the reference-driver ``engine="auto"`` routing):
    the kernels' octet window (support <= 8) and 128-row window
    (w_support <= 4), whole 128-lane chunks (subgrid_size % 128 == 0),
    and the in-window tap invariant (eff_sg_size + support <=
    subgrid_size).
    """
    eff = int(math.floor(subgrid_size * (subgrid_frac or 2.0 / 3.0)))
    return (support <= MAX_SUPPORT and w_support <= MAX_W_SUPPORT
            and subgrid_size % LANE_CHUNK == 0
            and eff + support <= subgrid_size)


def plan_packed(wplan: WStackPlan, uvw, block_v=None,
                pad_blocks_to: int = 1) -> PackedPlan:
    """Build the packed ingest plan on the host (NumPy, f64).

    Enumerates the task boxes directly from the per-(row, channel)
    assignment (so no visibility can ever be dropped — the plan and
    the assignment are the same arithmetic), bucket-sorts by
    (task, w-slab, u-octet) and precomputes all kernel taps by table
    lookup. ``block_v`` is the bucket padding quantum (default
    ``_BLOCK_V``; a multiple of the kernels' tile).
    """
    support, w_support = wplan.support, wplan.w_support
    sgs = wplan.subgrid_size
    if not packed_geometry_ok(sgs, support, w_support,
                              wplan.subgrid_frac):
        raise SdpInvalidArgumentError(
            "packed path requires support <= 8 (octet window), "
            "w_support <= 4 (window rows), subgrid_size % 128 == 0 "
            "and eff_sg_size + support <= subgrid_size (got "
            f"support={support}, w_support={w_support}, "
            f"subgrid_size={sgs}, eff_sg_size={wplan.eff_sg_size})")

    if block_v is None:
        block_v = _BLOCK_V
    uvw = np.asarray(uvw, np.float64)
    num_rows = uvw.shape[0]
    num_chan = wplan.num_chan
    freq0 = wplan.freq0_hz
    dfreq = wplan.dfreq_hz or 10.0
    theta, w_step = wplan.theta, wplan.w_step
    ov, w_ov = wplan.oversampling, wplan.w_oversampling
    d = wplan.eff_sg_dist
    wd = wplan.w_stack_dist
    height = wplan.w_tower_height

    num_vis = num_rows * num_chan
    if num_vis == 0:
        raise SdpInvalidArgumentError(
            "packed plan needs at least one (row, channel) visibility "
            f"(got {num_rows} rows x {num_chan} channels)")

    # Task enumeration + per-task w bounds: native one-pass scan when
    # available (host_runtime.cpp sdp_host_packed_tasks), else NumPy on
    # a packed scalar key (lexicographic in (biw, biu, biv); ~10x
    # faster than np.unique(axis=0)'s void view).
    from .. import native as native_runtime

    u = v = w = None
    nat_tasks = native_runtime.packed_tasks(
        uvw, freq0, dfreq, num_chan, d, wd)
    if nat_tasks is not None:
        task_id, boxes, wmin_t, wmax_t = nat_tasks
        num_tasks = boxes.shape[0]
    else:
        scale = (freq0 + dfreq * np.arange(num_chan)) / C_0
        u = (uvw[:, 0:1] * scale[None, :]).ravel()
        v = (uvw[:, 1:2] * scale[None, :]).ravel()
        w = (uvw[:, 2:3] * scale[None, :]).ravel()

        biu = np.floor(u / d + 0.5).astype(np.int64)
        biv = np.floor(v / d + 0.5).astype(np.int64)
        biw = np.floor(w / wd + 0.5).astype(np.int64)

        span = 1 << 20
        box_key = ((biw + span // 2) * span + (biu + span // 2)) * span \
            + (biv + span // 2)
        keys, task_id = np.unique(box_key, return_inverse=True)
        task_id = task_id.ravel()
        num_tasks = keys.shape[0]
        boxes = np.stack([keys // (span * span) - span // 2,
                          (keys // span) % span - span // 2,
                          keys % span - span // 2], axis=1)

        # Segment reductions over the task-sorted stream (no per-task
        # Python loop).
        order_t = np.argsort(task_id, kind="stable")
        seg = np.searchsorted(task_id[order_t], np.arange(num_tasks))
        w_sorted = w[order_t]
        wmin_t = np.minimum.reduceat(w_sorted, seg)
        wmax_t = np.maximum.reduceat(w_sorted, seg)

    # Per-task w bounds -> tower plane range (plan_wstack geometry,
    # sdp_grid_wstack_wtower.cpp:310-330).
    eta = 1e-5
    off_w_t = np.trunc(boxes[:, 0] * height).astype(np.int64)
    first_t = (np.floor(wmin_t / w_step - eta).astype(np.int64)
               - off_w_t)
    last_t = (np.ceil(wmax_t / w_step + eta).astype(np.int64)
              - off_w_t + 1)
    num_planes_t = 1 + last_t - first_t
    num_layers = int((num_planes_t + w_support - 1).max())
    num_slabs = num_layers - w_support + 1
    num_octets = sgs // 8

    kernel = wplan.kernel()
    num_buckets = num_tasks * num_slabs * num_octets

    # Native C++/OpenMP two-pass planner (geometry + bucket counting +
    # stable placement + tap table fills); NumPy fallback below.
    nat = native_runtime.packed_plan_arrays(
        uvw, freq0, dfreq, num_chan, d, theta, w_step, height, ov,
        w_ov, sgs, support, w_support, task_id, first_t, off_w_t,
        num_planes_t, num_slabs, num_octets, block_v,
        kernel.uv_kernel, kernel.w_kernel)
    if nat is not None:
        sort_index, valid = nat["sort_index"], nat["valid"]
        u_off_s, iv0_s = nat["u_off"], nat["iv0"]
        uk_s, vk_s, wk_s = nat["uk"], nat["vk"], nat["wk"]
        u_frac_s, v_frac_s = nat["u_frac"], nat["v_frac"]
        w_row_s = nat["w_row"]
        counts, padded, total = nat["counts"], nat["padded"], \
            nat["total"]
        block_v = nat["block_v"]
        num_blocks = total // block_v
    else:
        # Per-entry tap geometry relative to its own task (host =
        # single source of truth; formulas mirror
        # sdp_gridder_wtower_uvw.cpp:126-142 via grid_data/wtower.py).
        if u is None:
            scale = (freq0 + dfreq * np.arange(num_chan)) / C_0
            u = (uvw[:, 0:1] * scale[None, :]).ravel()
            v = (uvw[:, 1:2] * scale[None, :]).ravel()
            w = (uvw[:, 2:3] * scale[None, :]).ravel()
            biu = np.floor(u / d + 0.5).astype(np.int64)
            biv = np.floor(v / d + 0.5).astype(np.int64)
        half_ov = (sgs // 2 - support // 2 + 1) * ov
        u_rel = u - biu * d
        v_rel = v - biv * d
        iu0_ov = _round_half_away_np(
            u_rel * (theta * ov)).astype(np.int64) + half_ov
        iv0_ov = _round_half_away_np(
            v_rel * (theta * ov)).astype(np.int64) + half_ov
        iu0 = np.clip(iu0_ov // ov, 0, sgs - support)
        iv0 = np.clip(iv0_ov // ov, 0, sgs - support)
        u_frac = np.mod(iu0_ov, ov)
        v_frac = np.mod(iv0_ov, ov)

        w_rel = w - off_w_t[task_id] * w_step
        j = np.floor(w_rel / w_step).astype(np.int64) + 1 \
            - first_t[task_id]
        w_rel2 = w_rel - (first_t[task_id] + j - 1) * w_step
        w_row = np.mod(
            _round_half_away_np(
                w_rel2 * (w_ov / w_step)).astype(np.int64), w_ov)

        bad = (j < 0) | (j >= num_planes_t[task_id])
        if bad.any():
            # The invariant of sdp_grid_wstack_wtower.cpp:442-448:
            # every visibility must land in a planned slab.
            raise SdpRuntimeError(
                f"packed plan: {int(bad.sum())} of {num_vis} "
                "visibilities fall outside their task's w-tower range")

        uk = kernel.uv_kernel[u_frac].astype(np.float32)     # [V, S]
        vk = kernel.uv_kernel[v_frac].astype(np.float32)
        wk = kernel.w_kernel[w_row].astype(np.float32)       # [V, Sw]

        octet = (iu0 >> 3).astype(np.int64)
        u_off = (iu0 & 7).astype(np.int32)
        bucket = (task_id * num_slabs + j) * num_octets + octet

        counts = np.bincount(bucket, minlength=num_buckets)
        padded = -(-counts // block_v) * block_v            # 0 stays 0
        pad_off = np.zeros(num_buckets + 1, np.int64)
        np.cumsum(padded, out=pad_off[1:])
        total = int(pad_off[-1])

        order = np.argsort(bucket, kind="stable")
        sstart = np.zeros(num_buckets, np.int64)
        np.cumsum(counts[:-1], out=sstart[1:])
        rank = np.arange(num_vis) - sstart[bucket[order]]
        dest = pad_off[bucket[order]] + rank

        sort_index = np.zeros(total, np.int64)
        valid = np.zeros(total, bool)
        sort_index[dest] = order
        valid[dest] = True

        def scatter(x, fill=0):
            out = np.full((total,) + x.shape[1:], fill, x.dtype)
            out[dest] = x[order]
            return out

        u_off_s = scatter(u_off)
        iv0_s = scatter(iv0.astype(np.int32))
        uk_s = scatter(uk)
        vk_s = scatter(vk)
        wk_s = scatter(wk)
        u_frac_s = scatter(u_frac.astype(np.int32))
        v_frac_s = scatter(v_frac.astype(np.int32))
        w_row_s = scatter(w_row.astype(np.int32))
    num_blocks = total // block_v

    nonzero = np.nonzero(padded)[0]
    block_bucket = np.repeat(nonzero,
                             (padded[nonzero] // block_v)).astype(np.int32)
    visited = counts > 0

    # Optional trailing pad blocks (mesh sharding needs num_blocks to be
    # a device multiple): they re-visit the last bucket with all-zero
    # taps, so each shard's runs stay contiguous and the sums unchanged.
    extra = (-num_blocks) % pad_blocks_to
    if extra:
        block_bucket = np.concatenate(
            [block_bucket, np.full(extra, block_bucket[-1], np.int32)])
        pad_n = extra * block_v
        sort_index = np.concatenate([sort_index, np.zeros(pad_n, np.int64)])
        valid = np.concatenate([valid, np.zeros(pad_n, bool)])
        u_off_s = np.concatenate([u_off_s, np.zeros(pad_n, np.int32)])
        iv0_s = np.concatenate([iv0_s, np.zeros(pad_n, np.int32)])
        uk_s = np.concatenate([uk_s, np.zeros((pad_n, support), np.float32)])
        vk_s = np.concatenate([vk_s, np.zeros((pad_n, support), np.float32)])
        wk_s = np.concatenate([wk_s, np.zeros((pad_n, w_support),
                                              np.float32)])
        u_frac_s = np.concatenate([u_frac_s, np.zeros(pad_n, np.int32)])
        v_frac_s = np.concatenate([v_frac_s, np.zeros(pad_n, np.int32)])
        w_row_s = np.concatenate([w_row_s, np.zeros(pad_n, np.int32)])
        total += pad_n
        num_blocks += extra

    tasks = tuple(
        PackedTask(int(boxes[t, 1]), int(boxes[t, 2]), int(boxes[t, 0]),
                   int(first_t[t]))
        for t in range(num_tasks))

    arrays = dict(sort_index=sort_index, valid=valid, u_off=u_off_s,
                  iv0=iv0_s, uk=uk_s, vk=vk_s, wk=wk_s,
                  u_frac=u_frac_s, v_frac=v_frac_s, w_row=w_row_s,
                  block_bucket=block_bucket, visited=visited)
    # Every array the gridder consumes must be covered: u_frac/v_frac/
    # w_row feed the device tap evaluation — two plans differing only
    # in sub-cell fractions must NOT alias in the gridder cache.
    digest_names = ("sort_index", "valid", "u_off", "iv0",
                    "u_frac", "v_frac", "w_row",
                    "block_bucket", "visited")
    task_bytes = "".join(repr(t) for t in tasks).encode()
    digest = native_runtime.hash_arrays(
        [arrays[n] for n in digest_names]
        + [np.frombuffer(task_bytes, np.uint8)])
    if digest is None:
        h = hashlib.sha256()
        for name in digest_names:
            h.update(np.ascontiguousarray(arrays[name]).tobytes())
        h.update(task_bytes)
        digest = h.hexdigest()

    return PackedPlan(
        wplan=wplan, tasks=tasks, num_rows=num_rows,
        num_layers=num_layers,
        num_slabs=num_slabs, num_octets=num_octets, block_v=block_v,
        total=total, num_blocks=num_blocks, num_buckets=num_buckets,
        digest=digest, arrays=arrays)


# ---------------------------------------------------------------------------
# Device driver
# ---------------------------------------------------------------------------


def _time_call(f, args, iters: int) -> float:
    """Mean seconds of ``f(*args)`` to ``block_until_ready``, after one
    warm-up (compile) call."""
    import time

    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(f(*args))
    return (time.perf_counter() - t0) / iters

# Bounded LRU: each gridder pins large device arrays (the taps alone are
# ~84 B per stream slot), so an unbounded cache leaks device memory
# across re-plans (new pointing / time chunk). Solvers hold their own
# strong reference, so eviction only drops standby compilations.
_GRIDDER_CACHE: "dict" = {}
_GRIDDER_CACHE_MAX = 4

# Default precision of the kernels' products: "high" is the bf16 hi/lo
# split (three single-pass bf16 products with f32 accumulation),
# "highest" true f32, "bf16" one single-pass product (also fast=True).
_DEFAULT_PRECISION = "high"


def make_taps(u_off, iv0, u_frac, v_frac, w_row, valid, uv_coeffs,
              w_coeffs, oversampling: int, w_oversampling: int) -> Taps:
    """Per-slot kernel operands from the integer plan fields: taps from
    the Chebyshev fits (fit error ~1e-13 vs the f64 tables), w taps
    zeroed on invalid slots."""
    from ..grid_data.kernels import eval_kernel_taps

    uk = eval_kernel_taps(u_frac, uv_coeffs, oversampling)
    vk = eval_kernel_taps(v_frac, uv_coeffs, oversampling)
    wk = jnp.where(valid[:, None],
                   eval_kernel_taps(w_row, w_coeffs, w_oversampling), 0.0)
    return Taps(u_off.astype(jnp.int32), iv0.astype(jnp.int32),
                uk.T.astype(jnp.float32), vk.T.astype(jnp.float32),
                wk.T.astype(jnp.float32))


def _taps_specs(axis_name: str) -> Taps:
    """Shard specs of the per-slot operands (stream axis last)."""
    from jax.sharding import PartitionSpec as P

    return Taps(P(axis_name), P(axis_name), P(None, axis_name),
                P(None, axis_name), P(None, axis_name))


def packed_gridder(pplan: PackedPlan, fast: bool = False,
                   precision: str = None):
    """Per-plan device driver (LRU-cached by the plan's content digest)."""
    # Resolve the default BEFORE keying: packed_gridder(p) and
    # packed_gridder(p, precision="high") must share one cache entry.
    if precision is None:
        precision = "bf16" if fast else _DEFAULT_PRECISION
    key = (pplan, precision)
    g = _GRIDDER_CACHE.pop(key, None)
    if g is None:
        g = PackedGridder(pplan, precision=precision)
    _GRIDDER_CACHE[key] = g          # re-insert: most-recently-used
    while len(_GRIDDER_CACHE) > _GRIDDER_CACHE_MAX:
        _GRIDDER_CACHE.pop(next(iter(_GRIDDER_CACHE)))
    return g


class PackedGridder:
    """Holds the per-plan device arrays and jitted whole-image drivers.

    ``grid``/``degrid`` take/return visibilities in the natural
    ``[rows, chan]`` layout; ``grid_sorted``/``degrid_sorted`` work on
    the plan's sorted stream (the major-cycle solver keeps residual
    visibilities in sorted form so the per-iteration permutation
    gathers vanish).
    """

    def __init__(self, pplan: PackedPlan, fast: bool = False,
                 precision: str = None):
        self.pplan = pplan
        if precision is None:
            precision = "bf16" if fast else _DEFAULT_PRECISION
        self.precision = precision
        plan = pplan.wplan
        kernel = plan.kernel()
        self._kernel = kernel
        arrays = pplan.arrays
        if arrays is None:
            raise SdpInvalidArgumentError("plan has no host arrays")
        if pplan.total >= 2 ** 31 or arrays["sort_index"].max(
                initial=0) >= 2 ** 31:
            raise SdpInvalidArgumentError(
                "packed stream too large for int32 indexing")

        self.sort_index = jnp.asarray(arrays["sort_index"].astype(np.int32))
        self.valid = jnp.asarray(arrays["valid"])
        from .bucketed import inverse_index_of

        self.inv_index = jnp.asarray(inverse_index_of(
            arrays["sort_index"], arrays["valid"],
            pplan.num_rows * plan.num_chan).astype(np.int32))
        # Per-block (task, w-slab, u-octet) of the bucket it belongs to.
        bb = arrays["block_bucket"].astype(np.int64)
        octet = bb % pplan.num_octets
        slab = (bb // pplan.num_octets) % pplan.num_slabs
        task = bb // (pplan.num_octets * pplan.num_slabs)
        self.g_idx = jnp.asarray(octet.astype(np.int32))
        self.t_idx = jnp.asarray(task.astype(np.int32))
        self.k_idx = jnp.asarray(slab.astype(np.int32))

        # The plan ships the integer oversampled kernel rows; the tap
        # values are evaluated on the device from the Chebyshev fits.
        from ..grid_data.wtower import _tap_coeffs_cached

        uv_c = _tap_coeffs_cached(plan.support, plan.oversampling)
        w_c = _tap_coeffs_cached(plan.w_support, plan.w_oversampling)
        self.taps = jax.jit(
            lambda *a: make_taps(*a, uv_c, w_c, plan.oversampling,
                                 plan.w_oversampling))(
            jnp.asarray(arrays["u_off"]), jnp.asarray(arrays["iv0"]),
            jnp.asarray(arrays["u_frac"]), jnp.asarray(arrays["v_frac"]),
            jnp.asarray(arrays["w_row"]), self.valid)

        # Shared w-pattern ladders + per-task prefactors (host numpy
        # c128 -> device c64).
        w_pattern = kernel.w_pattern            # [N, N] c128
        sw = plan.w_support
        karange = np.arange(pplan.num_layers)
        ladder_g = w_pattern[None] ** karange[:, None, None]
        ladder_d = w_pattern[None] ** (-karange[:, None, None])
        e0_g = np.asarray([t.first_w_plane + sw // 2 - sw
                           for t in pplan.tasks])
        e0_d = np.asarray([sw // 2 - t.first_w_plane
                           for t in pplan.tasks])
        pref_g = w_pattern[None] ** e0_g[:, None, None]
        pref_d = w_pattern[None] ** e0_d[:, None, None]
        self.ladder_grid = jnp.asarray(ladder_g.astype(np.complex64))
        self.ladder_degrid = jnp.asarray(ladder_d.astype(np.complex64))
        self.pref_grid = jnp.asarray(pref_g.astype(np.complex64))
        self.pref_degrid = jnp.asarray(pref_d.astype(np.complex64))
        # Host copies for the task-sharded mesh drivers (per-shard
        # zero-padded prefactor slices are built per mesh size).
        self._pref_g_host = pref_g.astype(np.complex64)
        self._pref_d_host = pref_d.astype(np.complex64)

        # Precomputed per-plane w-screen stacks (static per plan; jit
        # ARGUMENTS, not closures — rebuilding them in-jit costs ~P*N^2
        # sin/cos per call).
        w_offs = tuple(self._plane_offsets())
        self.screens_grid = jax.jit(
            lambda: _plane_screens(kernel, w_offs, True))()
        self.screens_degrid = jax.jit(
            lambda: _plane_screens(kernel, w_offs, False))()

        self._grid_jit = jax.jit(self._grid_impl)
        self._degrid_jit = jax.jit(self._degrid_impl)
        self._sort_jit = jax.jit(self._sort_impl)
        self._unsort_jit = jax.jit(self._unsort_impl)
        self._sharded_cache: dict = {}
        self._shard_meta_cache: dict = {}

    # -- sorted-stream transforms ------------------------------------

    def _sort_impl(self, vis, sort_index, valid):
        vis_s = vis.reshape(-1)[sort_index]
        vre = jnp.where(valid, vis_s.real, 0.0).astype(jnp.float32)
        vim = jnp.where(valid, vis_s.imag, 0.0).astype(jnp.float32)
        return vre, vim

    def sort(self, vis: Array):
        """[rows, chan] visibilities -> sorted-stream (re, im) pair."""
        return self._sort_jit(vis, self.sort_index, self.valid)

    def _unsort_impl(self, vis_sorted, inv_index):
        # Gather through the host-precomputed inverse permutation (an
        # XLA scatter at this size costs ~15 ms on the attached chip);
        # pad/dropped entries point at the guaranteed-zero final slot.
        out_padded = jnp.concatenate(
            [vis_sorted, jnp.zeros((1,), vis_sorted.dtype)])
        return out_padded[inv_index].reshape(
            self.pplan.num_rows, self.pplan.wplan.num_chan)

    def unsort(self, vis_sorted: Array):
        """Sorted-stream complex vis -> [rows, chan]."""
        return self._unsort_jit(vis_sorted, self.inv_index)

    # -- grid ----------------------------------------------------------

    # Grid pipeline stages (composable so report_timing can measure
    # marginal device time per stage; see _grid_impl for the flow).

    def _stage_kernel(self, vre, vim, taps, block_idx):
        pplan = self.pplan
        t_idx, k_idx, g_idx = block_idx
        return grid_stack(
            taps, t_idx, k_idx, g_idx, vre, vim, len(pplan.tasks),
            pplan.num_layers, pplan.wplan.subgrid_size, pplan.block_v,
            self.precision)

    def _stage_drain(self, layers, ladder, pref):
        layers = ifft_shifted(layers)
        # HIGHEST: the ladder carries w phases (no TF32 products).
        subgrids = jnp.einsum("tkuv,kuv->tuv", layers, ladder,
                              precision=jax.lax.Precision.HIGHEST) * pref
        return fft_shifted(subgrids)

    def _stage_planes(self, subgrids, screens=None):
        pplan = self.pplan
        plan = pplan.wplan
        image_size = plan.image_size
        sg_factor = (image_size / plan.subgrid_size) ** 2
        per_plane = {iw: jnp.zeros((image_size, image_size),
                                   jnp.complex64)
                     for iw in pplan.w_plane_ids}
        for t, task in enumerate(pplan.tasks):
            per_plane[task.iw] = subgrid_add_static(
                per_plane[task.iw], -task.iu * plan.eff_sg_size,
                -task.iv * plan.eff_sg_size, subgrids[t], sg_factor)
        planes = jnp.stack([per_plane[iw] for iw in pplan.w_plane_ids])
        return _planes_to_image(self._kernel, planes,
                                self._plane_offsets(), screens=screens)

    def _stack_to_layers(self, stack):
        """[T, 2, K*(G+8), G] stack-kernel output -> [T, K, G, G]
        complex layers (crop the always-zero 8-row octet overhang and
        combine the re/im planes). ``T`` is taken from the stack (the
        sharded bodies pass per-shard stacks)."""
        pplan = self.pplan
        G = pplan.wplan.subgrid_size
        st = stack.reshape(stack.shape[0], 2, pplan.num_layers,
                           G + 8, G)[:, :, :, :G, :]
        return jax.lax.complex(st[:, 0], st[:, 1])

    def _layers_to_stack(self, layers):
        """[T, K, G, G] complex layers -> task-major [T, 2, K*(G+8),
        G] f32 stack (the degrid kernels' input form; the 8-row u-pad
        holds the last octet's window overhang)."""
        pplan = self.pplan
        G = pplan.wplan.subgrid_size
        st = jnp.stack([layers.real.astype(jnp.float32),
                        layers.imag.astype(jnp.float32)], axis=1)
        st = jnp.pad(st, ((0, 0), (0, 0), (0, 0), (0, 8), (0, 0)))
        return st.reshape(layers.shape[0], 2,
                          pplan.num_layers * (G + 8), G)

    def _grid_impl(self, vre, vim, taps, block_idx,
                   ladder, pref, screens):
        out = self._stage_kernel(vre, vim, taps, block_idx)
        layers = self._stack_to_layers(out)
        subgrids = self._stage_drain(layers, ladder, pref)
        return self._stage_planes(subgrids, screens)

    def _grid_indices(self):
        return (self.t_idx, self.k_idx, self.g_idx)

    def grid_sorted(self, vre: Array, vim: Array) -> Array:
        """Sorted-stream (re, im) f32 -> real dirty image (f32)."""
        return self._grid_jit(vre, vim, self.taps,
                              self._grid_indices(),
                              self.ladder_grid,
                              self.pref_grid, self.screens_grid)

    def grid(self, vis: Array) -> Array:
        """[rows, chan] visibilities -> real dirty image."""
        vre, vim = self.sort(vis)
        return self.grid_sorted(vre, vim)

    # -- degrid ---------------------------------------------------------

    # Degrid pipeline stages (composable so report_timing_degrid can
    # measure marginal device time per stage).

    def _dstage_planes(self, image, screens=None):
        return _image_to_plane_stack(self._kernel, image,
                                     self._plane_offsets(),
                                     screens=screens)

    def _dstage_layers(self, plane_stack, ladder, pref):
        pplan = self.pplan
        plan = pplan.wplan
        sgs = plan.subgrid_size
        plane_pos = {iw: i for i, iw in enumerate(pplan.w_plane_ids)}
        subgrids = jnp.stack([
            subgrid_cut_out_static(
                plane_stack[plane_pos[task.iw]],
                task.iu * plan.eff_sg_size,
                task.iv * plan.eff_sg_size, sgs)
            for task in pplan.tasks]).astype(jnp.complex64)
        subgrids = ifft_shifted_norm(subgrids)
        layers = fft_shifted(
            (subgrids * pref)[:, None, :, :] * ladder[None])
        return self._layers_to_stack(layers)

    def _dstage_kernel(self, st, taps, block_idx):
        t_idx, k_idx, g_idx = block_idx
        re, im = degrid_stack(st, taps, t_idx, k_idx, g_idx,
                              self.pplan.block_v, self.precision)
        return jax.lax.complex(re, im)

    def _degrid_impl(self, image, taps, block_idx, ladder, pref,
                     screens):
        plane_stack = self._dstage_planes(image, screens)
        st = self._dstage_layers(plane_stack, ladder, pref)
        return self._dstage_kernel(st, taps, block_idx)

    def _degrid_indices(self):
        return (self.t_idx, self.k_idx, self.g_idx)

    def degrid_sorted(self, image: Array) -> Array:
        """Real/complex image -> sorted-stream complex64 visibilities."""
        return self._degrid_jit(image, self.taps,
                                self._degrid_indices(),
                                self.ladder_degrid, self.pref_degrid,
                                self.screens_degrid)

    def degrid(self, image: Array) -> Array:
        """Image -> [rows, chan] complex64 visibilities."""
        return self.unsort(self.degrid_sorted(image))

    # -- stage timing report --------------------------------------------

    def report_timing(self, vre: Array, vim: Array, iters: int = 10,
                      print_fn=print):
        """Per-stage device-time report for one grid pass — the
        analogue of the reference's per-run report
        (sdp_grid_wstack_wtower.cpp:169-213, CUDA-event timers).

        Each pipeline prefix is timed to ``block_until_ready`` after a
        warm-up call; stage times are the marginal prefix deltas,
        recorded into a
        :class:`~ska_sdp_func_jax.utility.timers.Timers` tree.
        """
        from ..utility.timers import TimerType, Timers

        args = (self.taps, self._grid_indices(),
                self.ladder_grid, self.pref_grid,
                self.screens_grid)

        def upto(n):
            # Each prefix returns a SCALAR reduction computed inside
            # the jit, so no GB-scale intermediate leaves the jit.
            def red_in(x):
                if jnp.iscomplexobj(x):
                    return jnp.sum(jnp.abs(x.real)) \
                        + jnp.sum(jnp.abs(x.imag))
                return jnp.sum(jnp.abs(x))

            def f(vre, vim, ops, bb, ladder, pref,
                  screens):
                out = self._stage_kernel(vre, vim, ops, bb)
                if n == 0:
                    return red_in(out)
                layers = self._stack_to_layers(out)
                if n == 1:
                    return red_in(layers)
                subgrids = self._stage_drain(layers, ladder, pref)
                if n == 2:
                    return red_in(subgrids)
                return red_in(self._stage_planes(subgrids, screens))
            return jax.jit(f)

        names = ("stack kernel", "stack -> layers",
                 "ifft + w ladder + fft", "subgrid adds + correction")
        prefix_t = []
        for n in range(4):
            prefix_t.append(_time_call(upto(n), (vre, vim) + args, iters))

        plan = self.pplan.wplan
        timers = Timers("grid_all (packed) device time / call",
                        TimerType.DEVICE)
        prev = 0.0
        for name, t in zip(names, prefix_t):
            timers.record(name, max(t - prev, 0.0))
            prev = t
        if print_fn is not None:
            print_fn(
                f"# image {plan.image_size}^2, subgrid "
                f"{plan.subgrid_size}, {len(self.pplan.tasks)} tasks, "
                f"{len(self.pplan.w_plane_ids)} w-planes, "
                f"{self.pplan.num_layers} tower layers, "
                f"{self.pplan.total} stream slots "
                f"({self.pplan.num_blocks} blocks), w_step "
                f"{plan.w_step}, tower height {plan.w_tower_height}")
        timers._root.timer.pause()
        timers._root.timer._elapsed = prefix_t[-1]
        timers.report(print_fn)
        return dict(zip(names, [max(b - a, 0.0) for a, b in
                                zip([0.0] + prefix_t[:-1], prefix_t)]))

    def report_timing_degrid(self, image: Array, iters: int = 10,
                             print_fn=print):
        """Per-stage device-time report for one degrid pass (the mirror
        of :meth:`report_timing`, timed the same way)."""
        from ..utility.timers import TimerType, Timers

        args = (self.taps,
                self._degrid_indices(), self.ladder_degrid,
                self.pref_degrid, self.screens_degrid)

        def upto(n):
            # Scalar reduction inside the jit — see report_timing.
            def red_in(x):
                if jnp.iscomplexobj(x):
                    return jnp.sum(jnp.abs(x.real)) \
                        + jnp.sum(jnp.abs(x.imag))
                return jnp.sum(jnp.abs(x))

            def f(img, ops, bb, ladder, pref, screens):
                planes = self._dstage_planes(img, screens)
                if n == 0:
                    return red_in(planes)
                st = self._dstage_layers(planes, ladder, pref)
                if n == 1:
                    return red_in(st)
                return red_in(self._dstage_kernel(st, ops, bb))
            return jax.jit(f)

        names = ("plane FFTs + screens", "cut-outs + ladder + layer fft",
                 "degrid kernel")
        prefix_t = []
        image = jnp.asarray(image, jnp.float32)
        for n in range(3):
            prefix_t.append(_time_call(upto(n), (image,) + args, iters))

        timers = Timers("degrid_all (packed) device time / call",
                        TimerType.DEVICE)
        prev = 0.0
        for name, t in zip(names, prefix_t):
            timers.record(name, max(t - prev, 0.0))
            prev = t
        timers._root.timer.pause()
        timers._root.timer._elapsed = prefix_t[-1]
        timers.report(print_fn)
        return dict(zip(names, [max(b - a, 0.0) for a, b in
                                zip([0.0] + prefix_t[:-1], prefix_t)]))

    # -- mesh-sharded drivers -------------------------------------------
    #
    # True O(V / n_chips) multi-chip ingest: the sorted block stream is
    # sharded contiguously across the mesh (plan with
    # ``pad_blocks_to=n_devices``); every chip runs the SAME packed
    # pipeline over its own blocks and partial images reduce with
    # `psum`. This replaces the bucketed sharded driver's O(tasks x V)
    # per-task masking loop.

    def _mesh_key(self, mesh, axis_name):
        return (tuple(int(d.id) for d in mesh.devices.flat),
                tuple(mesh.axis_names), axis_name)

    def _check_mesh(self, mesh):
        ndev = int(mesh.devices.size)
        if self.pplan.num_blocks % ndev:
            raise SdpInvalidArgumentError(
                f"num_blocks ({self.pplan.num_blocks}) not divisible by "
                f"{ndev} devices — build the plan with "
                f"pad_blocks_to={ndev}")

    def _shard_meta(self, n: int):
        """Host metadata for the task-sharded mesh drivers.

        Blocks shard contiguously, and blocks are bucket-sorted with
        the task index major — so each shard's blocks reference a
        CONTIGUOUS task range. The fold/drain stages then run over at
        most ``Tp = max_s(tasks touched by shard s)`` tasks per shard
        instead of all T: without this, every chip re-ran the full
        per-task FFT drain and the iteration rate stopped scaling once
        T-sized drain work matched the sharded kernel work.
        """
        meta = self._shard_meta_cache.get(n)
        if meta is not None:
            return meta
        pplan = self.pplan
        S, G, Kmax = pplan.num_slabs, pplan.num_octets, pplan.num_layers
        NB = pplan.num_blocks
        bps = NB // n
        bb = pplan.arrays["block_bucket"].astype(np.int64)
        task_of_block = bb // (S * G)
        slab_of_block = (bb // G) % S
        t0 = task_of_block[0::bps][:n]
        t1 = task_of_block[bps - 1::bps][:n]
        tp = int((t1 - t0 + 1).max())

        base = (t0 * S * G).repeat(bps)
        bb_local = (bb - base).astype(np.int32)
        p_idx_local = ((task_of_block - t0.repeat(bps)) * Kmax
                       + slab_of_block).astype(np.int32)

        plan = pplan.wplan
        plane_ids = list(pplan.w_plane_ids)
        plane_pos = {iw: i for i, iw in enumerate(plane_ids)}
        T = len(pplan.tasks)
        iu_eff = np.zeros(n * tp, np.int32)
        iv_eff = np.zeros(n * tp, np.int32)
        pidx = np.zeros(n * tp, np.int32)
        vmask = np.zeros(n * tp, bool)
        for s in range(n):
            for j in range(tp):
                t = int(t0[s]) + j
                if t > int(t1[s]) or t >= T:
                    continue
                task = pplan.tasks[t]
                iu_eff[s * tp + j] = task.iu * plan.eff_sg_size
                iv_eff[s * tp + j] = task.iv * plan.eff_sg_size
                pidx[s * tp + j] = plane_pos[task.iw]
                vmask[s * tp + j] = True

        sgs = plan.subgrid_size
        zpad = np.zeros((tp, sgs, sgs), np.complex64)
        meta = dict(
            tp=tp,
            bb_local=jnp.asarray(bb_local),
            p_idx_local=jnp.asarray(p_idx_local),
            t0=jnp.asarray(t0.astype(np.int32)),
            iu_eff=jnp.asarray(iu_eff),
            iv_eff=jnp.asarray(iv_eff),
            pidx=jnp.asarray(pidx),
            vmask=jnp.asarray(vmask),
            pref_g_pad=jnp.asarray(
                np.concatenate([self._pref_g_host, zpad])),
            pref_d_pad=jnp.asarray(
                np.concatenate([self._pref_d_host, zpad])),
        )
        self._shard_meta_cache[n] = meta
        return meta

    def _plane_offsets(self):
        plan = self.pplan.wplan
        return [int(np.trunc(iw * plan.w_tower_height))
                for iw in self.pplan.w_plane_ids]

    def grid_sorted_sharded(self, vre: Array, vim: Array, mesh,
                            axis_name: str = "rows") -> Array:
        from jax.sharding import PartitionSpec as P

        self._check_mesh(mesh)
        key = ("grid", self._mesh_key(mesh, axis_name))
        fn = self._sharded_cache.get(key)
        n = int(mesh.devices.size)
        meta = self._shard_meta(n)
        if fn is None:
            pplan = self.pplan
            plan = pplan.wplan
            sgs = plan.subgrid_size
            N = plan.image_size
            S, G = pplan.num_slabs, pplan.num_octets
            tp = meta["tp"]
            sg_factor = (N / sgs) ** 2
            num_p = len(self._plane_offsets())
            w_offsets = self._plane_offsets()
            kernel = self._kernel

            def body(vre_c, vim_c, taps_c, bb_loc_c,
                     t0_c, iu_c, iv_c, pl_c, vm_c, ladder, pref_pad):
                # Shard-local: per-block (task, slab, octet) derive
                # from the local block->bucket map; tasks with no
                # blocks in this shard are masked and straddled tasks
                # sum through the planes psum.
                t_loc = bb_loc_c // (S * G)
                k_loc = (bb_loc_c // G) % S
                g_loc = bb_loc_c % G
                stack = grid_stack(
                    taps_c, t_loc, k_loc, g_loc, vre_c, vim_c, tp,
                    pplan.num_layers, sgs, pplan.block_v,
                    self.precision)
                layers = self._stack_to_layers(stack)
                # Defense-in-depth: with contiguous block sharding
                # every task in [t0, t1] has >= 1 local block, so
                # this duplicates the vm_c masking in the canvas scan
                # — kept so a degenerate plan can never leak an
                # uninitialised stack.
                tvis = jnp.zeros((tp,), bool).at[t_loc].set(True)
                layers = jnp.where(tvis[:, None, None, None],
                                   layers, 0)
                z = jnp.zeros((), t0_c.dtype)
                pref_local = jax.lax.dynamic_slice(
                    pref_pad, (t0_c[0], z, z), (tp, sgs, sgs))
                subgrids = self._stage_drain(layers, ladder, pref_local)

                # Shard-local wrap-around adds onto a halo canvas; the
                # halo folds back once, so the per-task offsets can be
                # traced (dynamic) without scatter lowering.
                canvas = jnp.zeros((num_p, N + sgs, N + sgs),
                                   jnp.complex64)

                def step(c, xs):
                    sub, iu, iv, pid, vm = xs
                    su = jnp.mod(N // 2 - sgs // 2 + iu, N)
                    sv = jnp.mod(N // 2 - sgs // 2 + iv, N)
                    patch = jax.lax.dynamic_slice(
                        c, (pid, su, sv), (1, sgs, sgs))
                    contrib = jnp.where(
                        vm, (sub * sg_factor).astype(c.dtype), 0)
                    return jax.lax.dynamic_update_slice(
                        c, patch + contrib[None], (pid, su, sv)), None

                canvas, _ = jax.lax.scan(
                    step, canvas, (subgrids, iu_c, iv_c, pl_c, vm_c))
                planes = canvas[:, :N, :] \
                    .at[:, :sgs, :].add(canvas[:, N:, :])
                planes = planes[:, :, :N] \
                    .at[:, :, :sgs].add(planes[:, :, N:])
                planes = jax.lax.psum(planes, axis_name)
                return _planes_to_image(kernel, planes, w_offsets)

            fn = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(P(axis_name), P(axis_name),
                          _taps_specs(axis_name),
                          P(axis_name),
                          P(axis_name), P(axis_name), P(axis_name),
                          P(axis_name), P(axis_name), P(), P()),
                out_specs=P(), check_vma=False))
            self._sharded_cache[key] = fn
        return fn(vre, vim, self.taps,
                  meta["bb_local"], meta["t0"], meta["iu_eff"],
                  meta["iv_eff"], meta["pidx"], meta["vmask"],
                  self.ladder_grid, meta["pref_g_pad"])

    def grid_sharded(self, vis: Array, mesh,
                     axis_name: str = "rows") -> Array:
        vre, vim = self.sort(jnp.asarray(vis))
        return self.grid_sorted_sharded(vre, vim, mesh, axis_name)

    def degrid_sorted_sharded(self, image: Array, mesh,
                              axis_name: str = "rows") -> Array:
        from jax.sharding import PartitionSpec as P

        self._check_mesh(mesh)
        key = ("degrid", self._mesh_key(mesh, axis_name))
        fn = self._sharded_cache.get(key)
        n = int(mesh.devices.size)
        meta = self._shard_meta(n)
        if fn is None:
            pplan = self.pplan
            plan = pplan.wplan
            sgs = plan.subgrid_size
            N = plan.image_size
            tp = meta["tp"]
            w_offsets = self._plane_offsets()
            kernel = self._kernel

            def body(image_r, taps_c, p_loc_c, g_c,
                     t0_c, iu_c, iv_c, pl_c, ladder, pref_pad):
                # Replicated per-plane FFTs (few planes, image-sized,
                # batched); everything per-task below runs on the
                # shard's own task range only.
                plane_stack = _image_to_plane_stack(kernel, image_r,
                                                    w_offsets)
                canvas = jnp.zeros(
                    (plane_stack.shape[0], N + sgs, N + sgs),
                    jnp.complex64)
                canvas = canvas.at[:, :N, :N].set(plane_stack)
                canvas = canvas.at[:, N:, :N].set(plane_stack[:, :sgs])
                canvas = canvas.at[:, :N, N:].set(
                    plane_stack[:, :, :sgs])
                canvas = canvas.at[:, N:, N:].set(
                    plane_stack[:, :sgs, :sgs])

                def cut(iu, iv, pid):
                    su = jnp.mod(N // 2 - sgs // 2 + iu, N)
                    sv = jnp.mod(N // 2 - sgs // 2 + iv, N)
                    return jax.lax.dynamic_slice(
                        canvas, (pid, su, sv), (1, sgs, sgs))[0]

                subgrids = jax.vmap(cut)(iu_c, iv_c, pl_c)
                subgrids = ifft_shifted_norm(subgrids)
                z = jnp.zeros((), t0_c.dtype)
                pref_local = jax.lax.dynamic_slice(
                    pref_pad, (t0_c[0], z, z), (tp, sgs, sgs))
                layers = fft_shifted(
                    (subgrids * pref_local)[:, None, :, :]
                    * ladder[None])
                # Shard-local tasks: p_loc_c = local_task * Kmax +
                # slab, so t/k derive by divmod.
                st = self._layers_to_stack(layers)
                t_loc = p_loc_c // pplan.num_layers
                k_loc = p_loc_c % pplan.num_layers
                return self._dstage_kernel(st, taps_c,
                                           (t_loc, k_loc, g_c))

            fn = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(P(), _taps_specs(axis_name),
                          P(axis_name), P(axis_name),
                          P(axis_name), P(axis_name), P(axis_name),
                          P(axis_name), P(), P()),
                out_specs=P(axis_name), check_vma=False))
            self._sharded_cache[key] = fn
        return fn(image, self.taps,
                  meta["p_idx_local"], self.g_idx,
                  meta["t0"], meta["iu_eff"], meta["iv_eff"],
                  meta["pidx"], self.ladder_degrid, meta["pref_d_pad"])

    def degrid_sharded(self, image: Array, mesh,
                       axis_name: str = "rows") -> Array:
        return self.unsort(
            self.degrid_sorted_sharded(image, mesh, axis_name))


# ---------------------------------------------------------------------------
# Functional API (parity with the bucketed drivers)
# ---------------------------------------------------------------------------


def grid_all_packed(pplan: PackedPlan, vis: Array,
                    fast: bool = False,
                    precision: str = None) -> Array:
    """Whole-image gridding through the packed path. Returns the real
    dirty image (f32)."""
    return packed_gridder(pplan, fast,
                          precision=precision).grid(jnp.asarray(vis))


def degrid_all_packed(pplan: PackedPlan, image: Array,
                      fast: bool = False,
                      precision: str = None) -> Array:
    """Whole-image degridding through the packed path. Returns
    [rows, chan] complex64 visibilities."""
    return packed_gridder(pplan, fast,
                          precision=precision).degrid(jnp.asarray(image))


def grid_all_packed_sharded(pplan: PackedPlan, vis: Array, mesh,
                            axis_name: str = "rows",
                            fast: bool = False,
                            precision: str = None) -> Array:
    """Mesh-sharded packed gridding (blocks sharded, images psum'd).
    The plan must be built with ``pad_blocks_to=mesh.devices.size``."""
    return packed_gridder(pplan, fast, precision=precision).grid_sharded(
        vis, mesh, axis_name)


def degrid_all_packed_sharded(pplan: PackedPlan, image: Array, mesh,
                              axis_name: str = "rows",
                              fast: bool = False,
                              precision: str = None) -> Array:
    """Mesh-sharded packed degridding (replicated image, sharded
    blocks)."""
    return packed_gridder(pplan, fast, precision=precision
                          ).degrid_sharded(image, mesh, axis_name)
