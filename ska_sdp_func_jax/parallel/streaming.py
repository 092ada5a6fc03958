"""Chunked whole-survey gridding with ON-DEVICE planning.

The packed driver (:mod:`.packed`) plans on the host, single-core, for
bucket sort + tap addressing. That is the right trade for solvers
(plan once, iterate many times), but an *ingest* pass — grid an entire
observation once — is then host-bound. At SKA scale (1e9+
visibilities, too large for device-resident plans anyway) the planner,
not the device, would set the throughput.

This module moves the per-visibility planning INTO the jitted graph so
a visibility chunk goes host->device once and everything else —
geometry quantisation, bucket assignment, stable sort, padding, tap
evaluation, gridding, accumulation — runs on the device:

1. **Static stream geometry** (host, once per observation): the task
   boxes are fixed up front (:func:`stream_tasks` pre-scans uvw
   metadata with the native planner; or pass the boxes you expect to
   cover). Per-task w-tower ranges derive from the *box* w-interval —
   every w that maps to the box fits its tower — so layer counts,
   bucket counts and the block layout are compile-time constants.
2. **Device planning** (per chunk, inside one jit): the same quantised
   geometry arithmetic as ``plan_packed`` (cited there from
   sdp_gridder_wtower_uvw.cpp:126-142) in f32; every per-entry
   quantity (including the visibilities) rides variadic ``lax.sort``
   payloads into bucket order, and one gather places the sorted
   stream into the fixed-capacity padded stream. The taps of the
   placed stream feed the packed kernel and the shared
   FFT/ladder/correction stages.
3. **Accumulation**: the dirty-image accumulator and the
   processed/dropped/overflow counters live on device, so a chunk
   costs exactly one H2D transfer (uvw + vis) and zero readbacks;
   :meth:`StreamingGridder.finalize` reads the counters once and
   enforces the processed-visibility invariant
   (reference: sdp_grid_wstack_wtower.cpp:442-448).

Precision note: the host planner quantises in f64 and is the oracle;
the device planner quantises in f32. Absolute u error is ~6e-8
relative (|u| up to ~1e4 wavelengths -> ~6e-4 wavelengths), i.e.
~0.02 oversample bins at theta*ov ~ 33 bins/wavelength — two orders
below the tap quantisation itself. A visibility landing within that
slack of a pixel/box boundary may round to the neighbouring
subgrid/oversample bin: a *valid alternative placement* whose image
effect is bounded by the oversampling step, well inside the f32
path's measured 2.5e-4 accuracy envelope. The device path is
self-consistent (the same f32 geometry picks the bucket AND the
taps), so no visibility is ever half-assigned.

Capacity: the padded stream length is fixed at
``ceil(chunk_vis * cap_factor)`` slots. A chunk whose bucket padding
exceeds it contributes NOTHING (the whole chunk is voided and
counted — never a silently truncated image) and finalize raises;
raise ``cap_factor`` or shrink chunks.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..fourier_transforms.fft import fft_shifted, ifft_shifted
from ..grid_data.gridder_utils import subgrid_add_static
from ..kernels.packed_tap import degrid_stack, grid_stack
from ..utility.caches import lru_insert
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpRuntimeError
from .packed import (
    _DEFAULT_PRECISION,
    PackedTask,
    _planes_to_image,
    make_taps,
    packed_geometry_ok,
)
from .wstack import WStackPlan

Array = jax.Array

_ETA = 1e-5   # tower-range guard, mirrors plan_packed / plan_wstack


def stream_tasks(wplan: WStackPlan, uvw) -> np.ndarray:
    """Pre-scan uvw metadata for the occupied task boxes (host).

    Returns ``[T, 3]`` int64 ``(biw, biu, biv)`` boxes. One NumPy pass
    over (row, channel) keys — cheap relative to planning and only
    needed once per observation; for a streaming setting where even
    that is too much, pass the full box lattice the image/w-range can
    host.

    The quantisation here runs in **f32 with the device planner's
    formula** (NOT the host planner's f64): the box set must contain
    every box the device can assign, or a visibility whose f64 and f32
    quantisations straddle a box boundary at the hull of the occupied
    set would be counted dropped and fail an hours-long ingest at
    finalize. Device backends are additionally free to CONTRACT the
    ``x * inv + 0.5`` multiply-add into one fused rounding (LLVM
    re-fuses even across an XLA optimization barrier), which can move
    the coordinate one ulp across an integer — so every entry whose
    coordinate lands within a few ulps of a box edge admits BOTH
    neighbouring boxes (hull dilation; the extra boxes are empty in
    the non-adversarial case and merely idle). Driven end-to-end by
    tests/test_streaming.py::test_box_membership_fma_hull.
    """
    uvw = np.asarray(uvw, np.float64).astype(np.float32)
    # Reciprocal MULTIPLIES, not divisions: a backend's f32 divide may
    # differ by more than the one-ulp contraction neighbourhood.
    inv_d = np.float32(1.0 / wplan.eff_sg_dist)
    inv_wd = np.float32(1.0 / wplan.w_stack_dist)
    scale = ((wplan.freq0_hz + (wplan.dfreq_hz or 10.0)
              * np.arange(wplan.num_chan)) / C_0).astype(np.float32)
    u = (uvw[:, 0:1] * scale[None, :]).ravel()
    v = (uvw[:, 1:2] * scale[None, :]).ravel()
    w = (uvw[:, 2:3] * scale[None, :]).ravel()

    def candidates(x):
        """Box index candidates of f32 coordinate+0.5 values: (floor,
        floor) normally; (rint-1, rint) within the edge ulp
        neighbourhood, covering any single-rounded contraction."""
        lo = np.floor(x).astype(np.int64)
        r = np.rint(x)
        near = np.abs(x - r) <= 8 * np.spacing(
            np.maximum(np.abs(x), np.float32(0.5)))
        ri = r.astype(np.int64)
        return (np.where(near, ri - 1, lo), np.where(near, ri, lo))

    cu = candidates(u * inv_d + np.float32(0.5))
    cv = candidates(v * inv_d + np.float32(0.5))
    cw = candidates(w * inv_wd + np.float32(0.5))
    span = 1 << 20
    keys = np.unique(np.concatenate([
        ((biw + span // 2) * span + (biu + span // 2)) * span
        + (biv + span // 2)
        for biw in cw for biu in cu for biv in cv]))
    return np.stack([keys // (span * span) - span // 2,
                     (keys // span) % span - span // 2,
                     keys % span - span // 2], axis=1)


@dataclass(frozen=True)
class StreamPlan:
    """Static geometry of a visibility stream (fixed task set).

    Unlike :class:`.packed.PackedPlan` there are no per-visibility
    host arrays — the per-chunk plan is computed on device — so two
    StreamPlans are equal iff their geometry is.
    """

    wplan: WStackPlan
    tasks: Tuple[PackedTask, ...]
    chunk_rows: int
    block_v: int
    cap: int                 # padded stream capacity (slots)
    num_layers: int          # Kmax: uniform padded tower depth
    num_slabs: int
    num_octets: int
    num_buckets: int
    # Device-plan lookup tables (derived from `tasks`; excluded from
    # eq/hash like PackedPlan.arrays).
    consts: Dict[str, np.ndarray] = field(compare=False, hash=False,
                                          repr=False, default=None)

    @property
    def w_plane_ids(self):
        return tuple(sorted({t.iw for t in self.tasks}))

    @property
    def num_blocks(self):
        return self.cap // self.block_v


def plan_stream(wplan: WStackPlan, boxes, chunk_rows: int,
                block_v: int = 256, cap_factor: float = 1.5,
                cap_slots: Optional[int] = None) -> StreamPlan:
    """Fix the stream geometry for a task-box set (host, once).

    ``boxes``: ``[T, 3]`` int ``(biw, biu, biv)`` task boxes (from
    :func:`stream_tasks` or chosen a priori). Each task's w-tower
    covers its box's full w-interval ``[biw*wd - wd/2, biw*wd + wd/2]``
    so any visibility mapping to the box fits the tower — towers are
    a little deeper than the data-derived ones of ``plan_packed``, in
    exchange for compile-time-constant layer geometry.

    ``block_v`` is the bucket padding quantum (a multiple of the
    kernels' tile): smaller blocks pad sparse chunks less.
    """
    if not packed_geometry_ok(wplan.subgrid_size, wplan.support,
                              wplan.w_support, wplan.subgrid_frac):
        raise SdpInvalidArgumentError(
            "streaming uses the packed formulation: support <= 8, "
            "2*w_support*16 <= 128, subgrid_size % 128 == 0 and "
            "eff_sg_size + support <= subgrid_size required")
    boxes = np.asarray(boxes, np.int64)
    if boxes.ndim != 2 or boxes.shape[1] != 3 or boxes.shape[0] == 0:
        raise SdpInvalidArgumentError(
            f"boxes must be [T, 3] (biw, biu, biv), got {boxes.shape}")
    # Duplicate boxes would create ambiguous task ids (the LUT maps a
    # box to exactly one task) — dedupe, preserving ascending order.
    boxes = np.unique(boxes, axis=0)
    if chunk_rows <= 0:
        raise SdpInvalidArgumentError("chunk_rows must be positive")
    w_step, height = wplan.w_step, wplan.w_tower_height
    wd = wplan.w_stack_dist

    # Static per-task tower range from the box w-interval (same
    # formulas as plan_packed, with the box bounds as wmin/wmax).
    biw = boxes[:, 0]
    off_w_t = np.trunc(biw * height).astype(np.int64)
    wmin_box = biw * wd - wd / 2
    wmax_box = biw * wd + wd / 2
    first_t = (np.floor(wmin_box / w_step - _ETA).astype(np.int64)
               - off_w_t)
    last_t = (np.ceil(wmax_box / w_step + _ETA).astype(np.int64)
              - off_w_t + 1)
    num_planes_t = 1 + last_t - first_t
    num_layers = int((num_planes_t + wplan.w_support - 1).max())
    num_slabs = num_layers - wplan.w_support + 1
    num_octets = wplan.subgrid_size // 8
    num_tasks = boxes.shape[0]
    num_buckets = num_tasks * num_slabs * num_octets

    # Compact box -> task lookup (dense LUT over the box bounding
    # lattice; -1 = no task there -> visibility counted as dropped).
    b0 = boxes.min(axis=0)
    nb3 = boxes.max(axis=0) - b0 + 1
    if int(np.prod(nb3)) > (1 << 24):
        # One outlier baseline would otherwise inflate the dense
        # lattice (and its HBM copy) to GB scale.
        raise SdpInvalidArgumentError(
            f"task-box bounding lattice {tuple(nb3)} too large for a "
            "dense lookup — filter outlier uvw rows before "
            "stream_tasks, or restrict the box set")
    lut = np.full(int(np.prod(nb3)), -1, np.int32)
    flat = ((boxes[:, 0] - b0[0]) * nb3[1]
            + (boxes[:, 1] - b0[1])) * nb3[2] + (boxes[:, 2] - b0[2])
    lut[flat] = np.arange(num_tasks, dtype=np.int32)
    num_vis = chunk_rows * wplan.num_chan
    # Bucket padding costs up to block_v-1 slots per OCCUPIED bucket:
    # cap_factor ~1.5 suits dense production chunks (measured padding
    # 1.03-1.3x); sparse/small chunks need cap_slots explicitly.
    cap = cap_slots if cap_slots is not None else \
        int(math.ceil(num_vis * cap_factor / block_v)) * block_v
    cap = -(-int(cap) // block_v) * block_v
    # The device plan's padded-offset cumsum and the merge-sort
    # placement keys (up to 3*cap + num_vis) run in int32; the worst
    # padding case is every bucket padded.
    if 3 * cap + num_vis >= 2 ** 31 or \
            num_vis + num_buckets * (block_v - 1) >= 2 ** 31:
        raise SdpInvalidArgumentError(
            "stream capacity / worst-case bucket padding too large "
            "for int32 device indexing — reduce chunk_rows, block_v "
            "or the task-box count")

    tasks = tuple(
        PackedTask(int(boxes[t, 1]), int(boxes[t, 2]),
                   int(boxes[t, 0]), int(first_t[t]))
        for t in range(num_tasks))
    consts = dict(
        lut=lut, b0=b0.astype(np.int32),
        nb3=nb3.astype(np.int32),
        first_t=first_t.astype(np.int32),
        off_w=off_w_t.astype(np.float32),
        num_planes_t=num_planes_t.astype(np.int32))
    return StreamPlan(
        wplan=wplan, tasks=tasks, chunk_rows=int(chunk_rows),
        block_v=int(block_v), cap=cap, num_layers=num_layers,
        num_slabs=num_slabs, num_octets=num_octets,
        num_buckets=num_buckets, consts=consts)


# Compiled chunk-step engines, shared across StreamingGridder
# instances of the same (StreamPlan, fast) — a stream's engine compiles
# once; gridders are thin mutable accumulators. Value-keyed (StreamPlan
# equality is pure geometry), bounded like the other driver caches.
_ENGINE_CACHE: dict = {}


def _stream_engine(splan: StreamPlan, fast: bool) -> "_StreamEngine":
    key = (splan, bool(fast))
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = lru_insert(_ENGINE_CACHE, key, _StreamEngine(splan, fast),
                         max_entries=4)
    return eng


class _StreamEngine:
    """Immutable per-(plan, fast) compiled state: device constants and
    the jitted chunk step."""

    def __init__(self, splan: StreamPlan, fast: bool = False):
        from ..grid_data.wtower import _tap_coeffs_cached

        self.splan = splan
        self.fast = bool(fast)
        plan = splan.wplan
        kernel = plan.kernel()
        self._kernel = kernel
        self._uv_c = _tap_coeffs_cached(plan.support, plan.oversampling)
        self._w_c = _tap_coeffs_cached(plan.w_support,
                                       plan.w_oversampling)
        self.precision = "bf16" if self.fast else _DEFAULT_PRECISION

        # Shared ladders + per-task prefactors (static task set; same
        # construction as PackedGridder, grid AND degrid directions).
        w_pattern = kernel.w_pattern
        sw = plan.w_support
        karange = np.arange(splan.num_layers)
        ladder = w_pattern[None] ** karange[:, None, None]
        e0 = np.asarray([t.first_w_plane + sw // 2 - sw
                         for t in splan.tasks])
        pref = w_pattern[None] ** e0[:, None, None]
        ladder_d = w_pattern[None] ** (-karange[:, None, None])
        e0_d = np.asarray([sw // 2 - t.first_w_plane
                           for t in splan.tasks])
        pref_d = w_pattern[None] ** e0_d[:, None, None]
        self.ladder = jnp.asarray(ladder.astype(np.complex64))
        self.pref = jnp.asarray(pref.astype(np.complex64))
        self.ladder_degrid = jnp.asarray(ladder_d.astype(np.complex64))
        self.pref_degrid = jnp.asarray(pref_d.astype(np.complex64))

        c = splan.consts
        self._lut = jnp.asarray(c["lut"])
        self._first_t = jnp.asarray(c["first_t"])
        self._off_w = jnp.asarray(c["off_w"])
        self._num_planes_t = jnp.asarray(c["num_planes_t"])
        # Host f64 channel scaling, shipped as an f32 constant.
        scale = (plan.freq0_hz + (plan.dfreq_hz or 10.0)
                 * np.arange(plan.num_chan)) / C_0
        self._scale = jnp.asarray(scale.astype(np.float32))

        # No donation: StreamingGridder.image / counters() hand out
        # the live accumulators, and a donated buffer would be
        # invalidated under the caller on the next chunk; the image
        # + three scalars cost one small copy per chunk.
        self.step = jax.jit(self._step_impl)
        self.dstep = jax.jit(self._dstep_impl)
        self.model_stack = jax.jit(self._model_stack_impl)
        self._sharded_cache: dict = {}

    # -- device planning (all jnp, traced) -----------------------------

    def _plan_chunk(self, uvw, row_mask, vre=None, vim=None,
                    cap: int = None, num_blocks: int = None,
                    need_unsort: bool = True):
        """Per-chunk device plan: the quantised geometry of
        plan_packed/packed_entry in f32 (see module precision note).

        ``vre``/``vim``: optional visibility planes [rows, chan] — the
        grid step passes them so they ride the bucket sort as payloads.
        ``cap``/``num_blocks`` default to the plan's stream capacity;
        the mesh-sharded step passes the per-shard split.
        """
        splan = self.splan
        plan = splan.wplan
        cap = splan.cap if cap is None else cap
        num_blocks = (splan.num_blocks if num_blocks is None
                      else num_blocks)
        d = np.float32(plan.eff_sg_dist)
        theta_ov = np.float32(plan.theta * plan.oversampling)
        ov = plan.oversampling
        w_step = np.float32(plan.w_step)
        w_ov_scale = np.float32(plan.w_oversampling / plan.w_step)
        sgs, support = plan.subgrid_size, plan.support
        half_ov = (sgs // 2 - support // 2 + 1) * ov
        nb = splan.num_buckets

        def rha(x):   # round half away from zero
            return jnp.where(x >= 0, jnp.floor(x + 0.5),
                             jnp.ceil(x - 0.5)).astype(jnp.int32)

        u = (uvw[:, 0:1] * self._scale[None, :]).ravel()
        v = (uvw[:, 1:2] * self._scale[None, :]).ravel()
        w = (uvw[:, 2:3] * self._scale[None, :]).ravel()
        mask = jnp.repeat(row_mask, plan.num_chan)

        # Box quantisation via reciprocal multiplies. The backend is
        # free to contract `x * inv + 0.5` into a fused multiply-add
        # (one rounding instead of two), so this may differ from
        # stream_tasks' NumPy pass by one ulp at a box edge.
        # stream_tasks therefore DILATES the host box set by the
        # ulp-neighbourhood of every edge-straddling entry, so any
        # single- or double-rounded device assignment stays inside the
        # planned set (tests/test_streaming.py::
        # test_box_membership_fma_hull drives boundary-straddling uvw).
        inv_d = np.float32(1.0 / plan.eff_sg_dist)
        inv_wd = np.float32(1.0 / plan.w_stack_dist)
        biu = jnp.floor(u * inv_d + 0.5).astype(jnp.int32)
        biv = jnp.floor(v * inv_d + 0.5).astype(jnp.int32)
        biw = jnp.floor(w * inv_wd + 0.5).astype(jnp.int32)
        b0, nb3 = splan.consts["b0"], splan.consts["nb3"]
        i0, i1, i2 = biw - b0[0], biu - b0[1], biv - b0[2]
        inb = ((i0 >= 0) & (i0 < nb3[0]) & (i1 >= 0) & (i1 < nb3[1])
               & (i2 >= 0) & (i2 < nb3[2]))
        li = (i0 * nb3[1] + i1) * nb3[2] + i2
        li = jnp.clip(li, 0, self._lut.shape[0] - 1)
        task = jnp.where(inb, self._lut[li], -1)
        tsafe = jnp.maximum(task, 0)
        first_e = self._first_t[tsafe]
        nplanes_e = self._num_planes_t[tsafe]
        off_w_e = self._off_w[tsafe]

        u_rel = u - biu.astype(jnp.float32) * d
        v_rel = v - biv.astype(jnp.float32) * d
        iu0_ov = rha(u_rel * theta_ov) + half_ov
        iv0_ov = rha(v_rel * theta_ov) + half_ov
        iu0 = jnp.clip(jnp.floor_divide(iu0_ov, ov), 0, sgs - support)
        iv0 = jnp.clip(jnp.floor_divide(iv0_ov, ov), 0, sgs - support)
        u_frac = jnp.mod(iu0_ov, ov)
        v_frac = jnp.mod(iv0_ov, ov)

        w_rel = w - off_w_e * w_step
        j = (jnp.floor(w_rel / w_step).astype(jnp.int32) + 1
             - first_e)
        w_rel2 = w_rel - (first_e + j - 1).astype(
            jnp.float32) * w_step
        w_row = jnp.mod(rha(w_rel2 * w_ov_scale),
                        plan.w_oversampling)

        ok = (mask & (task >= 0) & (j >= 0) & (j < nplanes_e))
        bucket = jnp.where(
            ok, (tsafe * splan.num_slabs + j) * splan.num_octets
            + (iu0 >> 3), nb)

        # Placement: ONE stable key sort carries every per-entry
        # quantity (including the visibilities) into bucket order;
        # each bucket's padded destination follows from the bucket
        # edges, and every block_v-aligned output block is one
        # contiguous range of the sorted stream, so the padded stream
        # is a gather.
        N = bucket.shape[0]
        ops = [bucket, iu0 & 7, iv0, u_frac, v_frac, w_row]
        # The original-index payload only feeds the degrid unsort map;
        # the grid step opts out.
        if need_unsort:
            ops.append(jnp.arange(N, dtype=jnp.int32))
        oidx_pos = len(ops) - 1
        if vre is not None:
            ops += [vre.ravel(), vim.ravel()]
        sorted_ops = jax.lax.sort(tuple(ops), dimension=0,
                                  is_stable=True, num_keys=1)
        b_s = sorted_ops[0]
        oidx_s = sorted_ops[oidx_pos] if need_unsort else None

        # Bucket tables from the sorted keys (edge e = first sorted
        # position with key >= e).
        edges = jnp.searchsorted(
            b_s, jnp.arange(nb + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        counts = edges[1:] - edges[:-1]
        padded = -(-counts // splan.block_v) * splan.block_v
        pad_off = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(padded).astype(jnp.int32)])
        total = pad_off[-1]
        overflow = total > cap

        # Block side: which bucket each output block belongs to, the
        # sorted position of its first slot and its number of real
        # entries (<= 0 on padding blocks past the last bucket).
        slots = jnp.arange(num_blocks,
                           dtype=jnp.int32) * splan.block_v
        block_bucket = jnp.clip(
            jnp.searchsorted(pad_off[1:], slots, side="right"),
            0, nb - 1).astype(jnp.int32)
        off_in_b = slots - pad_off[block_bucket]
        src0 = edges[block_bucket] + off_in_b
        vcnt = jnp.where(overflow, 0,
                         counts[block_bucket] - off_in_b)
        lane = jnp.arange(splan.block_v, dtype=jnp.int32)
        slot_ok = (lane[None, :] < vcnt[:, None]).reshape(-1)
        src = jnp.clip(src0[:, None] + lane[None, :], 0, N - 1
                       ).reshape(-1)

        def placed(x):
            return jnp.where(slot_ok, x[src], jnp.zeros((), x.dtype))

        u_off_p, iv0_p, uf_p, vf_p, wr_p = (placed(sorted_ops[i])
                                            for i in range(1, 6))
        arrays = dict(
            taps=make_taps(u_off_p, iv0_p, uf_p, vf_p, wr_p, slot_ok,
                           self._uv_c, self._w_c, plan.oversampling,
                           plan.w_oversampling),
            nonempty=vcnt > 0)
        if vre is not None:
            arrays["vre"] = placed(sorted_ops[oidx_pos + 1])
            arrays["vim"] = placed(sorted_ops[oidx_pos + 2])
        # On overflow the block range cannot cover every occupied
        # bucket: no block is live (vcnt above) and the chunk is voided.
        processed = jnp.sum(ok & jnp.logical_not(overflow)).astype(
            jnp.int32)
        dropped = jnp.sum(mask & jnp.logical_not(ok)).astype(jnp.int32)
        # Degrid inverse (entry -> slot in ORIGINAL order): for sorted
        # entry k in bucket b, dest = pad_off[b] + (k - edges[b]);
        # unsorting the dest values by the carried original index is
        # one more cheap sort. Invalid entries point at the
        # guaranteed-zero extra slot `cap`.
        dest_by_orig = None
        if need_unsort:
            bsafe = jnp.minimum(b_s, nb - 1)
            dest = (pad_off[bsafe] + jnp.arange(N, dtype=jnp.int32)
                    - edges[bsafe])
            dest_sentinel = jnp.where((b_s < nb) & ~overflow,
                                      jnp.minimum(dest, cap), cap)
            dest_by_orig = jax.lax.sort(
                (oidx_s, dest_sentinel), dimension=0, is_stable=False,
                num_keys=1)[1]
        return (arrays, dest_by_orig, block_bucket, processed, dropped,
                overflow)

    # -- jitted chunk step ---------------------------------------------

    def _planes_core(self, uvw, row_mask, vre, vim, cap: int,
                     num_blocks: int, void=None):
        """Device plan -> taps -> packed kernel -> drain ->
        per-w-plane uv grids ``[P, N, N]`` (pre-correction) + counters.

        ``void``: optional traced-flag combiner applied to the local
        overflow flag (the mesh-sharded step psums it so ALL shards
        void the chunk together — a half-voided chunk would be a
        silently truncated image).
        """
        splan = self.splan
        plan = splan.wplan
        (arrays, _dest, block_bucket, processed,
         dropped, overflow) = self._plan_chunk(uvw, row_mask, vre, vim,
                                               cap, num_blocks,
                                               need_unsort=False)
        if void is not None:
            overflow = void(overflow)
            processed = jnp.where(overflow, 0, processed)

        num_tasks = len(splan.tasks)
        sgs = plan.subgrid_size
        bb = block_bucket
        octet = jnp.mod(bb, splan.num_octets)
        slab = jnp.mod(bb // splan.num_octets, splan.num_slabs)
        task_b = bb // (splan.num_octets * splan.num_slabs)
        stack = grid_stack(
            arrays["taps"], task_b, slab, octet, arrays["vre"],
            arrays["vim"], num_tasks, splan.num_layers, sgs,
            splan.block_v, self.precision,
            nonempty=arrays["nonempty"] & jnp.logical_not(overflow))
        st = stack.reshape(num_tasks, 2, splan.num_layers,
                           sgs + 8, sgs)[:, :, :, :sgs, :]
        layers = jax.lax.complex(st[:, 0], st[:, 1])
        layers = ifft_shifted(layers)
        # HIGHEST: the ladder carries w phases (no TF32 products).
        subgrids = jnp.einsum("tkuv,kuv->tuv", layers, self.ladder,
                              precision=jax.lax.Precision.HIGHEST
                              ) * self.pref
        subgrids = fft_shifted(subgrids)

        image_size = plan.image_size
        sg_factor = (image_size / plan.subgrid_size) ** 2
        per_plane = {iw: jnp.zeros((image_size, image_size),
                                   jnp.complex64)
                     for iw in splan.w_plane_ids}
        for t, task in enumerate(splan.tasks):
            per_plane[task.iw] = subgrid_add_static(
                per_plane[task.iw], -task.iu * plan.eff_sg_size,
                -task.iv * plan.eff_sg_size, subgrids[t], sg_factor)
        planes = jnp.stack([per_plane[iw] for iw in splan.w_plane_ids])
        return planes, processed, dropped, overflow

    def _plane_offsets(self):
        plan = self.splan.wplan
        return [int(np.trunc(iw * plan.w_tower_height))
                for iw in self.splan.w_plane_ids]

    def _step_impl(self, image, processed_acc, dropped_acc, voided_acc,
                   uvw, row_mask, vre, vim):
        splan = self.splan
        planes, processed, dropped, overflow = self._planes_core(
            uvw, row_mask, vre, vim, splan.cap, splan.num_blocks)
        chunk_img = _planes_to_image(self._kernel, planes,
                                     self._plane_offsets())
        # A capacity overflow voids the WHOLE chunk (never a silently
        # truncated image; no block of it was live) and finalize
        # raises.
        gain = jnp.where(overflow, 0.0, 1.0).astype(jnp.float32)
        return (image + gain * chunk_img,
                processed_acc + processed,
                dropped_acc + jnp.where(overflow, 0, dropped),
                voided_acc + overflow.astype(jnp.int32))

    # -- mesh-sharded chunk steps (rows shard; planes/counters psum) ----

    def sharded_step(self, mesh, axis_name: str = "rows"):
        """Compiled row-sharded chunk step over ``mesh`` (cached).

        Each device plans and grids its row shard against the FULL
        static task set with a per-shard capacity of ``cap / n``;
        per-w-plane uv grids reduce with one ``psum``.
        Overflow is psum'd BEFORE the fold so a chunk voids on all
        shards together. (Unlike PackedGridder's block-sharding, the
        shard->task ranges are data-dependent here, so every shard
        drains all T tasks — the kernel work dominates for the dense
        chunks streaming targets.)
        """
        from jax.sharding import PartitionSpec as P

        if axis_name not in mesh.shape:
            raise SdpInvalidArgumentError(
                f"mesh has no axis {axis_name!r} (axes: "
                f"{tuple(mesh.shape)})")
        # n = the ROW-shard count (rows shard over axis_name only; on
        # a multi-axis mesh other axes see replicated inputs), and the
        # cache key covers the mesh structure, not just the devices.
        n = int(mesh.shape[axis_name])
        key = ("grid", tuple(d.id for d in mesh.devices.flat),
               tuple(mesh.axis_names), axis_name)
        fn = self._sharded_cache.get(key)
        if fn is not None:
            return fn
        splan = self.splan
        if splan.chunk_rows % n or splan.cap % (n * splan.block_v):
            raise SdpInvalidArgumentError(
                f"chunk_rows ({splan.chunk_rows}) must divide by the "
                f"row-shard count ({n}) and cap ({splan.cap}) by "
                f"n*block_v; adjust cap_slots")
        cap_s = splan.cap // n
        nblk_s = cap_s // splan.block_v

        def body(image, processed_acc, dropped_acc, voided_acc,
                 uvw, row_mask, vre, vim):
            planes, processed, dropped, overflow = self._planes_core(
                uvw, row_mask, vre, vim, cap_s, nblk_s,
                void=lambda o: jax.lax.psum(
                    o.astype(jnp.int32), axis_name) > 0)
            planes = jax.lax.psum(planes, axis_name)
            chunk_img = _planes_to_image(self._kernel, planes,
                                         self._plane_offsets())
            gain = jnp.where(overflow, 0.0, 1.0).astype(jnp.float32)
            processed = jax.lax.psum(processed, axis_name)
            dropped = jax.lax.psum(dropped, axis_name)
            return (image + gain * chunk_img,
                    processed_acc + processed,
                    dropped_acc + jnp.where(overflow, 0, dropped),
                    voided_acc + overflow.astype(jnp.int32))

        fn = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(), P(),
                      P(axis_name), P(axis_name), P(axis_name),
                      P(axis_name)),
            out_specs=(P(), P(), P(), P()), check_vma=False))
        lru_insert(self._sharded_cache, key, fn)
        return fn

    def sharded_dstep(self, mesh, axis_name: str = "rows"):
        """Compiled row-sharded predict step over ``mesh`` (cached).

        Embarrassingly row-parallel: each device plans and degrids its
        row shard from the replicated model plane stack; the predicted
        visibilities stay row-sharded (no collective on the data path,
        only the counter/void psums)."""
        from jax.sharding import PartitionSpec as P

        if axis_name not in mesh.shape:
            raise SdpInvalidArgumentError(
                f"mesh has no axis {axis_name!r} (axes: "
                f"{tuple(mesh.shape)})")
        n = int(mesh.shape[axis_name])
        key = ("degrid", tuple(d.id for d in mesh.devices.flat),
               tuple(mesh.axis_names), axis_name)
        fn = self._sharded_cache.get(key)
        if fn is not None:
            return fn
        splan = self.splan
        if splan.chunk_rows % n or splan.cap % (n * splan.block_v):
            raise SdpInvalidArgumentError(
                f"chunk_rows ({splan.chunk_rows}) must divide by the "
                f"row-shard count ({n}) and cap ({splan.cap}) by "
                f"n*block_v; adjust cap_slots")
        cap_s = splan.cap // n
        nblk_s = cap_s // splan.block_v

        def body(processed_acc, dropped_acc, voided_acc,
                 uvw, row_mask, st):
            vis, processed, dropped, voided = self._dstep_core(
                uvw, row_mask, st, cap_s, nblk_s,
                void=lambda o: jax.lax.psum(
                    o.astype(jnp.int32), axis_name) > 0)
            processed = jax.lax.psum(processed, axis_name)
            dropped = jax.lax.psum(dropped, axis_name)
            return (vis, processed_acc + processed,
                    dropped_acc + dropped, voided_acc + voided)

        fn = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(), P(),
                      P(axis_name), P(axis_name), P()),
            out_specs=(P(axis_name), P(), P(), P()),
            check_vma=False))
        lru_insert(self._sharded_cache, key, fn)
        return fn

    # -- jitted degrid (predict) path -----------------------------------

    def _model_stack_impl(self, image):
        """Model image -> task-major [T, 2, K*(N+8), N] tower stack for
        the degrid kernel (mirror of PackedGridder._dstage_planes +
        _dstage_layers; computed once per model, reused per chunk)."""
        from ..fourier_transforms.fft import ifft_shifted_norm
        from ..grid_data.gridder_utils import subgrid_cut_out_static
        from .packed import _image_to_plane_stack

        splan = self.splan
        plan = splan.wplan
        sgs = plan.subgrid_size
        plane_stack = _image_to_plane_stack(
            self._kernel, image, self._plane_offsets())
        plane_pos = {iw: i for i, iw in enumerate(splan.w_plane_ids)}
        subgrids = jnp.stack([
            subgrid_cut_out_static(
                plane_stack[plane_pos[task.iw]],
                task.iu * plan.eff_sg_size,
                task.iv * plan.eff_sg_size, sgs)
            for task in splan.tasks]).astype(jnp.complex64)
        subgrids = ifft_shifted_norm(subgrids)
        layers = fft_shifted(
            (subgrids * self.pref_degrid)[:, None, :, :]
            * self.ladder_degrid[None])
        st = jnp.stack([layers.real.astype(jnp.float32),
                        layers.imag.astype(jnp.float32)], axis=1)
        st = jnp.pad(st, ((0, 0), (0, 0), (0, 0), (0, 8), (0, 0)))
        return st.reshape(len(splan.tasks), 2,
                          splan.num_layers * (sgs + 8), sgs)

    def _dstep_core(self, uvw, row_mask, st, cap: int, num_blocks: int,
                    void=None):
        """Device plan -> taps -> degrid kernel -> (row, chan)
        visibilities + counters (``void`` as in :meth:`_planes_core`)."""
        splan = self.splan
        plan = splan.wplan
        (arrays, dest, block_bucket, processed,
         dropped, overflow) = self._plan_chunk(uvw, row_mask, None,
                                               None, cap, num_blocks)
        if void is not None:
            overflow = void(overflow)
            processed = jnp.where(overflow, 0, processed)

        bb = block_bucket
        octet = jnp.mod(bb, splan.num_octets)
        slab = jnp.mod(bb // splan.num_octets, splan.num_slabs)
        task_b = bb // (splan.num_octets * splan.num_slabs)
        re, im = degrid_stack(st, arrays["taps"], task_b, slab, octet,
                              splan.block_v, self.precision,
                              nonempty=arrays["nonempty"])
        # Back to (row, chan) order through the sort-derived
        # entry->slot map; dropped entries point at the guaranteed-zero
        # extra slot.
        out = jax.lax.complex(re, im)
        out = jnp.concatenate([out, jnp.zeros((1,), out.dtype)])
        vis = out[dest].reshape(uvw.shape[0], plan.num_chan)
        vis = jnp.where(overflow, jnp.zeros_like(vis), vis)
        return (vis, processed,
                jnp.where(overflow, 0, dropped),
                overflow.astype(jnp.int32))

    def _dstep_impl(self, processed_acc, dropped_acc, voided_acc,
                    uvw, row_mask, st):
        splan = self.splan
        vis, processed, dropped, voided = self._dstep_core(
            uvw, row_mask, st, splan.cap, splan.num_blocks)
        return (vis, processed_acc + processed,
                dropped_acc + dropped, voided_acc + voided)


class StreamingGridder:
    """Accumulates a dirty image over visibility chunks, planning on
    device (see module docstring). The compiled engine is shared
    across instances of the same (plan, fast) via a value-keyed cache.
    With ``mesh=`` the chunk's rows shard across the device mesh and
    per-w-plane grids reduce with ``psum`` (chunk_rows and cap must
    divide by the mesh size).

    >>> sg = StreamingGridder(plan_stream(wplan, stream_tasks(wplan,
    ...                                   uvw_meta), chunk_rows=4096))
    >>> for uvw_c, vis_c, wgt_c in chunks:
    ...     sg.accumulate(uvw_c, vis_c, wgt_c)
    >>> image = sg.finalize()
    """

    def __init__(self, splan: StreamPlan, fast: bool = False,
                 mesh=None, axis_name: str = "rows"):
        self.splan = splan
        self.fast = bool(fast)
        self._engine = _stream_engine(splan, fast)
        self._step = (self._engine.step if mesh is None
                      else self._engine.sharded_step(mesh, axis_name))
        plan = splan.wplan
        self._image = jnp.zeros((plan.image_size, plan.image_size),
                                jnp.float32)
        # Device counters (int32: fine to ~2e9 visibilities/stream).
        self._processed = jnp.zeros((), jnp.int32)
        self._dropped = jnp.zeros((), jnp.int32)
        self._voided = jnp.zeros((), jnp.int32)   # capacity overflows
        self._expected = 0                         # host-side
        self._finalized = None

    def accumulate(self, uvw, vis, weights: Optional[Array] = None):
        """Grid one chunk: uvw [R, 3], vis [R, num_chan] complex
        (R <= chunk_rows; short chunks are padded and masked)."""
        if self._finalized is not None:
            raise SdpRuntimeError("stream already finalized")
        splan = self.splan
        uvw = np.asarray(jax.device_get(uvw)) \
            if isinstance(uvw, jax.Array) else np.asarray(uvw)
        rows = uvw.shape[0]
        if uvw.ndim != 2 or uvw.shape[1] != 3:
            raise SdpInvalidArgumentError(
                f"uvw must be [rows, 3], got {uvw.shape}")
        if rows > splan.chunk_rows:
            raise SdpInvalidArgumentError(
                f"chunk has {rows} rows > chunk_rows="
                f"{splan.chunk_rows}")
        vis = jnp.asarray(vis)
        if vis.ndim != 2 or vis.shape[0] != rows \
                or vis.shape[1] != splan.wplan.num_chan:
            raise SdpInvalidArgumentError(
                f"vis must be [{rows}, {splan.wplan.num_chan}], "
                f"got {tuple(vis.shape)}")
        pad = splan.chunk_rows - rows
        uvw32 = np.zeros((splan.chunk_rows, 3), np.float32)
        uvw32[:rows] = uvw
        row_mask = np.zeros(splan.chunk_rows, bool)
        row_mask[:rows] = True
        vre = jnp.real(vis).astype(jnp.float32)
        vim = jnp.imag(vis).astype(jnp.float32)
        if weights is not None:
            wgt = jnp.asarray(weights).astype(jnp.float32)
            vre, vim = vre * wgt, vim * wgt
        if pad:
            vre = jnp.concatenate(
                [vre, jnp.zeros((pad, vre.shape[1]), jnp.float32)])
            vim = jnp.concatenate(
                [vim, jnp.zeros((pad, vim.shape[1]), jnp.float32)])
        (self._image, self._processed, self._dropped,
         self._voided) = self._step(
            self._image, self._processed, self._dropped, self._voided,
            jnp.asarray(uvw32), jnp.asarray(row_mask), vre, vim)
        self._expected += rows * splan.wplan.num_chan

    @property
    def image(self) -> Array:
        """Current accumulated dirty image (no host sync)."""
        return self._image

    def counters(self):
        """(processed, dropped, voided_chunks) device scalars."""
        return self._processed, self._dropped, self._voided

    def finalize(self, check: bool = True) -> Array:
        """Return the accumulated image; with ``check`` (default),
        enforce the processed-vis invariant
        (sdp_grid_wstack_wtower.cpp:442-448) — one host readback."""
        if self._finalized is None:
            self._finalized = self._image
        if check:
            processed = int(self._processed)
            dropped = int(self._dropped)
            voided = int(self._voided)
            if voided:
                raise SdpRuntimeError(
                    f"{voided} chunk(s) exceeded the padded stream "
                    f"capacity ({self.splan.cap} slots) and were "
                    "voided; raise cap_factor or shrink chunks")
            # Primary invariant: nothing dropped, nothing voided —
            # together these imply processed == expected. The explicit
            # processed cross-check (an internal-consistency guard)
            # only applies while the int32 device counter cannot have
            # wrapped; beyond 2^31 visibilities it is skipped, the
            # dropped/voided checks still protect the stream.
            if dropped or (self._expected < 2 ** 31
                           and processed != self._expected):
                raise SdpRuntimeError(
                    f"stream processed {processed} of "
                    f"{self._expected} visibilities ({dropped} "
                    "outside the task set / tower ranges)")
        return self._finalized


class StreamingDegridder:
    """Predict (degrid) visibilities for a model image, chunk by
    chunk, planning on device — the predict half of a streaming
    selfcal/calibration loop. Shares the compiled engine (and the
    device plan arithmetic) with :class:`StreamingGridder`.

    The model's padded (task, layer) plane stack is computed once per
    :meth:`set_model`; each :meth:`predict` chunk then costs one H2D
    transfer (uvw) and one D2H (the predicted visibilities).
    Visibilities outside the task set predict zero AND are counted;
    :meth:`check` surfaces them (the degrid twin of the gridding
    count invariant).
    """

    def __init__(self, splan: StreamPlan, fast: bool = False,
                 mesh=None, axis_name: str = "rows"):
        self.splan = splan
        self.fast = bool(fast)
        self._engine = _stream_engine(splan, fast)
        self._dstep = (self._engine.dstep if mesh is None else
                       self._engine.sharded_dstep(mesh, axis_name))
        self._st = None
        self._processed = jnp.zeros((), jnp.int32)
        self._dropped = jnp.zeros((), jnp.int32)
        self._voided = jnp.zeros((), jnp.int32)
        self._expected = 0

    def set_model(self, image: Array):
        """Set (or replace) the model image; returns self."""
        plan = self.splan.wplan
        image = jnp.asarray(image)
        if image.shape != (plan.image_size, plan.image_size):
            raise SdpInvalidArgumentError(
                f"model must be [{plan.image_size}, {plan.image_size}]"
                f", got {tuple(image.shape)}")
        self._st = self._engine.model_stack(image)
        return self

    def predict(self, uvw) -> Array:
        """uvw [R, 3] -> predicted visibilities [R, num_chan]
        complex64 (R <= chunk_rows; short chunks padded+masked)."""
        if self._st is None:
            raise SdpRuntimeError("call set_model(image) first")
        splan = self.splan
        uvw = np.asarray(jax.device_get(uvw)) \
            if isinstance(uvw, jax.Array) else np.asarray(uvw)
        if uvw.ndim != 2 or uvw.shape[1] != 3:
            raise SdpInvalidArgumentError(
                f"uvw must be [rows, 3], got {uvw.shape}")
        rows = uvw.shape[0]
        if rows > splan.chunk_rows:
            raise SdpInvalidArgumentError(
                f"chunk has {rows} rows > chunk_rows="
                f"{splan.chunk_rows}")
        uvw32 = np.zeros((splan.chunk_rows, 3), np.float32)
        uvw32[:rows] = uvw
        row_mask = np.zeros(splan.chunk_rows, bool)
        row_mask[:rows] = True
        vis, self._processed, self._dropped, self._voided = \
            self._dstep(
                self._processed, self._dropped, self._voided,
                jnp.asarray(uvw32), jnp.asarray(row_mask), self._st)
        self._expected += rows * splan.wplan.num_chan
        return vis[:rows]

    def counters(self):
        """(processed, dropped, voided_chunks) device scalars."""
        return self._processed, self._dropped, self._voided

    def check(self):
        """Raise if any visibility predicted zero because it fell
        outside the task set / capacity (one host readback)."""
        processed, dropped, voided = (int(x) for x in self.counters())
        if voided:
            raise SdpRuntimeError(
                f"{voided} predict chunk(s) exceeded the padded "
                f"stream capacity ({self.splan.cap} slots) and "
                "returned zeros; raise cap_factor or shrink chunks")
        # See StreamingGridder.finalize: the processed cross-check is
        # skipped once the int32 device counter could have wrapped.
        if dropped or (self._expected < 2 ** 31
                       and processed != self._expected):
            raise SdpRuntimeError(
                f"predicted {processed} of {self._expected} "
                f"visibilities ({dropped} outside the task set / "
                "tower ranges returned zeros)")
