"""Bucketed w-stacking drivers: sort visibilities by task, grid slices.

The task drivers in :mod:`.wstack` stream ALL visibilities through every
(w-plane, sub-grid) task with masking — O(tasks x V) work. This module
is the production ingest path: every (row, channel) visibility belongs
to exactly one task box (the boxes tile (u, v, w) space), so a host-side
bucket sort (the reference's sdp_tiled_functions / bucket-sort stage)
makes each task's visibilities one contiguous slice, and the whole pass
is O(V).

Semantics note: box membership is evaluated per (row, channel) in f64 on
the host, equivalent to the channel-clamp interval arithmetic except for
sub-ulp boundary ties; the reference's row-level bounds rejection
(sdp_gridder_wtower_uvw.cpp:112-121) is replaced by the guarantee that a
box plus kernel support fits inside the sub-grid (subgrid_frac <= 2/3).
This is the f32 performance path; the oracle-accurate task drivers
remain in :mod:`.wstack`.
"""

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fourier_transforms.fft import fft_shifted, ifft_shifted, \
    ifft_shifted_norm
from ..grid_data.gridder_utils import subgrid_add, subgrid_cut_out
from ..grid_data.wtower import _round_half_away
from ..utility.constants import C_0
from .wstack import WStackPlan

Array = jax.Array


@dataclass(frozen=True)
class BucketedTask:
    iu: int
    iv: int
    iw: int
    first_w_plane: int
    num_layers: int          # num_planes + w_support - 1
    start: int               # slice start in the sorted/padded arrays
    size: int                # padded slice size (multiple of block_v)


@dataclass(frozen=True)
class BucketedPlan:
    plan: WStackPlan
    tasks: Tuple[BucketedTask, ...]
    total: int               # padded total length

    @property
    def w_plane_ids(self):
        return tuple(sorted({t.iw for t in self.tasks}))


def plan_bucketed(plan: WStackPlan, uvw, block_v: int = 1024
                  ) -> Tuple[BucketedPlan, np.ndarray, np.ndarray]:
    """Assign each (row, channel) to its task box, bucket-sort, pad.

    Returns (bucketed_plan, sort_index [Vp], valid_mask [Vp]) — both host
    numpy; sort_index gathers the flattened (row, channel) stream into
    task order (padded entries point at 0 with valid False).
    """

    uvw = np.asarray(uvw, np.float64)
    if plan.eff_sg_size + plan.support > plan.subgrid_size:
        from ..utility.errors import SdpInvalidArgumentError

        raise SdpInvalidArgumentError(
            "bucketed path requires eff_sg_size + support <= subgrid_size "
            f"({plan.eff_sg_size} + {plan.support} > {plan.subgrid_size}); "
            "lower subgrid_frac")
    num_chan = plan.num_chan
    freqs = plan.freq0_hz + plan.dfreq_hz * np.arange(num_chan)
    scale = freqs / C_0                                   # [C]
    u = uvw[:, 0:1] * scale[None, :]                      # [R, C]
    v = uvw[:, 1:2] * scale[None, :]
    w = uvw[:, 2:3] * scale[None, :]

    d = plan.eff_sg_dist
    wd = plan.w_stack_dist
    iu = np.floor(u / d + 0.5).astype(np.int64)
    iv = np.floor(v / d + 0.5).astype(np.int64)
    iw = np.floor(w / wd + 0.5).astype(np.int64)

    # Map to the planned task list; out-of-plan boxes are dropped (the
    # plan enumerates every non-empty box, so only sub-ulp boundary
    # ties can differ — and those carry zero weight either way).
    keys = np.stack([iw.ravel(), iu.ravel(), iv.ravel()], axis=1)
    task_id = np.full(keys.shape[0], -1, np.int64)
    for k, t in enumerate(plan.tasks):
        sel = ((keys[:, 0] == t.iw) & (keys[:, 1] == t.iu)
               & (keys[:, 2] == t.iv))
        task_id[sel] = k

    order = np.argsort(task_id, kind="stable")
    order = order[task_id[order] >= 0]                    # drop unplanned
    sorted_ids = task_id[order]

    tasks = []
    sort_index = []
    valid = []
    start = 0
    for k, t in enumerate(plan.tasks):
        sel = order[sorted_ids == k]
        n = sel.shape[0]
        pad = (-n) % block_v
        size = max(n + pad, block_v)
        pad = size - n
        sort_index.append(sel)
        sort_index.append(np.zeros(pad, np.int64))
        valid.append(np.ones(n, bool))
        valid.append(np.zeros(pad, bool))
        num_layers = t.num_planes + plan.w_support - 1
        tasks.append(BucketedTask(t.iu, t.iv, t.iw, t.first_w_plane,
                                  num_layers, start, size))
        start += size

    return (BucketedPlan(plan=plan, tasks=tuple(tasks), total=start),
            np.concatenate(sort_index), np.concatenate(valid))


def _slice_taps(bplan: BucketedPlan, task: BucketedTask, kernel,
                uvw_s, chan_s, valid_s, freq0, dfreq):
    """Tap geometry for one task slice (all [size] arrays)."""
    plan = bplan.plan
    fdt = uvw_s.dtype
    theta, w_step = plan.theta, plan.w_step
    ov, w_ov = plan.oversampling, plan.w_oversampling
    support, w_support = plan.support, plan.w_support
    sgs = plan.subgrid_size
    half = sgs // 2
    half_ov = (half - support // 2 + 1) * ov

    off_u = task.iu * plan.eff_sg_size
    off_v = task.iv * plan.eff_sg_size
    off_w = int(task.iw * plan.w_tower_height)

    sc = (freq0 + dfreq * chan_s.astype(fdt)) / C_0
    u = uvw_s[:, 0] * sc - off_u / theta
    v = uvw_s[:, 1] * sc - off_v / theta
    w = uvw_s[:, 2] * sc - off_w * w_step

    iu0_ov = _round_half_away(u * (theta * ov)).astype(jnp.int32) + half_ov
    iv0_ov = _round_half_away(v * (theta * ov)).astype(jnp.int32) + half_ov
    iu0 = jnp.clip(iu0_ov // ov, 0, sgs - support)
    iv0 = jnp.clip(iv0_ov // ov, 0, sgs - support)
    # Polynomial taps instead of table gathers (kernels.kernel_tap_coeffs).
    from ..grid_data.kernels import eval_kernel_taps
    from ..grid_data.wtower import _tap_coeffs_cached
    uv_c = _tap_coeffs_cached(support, ov)
    uk = eval_kernel_taps(jnp.mod(iu0_ov, ov), uv_c, ov)
    vk = eval_kernel_taps(jnp.mod(iv0_ov, ov), uv_c, ov)

    # Plane index within the tower and the w kernel row (same interval
    # convention as the clamp: plane p covers [(p-1) w_step, p w_step)).
    j = (jnp.floor(w / w_step).astype(jnp.int32) + 1
         - jnp.asarray(task.first_w_plane, jnp.int32))
    w_rel = w - (task.first_w_plane + j - 1).astype(fdt) * w_step
    w_row = jnp.mod(
        _round_half_away(w_rel * (w_ov / w_step)).astype(jnp.int32), w_ov)
    w_c = _tap_coeffs_cached(w_support, w_ov)
    wk = eval_kernel_taps(w_row, w_c, w_ov)

    num_k = task.num_layers
    k_ids = jax.lax.broadcasted_iota(jnp.int32, (u.shape[0], num_k), 1)
    weights = jnp.zeros((u.shape[0], num_k), jnp.float32)
    for layer in range(w_support):
        weights = weights + jnp.where(
            k_ids == (j[:, None] + layer), wk[:, layer:layer + 1],
            jnp.zeros((), jnp.float32))
    in_plan = (j >= 0) & (j < num_k - w_support + 1)
    weights = jnp.where((valid_s & in_plan)[:, None], weights,
                        jnp.zeros((), jnp.float32))
    return iu0, iv0, uk, vk, weights


class _KernelArrays:
    """Device copies of the gridder kernel tables (f32)."""

    def __init__(self, kernel):
        self.uv_kernel_dev = jnp.asarray(
            kernel.uv_kernel.astype(np.float32))
        self.w_kernel_dev = jnp.asarray(kernel.w_kernel.astype(np.float32))
        self.w_pattern_np = kernel.w_pattern


def grid_all_bucketed(bplan: BucketedPlan, vis: Array, uvw: Array,
                      sort_index: Array, valid: Array,
                      image_dtype=jnp.float32) -> Array:
    """Grid all visibilities, one banded-matmul pass per task over its own
    slice — O(V) total work. Returns the real dirty image."""
    from ..kernels.dense_tap import grid_all_layers_dense

    plan = bplan.plan
    kernel = plan.kernel()
    ka = _KernelArrays(kernel)
    sgs = plan.subgrid_size
    image_size = plan.image_size
    num_chan = plan.num_chan
    sg_factor = (image_size / sgs) ** 2
    freq0, dfreq = plan.freq0_hz, (plan.dfreq_hz or 10.0)

    row_idx = sort_index // num_chan
    chan_idx = (sort_index % num_chan).astype(jnp.int32)
    uvw_s = uvw[row_idx]                                  # [Vp, 3]
    vis_s = vis.reshape(-1)[sort_index]                   # [Vp]
    vis_re = jnp.where(valid, vis_s.real, 0.0).astype(jnp.float32)
    vis_im = jnp.where(valid, vis_s.imag, 0.0).astype(jnp.float32)

    w_pattern = ka.w_pattern_np
    image = jnp.zeros((image_size, image_size), jnp.complex64)
    per_plane_grid = {}
    for task in bplan.tasks:
        sl = slice(task.start, task.start + task.size)
        iu0, iv0, uk, vk, weights = _slice_taps(
            bplan, task, ka, uvw_s[sl], chan_idx[sl], valid[sl],
            freq0, dfreq)
        iu0, iv0, uk, vk, weights = jax.lax.optimization_barrier(
            (iu0, iv0, uk, vk, weights))
        acc = grid_all_layers_dense(
            vis_re[sl], vis_im[sl], iu0, iv0, uk, vk, weights,
            task.num_layers, sgs)
        # Tower drain: batched iFFT + w_pattern ladder (see wtower.py).
        layers = ifft_shifted(acc)
        exps = (task.first_w_plane + plan.w_support // 2 - plan.w_support
                + np.arange(task.num_layers)).astype(np.float32)
        ladder = jnp.asarray(
            w_pattern[None, :, :] ** exps[:, None, None], jnp.complex64)
        subgrid = jnp.sum(layers * ladder, axis=0)
        subgrid = fft_shifted(subgrid)
        g = per_plane_grid.get(task.iw)
        if g is None:
            g = jnp.zeros((image_size, image_size), jnp.complex64)
        per_plane_grid[task.iw] = subgrid_add(
            g, -task.iu * plan.eff_sg_size, -task.iv * plan.eff_sg_size,
            subgrid, sg_factor)

    for iw, g in per_plane_grid.items():
        g = ifft_shifted_norm(g)
        g = kernel.grid_correct(g, 0, 0, int(iw * plan.w_tower_height))
        image = image + g.astype(image.dtype)
    if not jnp.issubdtype(jnp.dtype(image_dtype), jnp.complexfloating):
        return image.real.astype(image_dtype)
    return image.astype(image_dtype)


def degrid_all_bucketed(bplan: BucketedPlan, image: Array, uvw: Array,
                        sort_index: Array, valid: Array,
                        inverse_index: Array) -> Array:
    """Degrid an image into all visibilities through the bucketed path.

    ``inverse_index``: for each flattened (row, channel) output, its
    position in the sorted/padded stream (host-computed inverse of
    sort_index over the valid entries).
    """
    from ..kernels.dense_tap import degrid_all_layers_dense

    plan = bplan.plan
    kernel = plan.kernel()
    ka = _KernelArrays(kernel)
    sgs = plan.subgrid_size
    num_chan = plan.num_chan
    freq0, dfreq = plan.freq0_hz, (plan.dfreq_hz or 10.0)

    row_idx = sort_index // num_chan
    chan_idx = (sort_index % num_chan).astype(jnp.int32)
    uvw_s = uvw[row_idx]

    # Per w-plane FFT'd full grid (amortised across the plane's tasks).
    plane_grids = {}
    for iw in bplan.w_plane_ids:
        g = kernel.degrid_correct(image.astype(jnp.complex64), 0, 0,
                                  int(iw * plan.w_tower_height))
        plane_grids[iw] = fft_shifted(g)

    out_sorted = jnp.zeros((bplan.total,), jnp.complex64)
    w_pattern = ka.w_pattern_np
    for task in bplan.tasks:
        sl = slice(task.start, task.start + task.size)
        iu0, iv0, uk, vk, weights = _slice_taps(
            bplan, task, ka, uvw_s[sl], chan_idx[sl], valid[sl],
            freq0, dfreq)
        iu0, iv0, uk, vk, weights = jax.lax.optimization_barrier(
            (iu0, iv0, uk, vk, weights))
        subgrid = subgrid_cut_out(
            plane_grids[task.iw], task.iu * plan.eff_sg_size,
            task.iv * plan.eff_sg_size, sgs)
        subgrid = ifft_shifted_norm(subgrid).astype(jnp.complex64)
        exps = (task.first_w_plane - plan.w_support // 2
                + np.arange(task.num_layers)).astype(np.float32)
        ladder = jnp.asarray(
            w_pattern[None, :, :] ** (-exps[:, None, None]), jnp.complex64)
        layers = fft_shifted(subgrid[None, :, :] * ladder)
        vis_t = degrid_all_layers_dense(layers, iu0, iv0, uk, vk, weights)
        out_sorted = jax.lax.dynamic_update_slice(
            out_sorted, vis_t, (task.start,))

    num_rows = uvw.shape[0]
    # One guaranteed-zero slot for entries the plan never assigned.
    out_padded = jnp.concatenate(
        [out_sorted, jnp.zeros((1,), out_sorted.dtype)])
    return out_padded[inverse_index].reshape(num_rows, num_chan)


def inverse_index_of(sort_index: np.ndarray, valid: np.ndarray,
                     num_vis: int) -> np.ndarray:
    """Host inverse permutation: flattened (row, channel) -> sorted pos.

    Entries never assigned by the plan point at the one-past-the-end
    slot; `degrid_all_bucketed` keeps that slot zero so dropped entries
    degrid to exactly 0 (instead of aliasing sorted position 0).
    """
    inv = np.full(num_vis, sort_index.shape[0], np.int64)
    pos = np.arange(sort_index.shape[0])
    inv[sort_index[valid]] = pos[valid]
    return inv


def task_id_stream(bplan: BucketedPlan) -> np.ndarray:
    """Host [total] array: which task owns each sorted/padded position."""
    ids = np.full(bplan.total, -1, np.int64)
    for k, t in enumerate(bplan.tasks):
        ids[t.start:t.start + t.size] = k
    return ids


def grid_all_bucketed_sharded(bplan: BucketedPlan, vis: Array, uvw: Array,
                              sort_index: Array, valid: Array, mesh,
                              axis_name: str = "rows",
                              image_dtype=jnp.float32) -> Array:
    """Multi-device bucketed gridding: the sorted stream is chunked
    across the mesh; every device runs the same task loop over its chunk
    with task-ownership masks, and partial images reduce with `psum`."""
    from jax.sharding import PartitionSpec as P

    from ..kernels.dense_tap import grid_all_layers_dense

    plan = bplan.plan
    kernel = plan.kernel()
    ka = _KernelArrays(kernel)
    sgs = plan.subgrid_size
    image_size = plan.image_size
    num_chan = plan.num_chan
    sg_factor = (image_size / sgs) ** 2
    freq0, dfreq = plan.freq0_hz, (plan.dfreq_hz or 10.0)
    num_dev = int(mesh.devices.size)

    # Gather the sorted stream, pad it to a device multiple.
    row_idx = sort_index // num_chan
    chan_idx = (sort_index % num_chan).astype(jnp.int32)
    uvw_s = uvw[row_idx]
    vis_s = vis.reshape(-1)[sort_index]
    tids = jnp.asarray(task_id_stream(bplan))
    pad = (-bplan.total) % (num_dev * 1024)
    if pad:
        uvw_s = jnp.pad(uvw_s, ((0, pad), (0, 0)))
        vis_s = jnp.pad(vis_s, (0, pad))
        chan_idx = jnp.pad(chan_idx, (0, pad))
        valid = jnp.pad(valid, (0, pad))
        tids = jnp.pad(tids, (0, pad), constant_values=-1)
    vis_re = jnp.where(valid, vis_s.real, 0.0).astype(jnp.float32)
    vis_im = jnp.where(valid, vis_s.imag, 0.0).astype(jnp.float32)

    w_pattern = ka.w_pattern_np

    def body(uvw_c, chan_c, valid_c, tid_c, vre_c, vim_c):
        image = jnp.zeros((image_size, image_size), jnp.complex64)
        per_plane = {}
        for k, task in enumerate(bplan.tasks):
            own = valid_c & (tid_c == k)
            iu0, iv0, uk, vk, weights = _slice_taps(
                bplan, task, ka, uvw_c, chan_c, own, freq0, dfreq)
            iu0, iv0, uk, vk, weights = jax.lax.optimization_barrier(
                (iu0, iv0, uk, vk, weights))
            acc = grid_all_layers_dense(
                jnp.where(own, vre_c, 0.0), jnp.where(own, vim_c, 0.0),
                iu0, iv0, uk, vk, weights, task.num_layers, sgs)
            layers = ifft_shifted(acc)
            exps = (task.first_w_plane + plan.w_support // 2
                    - plan.w_support
                    + np.arange(task.num_layers)).astype(np.float32)
            ladder = jnp.asarray(
                w_pattern[None] ** exps[:, None, None], jnp.complex64)
            subgrid = fft_shifted(jnp.sum(layers * ladder, axis=0))
            g = per_plane.get(task.iw)
            if g is None:
                g = jnp.zeros((image_size, image_size), jnp.complex64)
            per_plane[task.iw] = subgrid_add(
                g, -task.iu * plan.eff_sg_size,
                -task.iv * plan.eff_sg_size, subgrid, sg_factor)
        for iw, g in per_plane.items():
            g = ifft_shifted_norm(g)
            g = kernel.grid_correct(g, 0, 0,
                                    int(iw * plan.w_tower_height))
            image = image + g.astype(image.dtype)
        return jax.lax.psum(image, axis_name)

    out = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name)),
        out_specs=P(), check_vma=False))(
            uvw_s, chan_idx, valid, tids, vis_re, vis_im)
    if not jnp.issubdtype(jnp.dtype(image_dtype), jnp.complexfloating):
        return out.real.astype(image_dtype)
    return out.astype(image_dtype)
