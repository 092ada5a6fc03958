"""Distributed w-stacking imaging operators over a device mesh.

Design (replacement for the reference's OpenMP task queue,
grid_data/sdp_grid_wstack_wtower.cpp:24-165, 388-440):

1. **Plan** (host, once per uvw distribution): enumerate the non-empty
   (w-plane, sub-grid) boxes and their static w-tower plane ranges — the
   static analogue of the reference's ``sdp_SubgridTask`` list. All shape-
   and trip-count-determining numbers become Python ints so the execution
   graph traces once.
2. **Execute** (device, jitted): every chip holds a shard of the
   visibility rows (`shard_map` over a 1-D mesh). It runs the *same*
   static task list against its shard — per-task channel clamping selects
   only the rows/channels that fall in each box, exactly like the
   reference routes rows to tasks — producing a partial image.
3. **Reduce**: `psum` of partial images over ICI replaces the reference's
   ``omp critical(subgrid_add)`` serialised reduction.

Degridding needs no reduction: the image is replicated, each chip degrids
its own rows (embarrassingly parallel, like the reference's
start_row/end_row process sharding).
"""

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..fourier_transforms.fft import fft_shifted, ifft_shifted_norm
from ..grid_data.clamp_channels import (
    clamp_channels_single,
    clamp_channels_uv,
)
from ..grid_data.gridder_utils import (
    subgrid_add,
    subgrid_cut_out,
)
from ..grid_data.wtower import (
    GridderWtowerUVW,
    _degrid_all_planes,
    _grid_all_planes,
)
from ..utility.caches import lru_insert
from .mesh import ROW_AXIS, pad_rows_arrays

Array = jax.Array

_KERNEL_CACHE: dict = {}


@dataclass(frozen=True)
class WStackTask:
    """One static (w-plane, sub-grid) box — the reference's sdp_SubgridTask
    (sdp_grid_wstack_wtower.cpp:24-38) with its w-tower range resolved at
    plan time so the on-device loop has static trip counts."""

    iu: int
    iv: int
    iw: int
    first_w_plane: int  # relative to the tower's w offset
    num_planes: int


@dataclass(frozen=True)
class WStackPlan:
    """Static geometry for a distributed w-stacking grid/degrid pass."""

    image_size: int
    subgrid_size: int
    theta: float
    w_step: float
    shear_u: float
    shear_v: float
    support: int
    oversampling: int
    w_support: int
    w_oversampling: int
    subgrid_frac: float
    w_tower_height: float
    freq0_hz: float
    dfreq_hz: float
    num_chan: int
    eff_sg_size: int
    w_plane_ids: Tuple[int, ...]
    tasks: Tuple[WStackTask, ...] = field(default=())

    @property
    def eff_sg_dist(self) -> float:
        return self.eff_sg_size / self.theta

    @property
    def w_stack_dist(self) -> float:
        return self.w_tower_height * self.w_step

    def kernel(self) -> GridderWtowerUVW:
        """Gridder plan for this geometry — cached by value so repeated
        calls share one kernel object (and downstream jit caches)."""
        key = (self.image_size, self.subgrid_size, self.theta,
               self.w_step, self.shear_u, self.shear_v, self.support,
               self.oversampling, self.w_support, self.w_oversampling)
        kern = _KERNEL_CACHE.get(key)
        if kern is None:
            kern = GridderWtowerUVW(*key)
            _KERNEL_CACHE[key] = kern
        return kern


def plan_wstack(uvw, freq0_hz: float, dfreq_hz: float, num_chan: int,
                image_size: int, subgrid_size: int, theta: float,
                w_step: float, shear_u: float = 0.0, shear_v: float = 0.0,
                support: int = 8, oversampling: int = 16384,
                w_support: int = 4, w_oversampling: int = 16384,
                subgrid_frac: float = 2.0 / 3.0,
                w_tower_height: float = 4.0) -> WStackPlan:
    """Build the static task list from the full uvw distribution (host).

    Mirrors the geometry of `sdp_grid_wstack_wtower_{grid,degrid}_all`
    (sdp_grid_wstack_wtower.cpp:310-330) and its per-plane visibility
    counting (:66-136), but resolves everything to static Python ints so
    the execution can be traced once and run under `shard_map`.
    """
    # All planning happens host-side through the native runtime (C++/
    # OpenMP one-pass planner, NumPy fallback) — a single device->host
    # transfer of uvw instead of per-box device round-trips.
    from .. import native

    uvw_np = np.ascontiguousarray(np.asarray(uvw), np.float64)
    num_rows = uvw_np.shape[0]
    if subgrid_frac == 0.0:
        subgrid_frac = 2.0 / 3.0
    if dfreq_hz == 0.0:
        dfreq_hz = 10.0
    eff_sg_size = int(math.floor(subgrid_size * subgrid_frac))
    eff_sg_dist = eff_sg_size / theta
    w_stack_dist = w_tower_height * w_step

    start_ch = np.zeros((num_rows,), np.int32)
    end_ch = np.full((num_rows,), num_chan, np.int32)
    uvw_min, uvw_max = native.uvw_bounds(uvw_np, freq0_hz, dfreq_hz,
                                         start_ch, end_ch)
    eta = 1e-5
    min_iu = int(math.floor(uvw_min[0] / eff_sg_dist + 0.5 - eta))
    max_iu = int(math.floor(uvw_max[0] / eff_sg_dist + 0.5 + eta))
    min_iv = int(math.floor(uvw_min[1] / eff_sg_dist + 0.5 - eta))
    max_iv = int(math.floor(uvw_max[1] / eff_sg_dist + 0.5 + eta))
    min_iw = int(math.floor(uvw_min[2] / w_stack_dist + 0.5 - eta))
    max_iw = int(math.floor(uvw_max[2] / w_stack_dist + 0.5 + eta))

    counts, wmin, wmax = native.plan_wstack_boxes(
        uvw_np, freq0_hz, dfreq_hz, num_chan, eff_sg_dist, w_stack_dist,
        (min_iu, max_iu), (min_iv, max_iv), (min_iw, max_iw))

    tasks = []
    w_plane_ids = []
    for jw in range(counts.shape[0]):
        iw = min_iw + jw
        plane_has_tasks = False
        for ju in range(counts.shape[1]):
            for jv in range(counts.shape[2]):
                if counts[jw, ju, jv] == 0:
                    continue
                # W-tower plane range for this box from the *global*
                # data bounds (sdp_gridder_wtower_uvw.cpp:780-800). A
                # shard sees a subset, so the global range is always
                # sufficient; empty planes contribute exactly zero.
                off_w = int(iw * w_tower_height)
                first = int(np.floor(wmin[jw, ju, jv] / w_step - eta)) \
                    - off_w
                last = int(np.ceil(wmax[jw, ju, jv] / w_step + eta)) \
                    - off_w + 1
                tasks.append(WStackTask(min_iu + ju, min_iv + jv, iw,
                                        first, 1 + last - first))
                plane_has_tasks = True
        if plane_has_tasks:
            w_plane_ids.append(iw)

    return WStackPlan(
        image_size=int(image_size), subgrid_size=int(subgrid_size),
        theta=float(theta), w_step=float(w_step), shear_u=float(shear_u),
        shear_v=float(shear_v), support=int(support),
        oversampling=int(oversampling), w_support=int(w_support),
        w_oversampling=int(w_oversampling), subgrid_frac=float(subgrid_frac),
        w_tower_height=float(w_tower_height), freq0_hz=float(freq0_hz),
        dfreq_hz=float(dfreq_hz), num_chan=int(num_chan),
        eff_sg_size=eff_sg_size, w_plane_ids=tuple(w_plane_ids),
        tasks=tuple(tasks))


# ---------------------------------------------------------------------------
# Jittable single-shard drivers (static task list, traced channel clamping)
# ---------------------------------------------------------------------------

def _box_bounds(plan: WStackPlan, task: WStackTask):
    d = plan.eff_sg_dist
    return (task.iu * d - d / 2, (task.iu + 1) * d - d / 2,
            task.iv * d - d / 2, (task.iv + 1) * d - d / 2)


def _wslab_bounds(plan: WStackPlan, iw: int):
    d = plan.w_stack_dist
    return iw * d - d / 2, (iw + 1) * d - d / 2


def grid_all_tasks(plan: WStackPlan, kernel: GridderWtowerUVW, vis: Array,
                   uvw: Array, start_chs: Array, end_chs: Array) -> Array:
    """Jittable grid_all over the static task list: one visibility shard ->
    partial image. Trace-safe: no data-dependent control flow."""
    image_size = plan.image_size
    sg_factor = (image_size / plan.subgrid_size) ** 2
    image = jnp.zeros((image_size, image_size), vis.dtype)
    w_pattern = kernel.w_pattern
    uv_kernel = kernel.uv_kernel.astype(jnp.real(vis).dtype)
    w_kernel = kernel.w_kernel.astype(jnp.real(vis).dtype)
    w_img_dtype = w_pattern.dtype

    for iw in plan.w_plane_ids:
        min_w, max_w = _wslab_bounds(plan, iw)
        s_w, e_w = clamp_channels_single(
            uvw, 2, plan.freq0_hz, plan.dfreq_hz, start_chs, end_chs,
            min_w, max_w)
        grid = jnp.zeros((image_size, image_size), vis.dtype)
        for task in plan.tasks:
            if task.iw != iw:
                continue
            min_u, max_u, min_v, max_v = _box_bounds(plan, task)
            s_uv, e_uv = clamp_channels_uv(
                uvw, plan.freq0_hz, plan.dfreq_hz, s_w, e_w,
                min_u, max_u, min_v, max_v)
            off = (task.iu * plan.eff_sg_size, task.iv * plan.eff_sg_size,
                   int(task.iw * plan.w_tower_height))
            subgrid = _grid_all_planes(
                vis, w_pattern.astype(w_img_dtype), uv_kernel, w_kernel,
                uvw, s_uv, e_uv,
                jnp.zeros((plan.subgrid_size, plan.subgrid_size), vis.dtype),
                jnp.asarray(off[0]), jnp.asarray(off[1]), jnp.asarray(off[2]),
                jnp.asarray(task.first_w_plane),
                plan.freq0_hz, plan.dfreq_hz, task.num_planes, plan.theta,
                plan.w_step, plan.support, plan.oversampling, plan.w_support,
                plan.w_oversampling, plan.subgrid_size, 0, uvw.shape[0])
            subgrid = fft_shifted(subgrid)
            grid = subgrid_add(grid, -task.iu * plan.eff_sg_size,
                               -task.iv * plan.eff_sg_size, subgrid,
                               sg_factor)
        grid = ifft_shifted_norm(grid)
        grid = kernel.grid_correct(grid, 0, 0,
                                   int(iw * plan.w_tower_height))
        image = image + grid.astype(image.dtype)
    return image


def degrid_all_tasks(plan: WStackPlan, kernel: GridderWtowerUVW,
                     image: Array, uvw: Array, start_chs: Array,
                     end_chs: Array, vis_dtype=jnp.complex128) -> Array:
    """Jittable degrid_all over the static task list: replicated image ->
    one visibility shard."""
    vis = jnp.zeros((uvw.shape[0], plan.num_chan), vis_dtype)
    uv_kernel = kernel.uv_kernel.astype(jnp.real(vis).dtype)
    w_kernel = kernel.w_kernel.astype(jnp.real(vis).dtype)
    w_pattern = kernel.w_pattern.astype(vis.dtype)

    for iw in plan.w_plane_ids:
        min_w, max_w = _wslab_bounds(plan, iw)
        s_w, e_w = clamp_channels_single(
            uvw, 2, plan.freq0_hz, plan.dfreq_hz, start_chs, end_chs,
            min_w, max_w)
        grid = kernel.degrid_correct(
            image.astype(vis.dtype), 0, 0, int(iw * plan.w_tower_height))
        grid = fft_shifted(grid)
        for task in plan.tasks:
            if task.iw != iw:
                continue
            min_u, max_u, min_v, max_v = _box_bounds(plan, task)
            s_uv, e_uv = clamp_channels_uv(
                uvw, plan.freq0_hz, plan.dfreq_hz, s_w, e_w,
                min_u, max_u, min_v, max_v)
            subgrid = subgrid_cut_out(
                grid, task.iu * plan.eff_sg_size,
                task.iv * plan.eff_sg_size, plan.subgrid_size)
            subgrid = ifft_shifted_norm(subgrid)
            off = (task.iu * plan.eff_sg_size, task.iv * plan.eff_sg_size,
                   int(task.iw * plan.w_tower_height))
            vis = _degrid_all_planes(
                subgrid.astype(vis.dtype), w_pattern, uv_kernel, w_kernel,
                uvw, s_uv, e_uv, vis,
                jnp.asarray(off[0]), jnp.asarray(off[1]), jnp.asarray(off[2]),
                jnp.asarray(task.first_w_plane),
                plan.freq0_hz, plan.dfreq_hz, task.num_planes, plan.theta,
                plan.w_step, plan.support, plan.oversampling, plan.w_support,
                plan.w_oversampling, plan.subgrid_size, 0, uvw.shape[0])
    return vis


# ---------------------------------------------------------------------------
# shard_map wrappers over a device mesh
# ---------------------------------------------------------------------------

_SHARDED_CACHE: dict = {}


def _mesh_key(mesh: Mesh, axis_name: str):
    return (tuple(int(d.id) for d in mesh.devices.flat),
            tuple(mesh.axis_names), axis_name)


def kernel_geometry_key(kernel: GridderWtowerUVW):
    """Value-defining cache identity for a gridder kernel plan.

    Compiled-driver caches must never key on ``id(kernel)``: a
    collected kernel's id can be recycled by a different kernel object,
    silently returning closures compiled over the old kernel's tables.
    """
    return (kernel.image_size, kernel.subgrid_size, kernel.theta,
            kernel.w_step, kernel.shear_u, kernel.shear_v,
            kernel.support, kernel.oversampling, kernel.w_support,
            kernel.w_oversampling)


def wstack_grid_all_sharded(plan: WStackPlan, vis: Array, uvw: Array,
                            mesh: Mesh,
                            kernel: Optional[GridderWtowerUVW] = None,
                            axis_name: str = ROW_AXIS,
                            image_dtype=None) -> Array:
    """Grid all visibilities into an image over a device mesh.

    Rows are sharded across ``mesh``; each chip grids its shard through
    the static task list and partial images are reduced with `psum`.
    Result is numerically identical to the single-chip
    :func:`ska_sdp_func_jax.grid_data.wstack_wtower_grid_all` (the
    GPU-vs-CPU consistency pattern of the reference tests).
    """
    if kernel is None:
        kernel = plan.kernel()
    num_rows = vis.shape[0]
    num_shards = mesh.devices.size
    start_chs = jnp.zeros((num_rows,), jnp.int32)
    end_chs = jnp.full((num_rows,), plan.num_chan, jnp.int32)
    uvw_p, vis_p, s_p, e_p = pad_rows_arrays(
        uvw, vis, start_chs, end_chs, num_shards)
    if image_dtype is None:
        image_dtype = vis.dtype

    key = ("grid", plan, kernel_geometry_key(kernel),
           _mesh_key(mesh, axis_name))
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        def body(vis_s, uvw_s, s_s, e_s):
            partial = grid_all_tasks(plan, kernel, vis_s, uvw_s, s_s, e_s)
            return jax.lax.psum(partial, axis_name)

        # check_vma=False: scan carries inside the gridder start as
        # unvarying zeros, which the varying-manual-axes checker rejects.
        fn = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name),
                      P(axis_name)),
            out_specs=P(), check_vma=False))
        lru_insert(_SHARDED_CACHE, key, fn)
    gridded = fn(vis_p, uvw_p, s_p, e_p)
    if not jnp.issubdtype(image_dtype, jnp.complexfloating):
        gridded = gridded.real
    return gridded.astype(image_dtype)


def wstack_degrid_all_sharded(plan: WStackPlan, image: Array, uvw: Array,
                              mesh: Mesh,
                              kernel: Optional[GridderWtowerUVW] = None,
                              axis_name: str = ROW_AXIS,
                              vis_dtype=jnp.complex128) -> Array:
    """Degrid an image into all visibilities over a device mesh.

    The image is replicated; each chip degrids its own row shard — no
    collective needed (the forward operator is row-separable).
    """
    if kernel is None:
        kernel = plan.kernel()
    num_rows = uvw.shape[0]
    num_shards = mesh.devices.size
    start_chs = jnp.zeros((num_rows,), jnp.int32)
    end_chs = jnp.full((num_rows,), plan.num_chan, jnp.int32)
    uvw_p, _, s_p, e_p = pad_rows_arrays(
        uvw, None, start_chs, end_chs, num_shards)

    key = ("degrid", plan, kernel_geometry_key(kernel),
           _mesh_key(mesh, axis_name),
           jnp.dtype(vis_dtype).name)
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        def body(image_r, uvw_s, s_s, e_s):
            return degrid_all_tasks(plan, kernel, image_r, uvw_s, s_s,
                                    e_s, vis_dtype)

        fn = jax.jit(jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name), P(axis_name)),
            out_specs=P(axis_name), check_vma=False))
        lru_insert(_SHARDED_CACHE, key, fn)
    vis = fn(image, uvw_p, s_p, e_p)
    return vis[:num_rows]
