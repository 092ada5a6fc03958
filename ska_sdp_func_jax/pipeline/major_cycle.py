"""Major-cycle CLEAN imaging solver.

Solves the sparse deconvolution problem  min ||V - A x||  where A is the
degridding forward operator (image FFT + w-towers kernel sampling) via
CLEAN major/minor cycles:

    psf    = normalise(grid(1))                     (once)
    repeat n_major times:
        residual_vis = vis - degrid(model)
        dirty        = normalise(grid(residual_vis))
        delta, res   = hogbom_minor_cycle(dirty, psf)
        model       += delta
    restored = model * cbeam + res

Everything per iteration is jitted XLA; the minor cycle is an on-chip
`lax.while_loop` (no host round-trip per peak, unlike the reference's
GPU path which launches one kernel per minor-cycle step —
clean/sdp_hogbom_clean.cpp:281-732). With a mesh, gridding/degridding
shard visibility rows and reduce partial images with `psum`
(:mod:`ska_sdp_func_jax.parallel`).
"""

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..clean.hogbom import _minor_cycle, create_cbeam
from ..utility.caches import lru_insert
from ..grid_data.wtower import GridderWtowerUVW
from ..numeric_functions.fft_convolution import fft_convolution
from ..parallel.wstack import (
    WStackPlan,
    degrid_all_tasks,
    grid_all_tasks,
    kernel_geometry_key,
    plan_wstack,
    wstack_degrid_all_sharded,
    wstack_grid_all_sharded,
)

Array = jax.Array


@dataclass
class ImagingResult:
    """Solver outputs: CLEAN component model, final residual image,
    restored image, and per-major-cycle peak-residual history."""

    model: Array
    residual: Array
    restored: Array
    peak_history: List[float]


def make_psf_plan(plan: WStackPlan, uvw: Array) -> WStackPlan:
    """PSF plan at twice the image size / field of view (same uv cell):
    the minor cycle needs a 2N PSF for full-image component subtraction
    (clean/sdp_hogbom_clean.cpp:217-240). Re-planned from uvw because
    doubling theta changes the sub-grid box layout."""
    return plan_wstack(
        uvw, plan.freq0_hz, plan.dfreq_hz, plan.num_chan,
        2 * plan.image_size, plan.subgrid_size, 2 * plan.theta,
        plan.w_step, plan.shear_u, plan.shear_v, plan.support,
        plan.oversampling, plan.w_support, plan.w_oversampling,
        plan.subgrid_frac, plan.w_tower_height)


# Jitted single-chip drivers, cached per plan/kernel pair (plans are
# long-lived; eager execution of the task drivers would dispatch
# thousands of small ops).
_JIT_CACHE: dict = {}


def _jitted_driver(plan, kernel, which: str, vis_dtype=None):
    # Value-based key: WStackPlan is a frozen dataclass and the kernel
    # is identified by its geometry (never id() — recycled ids would
    # alias compiled closures over stale tables).
    key = (plan, kernel_geometry_key(kernel), which,
           jnp.dtype(vis_dtype).name if vis_dtype is not None else None)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        if which == "grid":
            fn = jax.jit(lambda v, u, s, e: grid_all_tasks(
                plan, kernel, v, u, s, e).real)
        else:
            fn = jax.jit(lambda img, u, s, e: degrid_all_tasks(
                plan, kernel, img, u, s, e, vis_dtype))
        lru_insert(_JIT_CACHE, key, fn, max_entries=16)
    return fn


def _bucketed_grid(bucket, vis, uvw, psf: bool = False):
    from ..parallel.bucketed import grid_all_bucketed

    # The permutation arrays are traced ARGUMENTS, not closure
    # captures: two plans that compare equal but carry different sort
    # orders must not alias each other's compiled permutation.
    bplan = bucket["psf_bplan"] if psf else bucket["bplan"]
    sort = bucket["psf_sort"] if psf else bucket["sort"]
    valid = bucket["psf_valid"] if psf else bucket["valid"]
    key = (bplan, "bgrid")
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda v, u, s_, m_: grid_all_bucketed(
            bplan, v, u, s_, m_))
        lru_insert(_JIT_CACHE, key, fn, max_entries=16)
    return fn(vis, uvw, sort, valid)


def _bucketed_degrid(bucket, image, uvw):
    from ..parallel.bucketed import degrid_all_bucketed

    bplan = bucket["bplan"]
    key = (bplan, "bdegrid")
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda img, u, s_, m_, i_: degrid_all_bucketed(
            bplan, img, u, s_, m_, i_))
        lru_insert(_JIT_CACHE, key, fn, max_entries=16)
    return fn(image, uvw, bucket["sort"], bucket["valid"], bucket["inv"])


def _whole_jit() -> bool:
    # Whole-driver jit on the GPU (one dispatch per call); eager task
    # loop on the CPU, where the inner jitted per-task drivers are
    # shared and whole-graph compilation of all tasks would dominate.
    from ..utility.device import use_gpu_kernels

    return use_gpu_kernels()


def _grid(plan: WStackPlan, kernel: GridderWtowerUVW, vis: Array,
          uvw: Array, mesh: Optional[Mesh]) -> Array:
    if mesh is not None:
        return wstack_grid_all_sharded(plan, vis, uvw, mesh, kernel=kernel,
                                       image_dtype=jnp.real(vis).dtype)
    num_rows = vis.shape[0]
    s = jnp.zeros((num_rows,), jnp.int32)
    e = jnp.full((num_rows,), plan.num_chan, jnp.int32)
    if _whole_jit():
        return _jitted_driver(plan, kernel, "grid")(vis, uvw, s, e)
    return grid_all_tasks(plan, kernel, vis, uvw, s, e).real


def _degrid(plan: WStackPlan, kernel: GridderWtowerUVW, image: Array,
            uvw: Array, mesh: Optional[Mesh], vis_dtype) -> Array:
    if mesh is not None:
        return wstack_degrid_all_sharded(plan, image, uvw, mesh,
                                         kernel=kernel, vis_dtype=vis_dtype)
    num_rows = uvw.shape[0]
    s = jnp.zeros((num_rows,), jnp.int32)
    e = jnp.full((num_rows,), plan.num_chan, jnp.int32)
    if _whole_jit():
        return _jitted_driver(plan, kernel, "degrid", vis_dtype)(
            image, uvw, s, e)
    return degrid_all_tasks(plan, kernel, image, uvw, s, e, vis_dtype)


# Module-level jits for the inter-stage glue (one compiled dispatch
# each instead of eager op-by-op execution).
_sub = jax.jit(lambda a, b: a - b)
_mul = jax.jit(lambda a, b: a * b)
_ones_like = jax.jit(jnp.ones_like)
_add = jax.jit(lambda a, b: a + b)


@jax.jit
def _stop_level(dirty, threshold, mgain):
    return jnp.maximum(threshold, (1.0 - mgain) * jnp.max(jnp.abs(dirty)))


@jax.jit
def _abs_max(x):
    return jnp.max(jnp.abs(x))


@functools.partial(jax.jit, static_argnames=("margin",))
def _norm_mask(image: Array, peak, margin: int) -> Array:
    """Normalise by the PSF peak and zero the border margin, fused."""
    return _mask_border(image / peak.astype(image.dtype), margin)


def _mask_border(image: Array, margin: int) -> Array:
    """Zero a border margin: the 1/PSWF grid correction diverges at the
    image edge (the reference tests exclude a border for the same reason,
    test_gridder_wtower_uvw.py:2188-2193); without a CLEAN window the
    minor-cycle argmax would lock onto those pixels."""
    if margin <= 0:
        return image
    size_l, size_m = image.shape
    il = jnp.arange(size_l)
    im = jnp.arange(size_m)
    keep = ((il >= margin) & (il < size_l - margin))[:, None] \
        & ((im >= margin) & (im < size_m - margin))[None, :]
    return jnp.where(keep, image, jnp.zeros((), image.dtype))


def dirty_and_psf(plan: WStackPlan, vis: Array, uvw: Array,
                  mesh: Optional[Mesh] = None,
                  psf_plan: Optional[WStackPlan] = None,
                  border: Optional[int] = None) -> Tuple[Array, Array]:
    """Grid the dirty image (N) and the PSF (2N), both normalised so the
    PSF peak is 1 (flux units). A border margin (default size//16) is
    zeroed on both — the CLEAN window."""
    if psf_plan is None:
        psf_plan = make_psf_plan(plan, uvw)
    if border is None:
        border = plan.image_size // 16
    kernel = plan.kernel()
    psf_kernel = psf_plan.kernel()
    dirty = _grid(plan, kernel, vis, uvw, mesh)
    psf = _grid(psf_plan, psf_kernel, _ones_like(vis), uvw, mesh)
    peak = psf[psf.shape[0] // 2, psf.shape[1] // 2]
    dirty = _norm_mask(dirty, peak, border)
    psf = _norm_mask(psf, peak, 2 * border)
    return dirty, psf


def major_cycle_imager(plan: WStackPlan, vis: Array, uvw: Array,
                       n_major: int = 3, loop_gain: float = 0.1,
                       threshold: float = 1e-3,
                       cycle_limit: int = 1000,
                       cbeam_details=(2.0, 2.0, 1.0, 128.0),
                       mesh: Optional[Mesh] = None,
                       border: Optional[int] = None,
                       mgain: float = 0.8,
                       checkpoint_path: Optional[str] = None,
                       checkpointer=None,
                       weights: Optional[Array] = None,
                       clean_algorithm: str = "hogbom",
                       scale_list: Tuple[int, ...] = (0, 8, 16),
                       ms_scale_bias: float = 0.0,
                       bucketed: bool = False,
                       fast: bool = False,
                       verbosity: int = 0) -> ImagingResult:
    """Run the full major/minor-cycle imaging solve.

    All heavy stages are jitted; with ``mesh`` the grid/degrid stages run
    sharded over visibility rows with `psum` image reduction.

    ``mgain`` bounds each minor cycle: it stops at
    ``max(threshold, (1 - mgain) * dirty_peak)`` so CLEAN never digs below
    the sidelobe level before the exact degrid re-prediction corrects the
    residual — without this the minor cycle over-cleans sidelobes of
    sparse uv coverage and the major loop diverges.

    With ``checkpoint_path`` the solver state is persisted after every
    major cycle and resumed from disk on restart (single-file ``.npz``);
    ``checkpointer`` accepts a :class:`.checkpoint.SolverCheckpointer`
    (orbax step directory, multi-host capable) instead — pass at most
    one of the two (see :mod:`.checkpoint`).

    ``bucketed=True`` (single-chip) bucket-sorts the visibilities by
    (w-plane, sub-grid) task once and grids/degrids each task's own
    slice — O(V) instead of O(tasks x V); the f32 production ingest
    path (see :mod:`ska_sdp_func_jax.parallel.bucketed`).

    ``fast=True`` (with ``bucketed=True``): the packed kernels' bf16
    precision (~2e-3 kernel accuracy; the major loop's exact
    re-prediction structure still converges — each cycle regrids the
    true residual).

    ``ms_scale_bias``: Cornwell 2008 small-scale selection bias for
    the msclean minor cycle (0 = reference-faithful unbiased selection,
    the default; ~0.6 concentrates point-source flux at small scales
    at a small cost in extended-emission flux).

    ``clean_algorithm``: "hogbom" (default) or "msclean" (multi-scale
    Cornwell minor cycles over ``scale_list``; converges like Hogbom on
    extended emission — use scales matched to the source structure, as
    inappropriate large scales bias point-source fluxes). The solver's
    multi-scale path registers the scale-convolved PSFs against the
    model's kernel windows (the standalone reference-faithful
    :func:`~ska_sdp_func_jax.clean.ms_clean_cornwell` keeps the
    reference's raw even-size convolution alignment).

    ``verbosity > 0`` logs a per-stage timing report after the solve
    (the reference driver's report_timing,
    sdp_grid_wstack_wtower.cpp:169-213). Stages use the DEVICE timer
    backend — each section blocks on its outputs before the clock
    stops. :meth:`PackedGridder.report_timing` splits the gridding
    itself into stages.
    """
    from ..utility.logging import log_info
    from ..utility.timers import Timers, TimerType

    timers = Timers("major_cycle_imager", TimerType.DEVICE) \
        if verbosity > 0 else None
    vis = jnp.asarray(vis)
    uvw = jnp.asarray(uvw)
    image_size = plan.image_size
    kernel = plan.kernel()
    psf_plan = make_psf_plan(plan, uvw)
    psf_kernel = psf_plan.kernel()
    rdtype = jnp.real(vis).dtype

    if border is None:
        border = image_size // 16
    if timers:
        timers.push("planning")
    bucket = None
    packed = None
    if bucketed:
        # Prefer the packed ingest (one kernel pass over all tasks,
        # sorted-stream residuals); geometries it cannot express
        # (subgrid % 128 != 0, support > 8) fall back to the bucketed
        # per-task path. With ``mesh`` the packed block stream
        # is sharded across the devices (psum image reduction).
        from ..utility.errors import SdpInvalidArgumentError

        try:
            from ..parallel.packed import packed_gridder, plan_packed

            pad_to = int(mesh.devices.size) if mesh is not None else 1
            pplan = plan_packed(plan, np.asarray(uvw),
                                pad_blocks_to=pad_to)
            psf_pplan = plan_packed(psf_plan, np.asarray(uvw),
                                    pad_blocks_to=pad_to)
            packed = (packed_gridder(pplan, fast=fast),
                      packed_gridder(psf_pplan, fast=fast))
        except SdpInvalidArgumentError:
            packed = None
        if packed is None and mesh is not None:
            raise ValueError(
                "bucketed=True with mesh requires a packed-compatible "
                "geometry (subgrid_size % 128 == 0, support <= 8)")
    if bucketed and packed is None:
        from ..parallel.bucketed import (
            inverse_index_of,
            plan_bucketed,
        )
        bplan, sort_index, valid = plan_bucketed(plan, np.asarray(uvw))
        inv = inverse_index_of(sort_index, valid, int(vis.size))
        psf_bplan, psf_sort, psf_valid = plan_bucketed(psf_plan,
                                                       np.asarray(uvw))
        bucket = dict(
            bplan=bplan, sort=jnp.asarray(sort_index),
            valid=jnp.asarray(valid), inv=jnp.asarray(inv),
            psf_bplan=psf_bplan, psf_sort=jnp.asarray(psf_sort),
            psf_valid=jnp.asarray(psf_valid))

    if weights is None:
        psf_vis = _ones_like(vis)
    else:
        # Imaging weights (e.g. visibility.briggs_weights output): the
        # PSF uses the weights, the data the weighted visibilities, and
        # the PSF-peak normalisation makes the scale consistent.
        weights = jnp.asarray(weights)
        psf_vis = weights.astype(vis.dtype)
        vis = _mul(vis, psf_vis)
    if timers:
        timers.pop_push("psf grid + sort")
    vis_sorted = None
    if packed is not None:
        gri, psf_gri = packed
        if mesh is not None:
            psf = psf_gri.grid_sharded(psf_vis, mesh)
        else:
            psf = psf_gri.grid(psf_vis)
        vis_sorted = gri.sort(vis)           # (re, im) f32 streams
        if weights is not None:
            w_sorted = gri.sort(weights.astype(vis.dtype))[0]
        else:
            w_sorted = None
    elif bucket is not None:
        psf = _bucketed_grid(bucket, psf_vis, uvw, psf=True)
    else:
        psf = _grid(psf_plan, psf_kernel, psf_vis, uvw, mesh)
    peak = psf[image_size, image_size]  # centre of the 2N PSF
    psf = _norm_mask(psf, peak, 2 * border)
    if timers:
        timers.sync(psf)
        timers.pop()

    if clean_algorithm == "msclean":
        minor = _make_msclean_minor(psf, tuple(int(s) for s in scale_list),
                                    float(loop_gain), int(cycle_limit),
                                    float(ms_scale_bias))
    elif clean_algorithm == "hogbom":
        minor = lambda dirty, stop: _minor_cycle(
            dirty, psf, float(loop_gain), stop, int(cycle_limit))
    else:
        raise ValueError(f"unknown clean_algorithm {clean_algorithm!r}")

    model = jnp.zeros((image_size, image_size), rdtype)
    residual_img = jnp.zeros_like(model)
    peak_history: List[float] = []
    start_cycle = 0
    if checkpoint_path is not None and checkpointer is not None:
        raise ValueError(
            "pass at most one of checkpoint_path / checkpointer")
    if checkpoint_path is not None:
        import os

        from .checkpoint import load_state, save_state
        if os.path.exists(checkpoint_path):
            model, residual_img, start_cycle, peak_history, _ = \
                load_state(checkpoint_path)
            model = model.astype(rdtype)
            residual_img = residual_img.astype(rdtype)
    elif checkpointer is not None and checkpointer.latest_step() is not None:
        model, residual_img, start_cycle, peak_history, _ = \
            checkpointer.restore(
                template={"model": model, "residual": residual_img})
        model = model.astype(rdtype)
        residual_img = residual_img.astype(rdtype)

    for cycle in range(start_cycle, n_major):
        if timers:
            timers.push("degrid predict")
        if packed is not None:
            # Sorted-stream residual: no per-iteration permutation
            # gathers — degrid, subtract and grid all stay in the
            # plan's bucket order.
            if mesh is not None:
                pred = gri.degrid_sorted_sharded(model, mesh)
            else:
                pred = gri.degrid_sorted(model)
            res_re, res_im = _packed_residual(vis_sorted[0],
                                              vis_sorted[1], pred,
                                              w_sorted)
            if timers:
                timers.sync(res_re, res_im)
                timers.pop_push("grid residual")
            if mesh is not None:
                raw = gri.grid_sorted_sharded(res_re, res_im, mesh)
            else:
                raw = gri.grid_sorted(res_re, res_im)
        else:
            if bucket is not None:
                pred = _bucketed_degrid(bucket, model, uvw).astype(
                    vis.dtype)
            else:
                pred = _degrid(plan, kernel, model, uvw, mesh, vis.dtype)
            if weights is not None:
                # dirty = A^T W (V - A model): weight the prediction too.
                pred = _mul(pred, psf_vis)
            res_vis = _sub(vis, pred)
            if timers:
                timers.sync(res_vis)
                timers.pop_push("grid residual")
            if bucket is not None:
                raw = _bucketed_grid(bucket, res_vis, uvw)
            else:
                raw = _grid(plan, kernel, res_vis, uvw, mesh)
        dirty = _norm_mask(raw, peak, border)
        if timers:
            timers.sync(dirty)
            timers.pop_push("minor cycle")
        stop = _stop_level(dirty, jnp.asarray(threshold, rdtype),
                           jnp.asarray(mgain, rdtype))
        delta, residual_img = minor(dirty, stop)
        model = _add(model, delta)
        peak_history.append(float(_abs_max(residual_img)))
        if timers:
            timers.pop()
        if checkpoint_path is not None:
            save_state(checkpoint_path, model, residual_img, cycle + 1,
                       peak_history)
        elif checkpointer is not None:
            checkpointer.save(cycle + 1, model, residual_img,
                              peak_history)
        if peak_history[-1] < threshold:
            break

    if timers:
        timers.push("restore")
    cbeam = create_cbeam(jnp.asarray(cbeam_details, rdtype),
                         int(cbeam_details[3]))
    restored = _restore(model, cbeam, residual_img)
    if timers:
        timers.sync(restored)
        timers.pop()
        timers.report(print_fn=lambda text: [
            log_info("%s", line) for line in text.splitlines()])
    return ImagingResult(model=model, residual=residual_img,
                         restored=restored, peak_history=peak_history)


@jax.jit
def _packed_residual(vre, vim, pred, w_sorted):
    """Sorted-stream residual (re, im): V - W * (A model)."""
    pre, pim = pred.real, pred.imag
    if w_sorted is not None:
        pre = pre * w_sorted
        pim = pim * w_sorted
    return vre - pre, vim - pim


@jax.jit
def _restore(model, cbeam, residual_img):
    convolved = fft_convolution(
        model.astype(jnp.result_type(model.dtype, jnp.complex64)), cbeam)
    return convolved.real.astype(model.dtype) + residual_img


def _make_msclean_minor(psf: Array, scales: Tuple[int, ...],
                        loop_gain: float, cycle_limit: int,
                        scale_bias: float = 0.0):
    """Multi-scale minor cycle closure: precompute scale kernels,
    doubly-convolved PSFs and the coupling matrix once per (psf,
    scales); per major cycle only the dirty-image scale convolutions
    and the on-chip peak-subtract loop run."""
    import numpy as np

    from ..clean.ms_clean import _make_scale_kernels, _ms_minor_cycle

    rdtype = psf.dtype
    cdtype = jnp.result_type(rdtype, jnp.complex64)
    psf_dim = psf.shape[0]
    scale_kernels = _make_scale_kernels(np.asarray(scales, np.int64),
                                        psf_dim, rdtype)
    # Cornwell 2008 small-scale selection bias: 1 - 0.6 s/s_max keeps
    # point sources from over-attributing flux to the largest scale.
    s_arr = np.asarray(scales, np.float64)
    s_max = s_arr.max() if s_arr.max() > 0 else 1.0
    bias_vec = np.asarray(1.0 - scale_bias * s_arr / s_max, np.float64) \
        if scale_bias else None

    def _conv(a, b):
        # Even-size 'same' convolution (scipy/reference convention)
        # shifts the result by +1 pixel per axis; unshift so the
        # scale-convolved psfs register with the raw kernel windows the
        # model is built from — required for the exact degrid
        # re-prediction to cancel the subtracted components.
        return jnp.roll(fft_convolution(a, b), (-1, -1), axis=(-2, -1))

    @jax.jit
    def _prep(psf):
        psf_c = psf.astype(cdtype)
        once = [_conv(psf_c, scale_kernels[s].astype(cdtype))
                for s in range(len(scales))]
        scaled_psfs = jnp.stack([
            jnp.stack([_conv(once[s], scale_kernels[p].astype(cdtype)).real
                       for p in range(len(scales))])
            for s in range(len(scales))]).astype(rdtype)
        coupling = jnp.max(
            scaled_psfs.reshape(len(scales), len(scales), -1), axis=-1)
        return scaled_psfs, coupling

    scaled_psfs, coupling = _prep(psf)

    @jax.jit
    def minor(dirty, stop):
        dirty_c = dirty.astype(cdtype)
        scaled_residuals = jnp.stack([
            _conv(dirty_c, scale_kernels[s].astype(cdtype)).real
            for s in range(len(scales))]).astype(rdtype)
        residuals, model = _ms_minor_cycle(
            scaled_residuals, scaled_psfs, scale_kernels, coupling,
            loop_gain, stop, cycle_limit, scale_bias=bias_vec)
        return model, residuals[0]

    return minor
