"""Native (C++/OpenMP) host runtime, bound via ctypes.

The device executes the jitted compute graphs; this module is the
framework's host-side runtime for visibility-metadata work on the ingest
path — task planning, uvw bounds, bucket sorting, prefix sums — the jobs
the reference does in C++/CUDA (sdp_grid_wstack_wtower.cpp:66-136,
sdp_tiled_functions.cpp) and that are latency-bound if routed through
per-op device dispatch.

The shared library is compiled from ``src/host_runtime.cpp`` on first
use (g++ -O3 -fopenmp) and cached next to the source, keyed by a source
hash. Every entry point has a NumPy fallback: `available()` says which
path is active.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "host_runtime.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i64 = ctypes.c_int64
_dbl = ctypes.c_double
_p_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build_and_load() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    cache_dir = os.environ.get(
        "SKA_SDP_FUNC_JAX_NATIVE_CACHE",
        os.path.join(os.path.dirname(__file__), "_build"))
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"host_runtime_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
               "-std=c++17", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None

    lib.sdp_host_uvw_bounds.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _p_i32, _p_i32, _p_dbl, _p_dbl]
    lib.sdp_host_uvw_bounds.restype = None
    lib.sdp_host_plan_wstack.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64, _dbl, _dbl,
        _i64, _i64, _i64, _i64, _i64, _i64, _p_i64, _p_dbl, _p_dbl]
    lib.sdp_host_plan_wstack.restype = None
    lib.sdp_host_sort_rows_by_w.argtypes = [_p_dbl, _i64, _p_i64]
    lib.sdp_host_sort_rows_by_w.restype = None
    _p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    _p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.sdp_host_packed_buckets.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64,
        _dbl, _dbl, _dbl, _dbl,
        _i64, _i64, _i64, _i64, _i64,
        _p_i64, _p_i64, _p_i64, _p_i64,
        _i64, _i64, _i64,
        _p_i64, _p_i64]
    lib.sdp_host_packed_buckets.restype = _i64
    lib.sdp_host_packed_fill.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64,
        _dbl, _dbl, _dbl, _dbl,
        _i64, _i64, _i64, _i64, _i64,
        _p_i64, _p_i64, _p_i64,
        _p_i64, _p_i64, _i64,
        _p_dbl, _p_dbl,
        _p_i64, _p_u8, _p_i32, _p_i32,
        _p_f32, _p_f32, _p_f32,
        _p_i32, _p_i32, _p_i32]
    lib.sdp_host_packed_fill.restype = None
    lib.sdp_host_prefix_sum.argtypes = [_p_i64, _i64, _p_i64]
    lib.sdp_host_prefix_sum.restype = None
    lib.sdp_host_packed_tasks.argtypes = [
        _p_dbl, _i64, _dbl, _dbl, _i64, _dbl, _dbl, _i64,
        _p_i64, _p_i64, _p_dbl, _p_dbl]
    lib.sdp_host_packed_tasks.restype = _i64
    _p_u8c = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sdp_host_hash64.argtypes = [_p_u8c, _i64, ctypes.c_uint64]
    lib.sdp_host_hash64.restype = ctypes.c_uint64
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        with _LOCK:
            if _LIB is None and not _TRIED:
                if os.environ.get("SKA_SDP_FUNC_JAX_NO_NATIVE"):
                    _LIB = None
                else:
                    _LIB = _build_and_load()
                _TRIED = True
    return _LIB


def available() -> bool:
    """True when the compiled native runtime is active."""
    return _get_lib() is not None


def uvw_bounds(uvw, freq0_hz: float, dfreq_hz: float, start_chs,
               end_chs) -> Tuple[np.ndarray, np.ndarray]:
    """Host uvw bounds (native or NumPy fallback)."""
    uvw = np.ascontiguousarray(uvw, np.float64)
    start_chs = np.ascontiguousarray(start_chs, np.int32)
    end_chs = np.ascontiguousarray(end_chs, np.int32)
    lib = _get_lib()
    if lib is not None:
        lo = np.empty(3)
        hi = np.empty(3)
        lib.sdp_host_uvw_bounds(uvw, uvw.shape[0], freq0_hz, dfreq_hz,
                               start_chs, end_chs, lo, hi)
        return lo, hi
    u0 = freq0_hz * uvw / 299792458.0
    du = dfreq_hz * uvw / 299792458.0
    a = u0 + start_chs[:, None] * du
    b = u0 + (end_chs[:, None] - 1.0) * du
    lo = np.where(uvw >= 0, a, b)
    hi = np.where(uvw >= 0, b, a)
    act = (start_chs < end_chs)[:, None]
    lo = np.where(act, lo, np.inf)
    hi = np.where(act, hi, -np.inf)
    return lo.min(axis=0), hi.max(axis=0)


def plan_wstack_boxes(uvw, freq0_hz: float, dfreq_hz: float,
                      num_chan: int, eff_sg_dist: float,
                      w_stack_dist: float, iu_range, iv_range, iw_range
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Counts and scaled-w bounds for every (iw, iu, iv) box.

    Returns (counts, wmin, wmax) each shaped [n_iw, n_iu, n_iv].
    """
    min_iu, max_iu = iu_range
    min_iv, max_iv = iv_range
    min_iw, max_iw = iw_range
    n_iu = max_iu - min_iu + 1
    n_iv = max_iv - min_iv + 1
    n_iw = max_iw - min_iw + 1
    uvw = np.ascontiguousarray(uvw, np.float64)
    lib = _get_lib()
    if lib is None:
        return _plan_wstack_boxes_np(
            uvw, freq0_hz, dfreq_hz, num_chan, eff_sg_dist, w_stack_dist,
            min_iu, n_iu, min_iv, n_iv, min_iw, n_iw)
    counts = np.empty(n_iw * n_iu * n_iv, np.int64)
    wmin = np.empty_like(counts, dtype=np.float64)
    wmax = np.empty_like(wmin)
    lib.sdp_host_plan_wstack(
        uvw, uvw.shape[0], freq0_hz, dfreq_hz, num_chan, eff_sg_dist,
        w_stack_dist, min_iu, n_iu, min_iv, n_iv, min_iw, n_iw,
        counts, wmin, wmax)
    shape = (n_iw, n_iu, n_iv)
    return counts.reshape(shape), wmin.reshape(shape), wmax.reshape(shape)


def _clamp_np(u, freq0, dfreq, start, end, min_u, max_u):
    u0 = freq0 * u / 299792458.0
    du = dfreq * u / 299792458.0
    eta = np.maximum(np.abs(min_u - u0), np.abs(max_u - u0)) / 2147483645.0
    safe = np.where(np.abs(du) > eta, du, 1.0)
    lo = np.ceil((min_u - u0) / safe)
    hi = np.ceil((max_u - u0) / safe)
    pos = du > eta
    neg = du < -eta
    s = np.where(pos, np.maximum(start, lo),
                 np.where(neg, np.maximum(start, hi), start))
    e = np.where(pos, np.minimum(end, hi),
                 np.where(neg, np.minimum(end, lo), end))
    outside = ~pos & ~neg & ((min_u > u0) | (max_u <= u0))
    s = np.where(outside, 0, s)
    e = np.where(outside, 0, e)
    empty = e <= s
    return np.where(empty, 0, s), np.where(empty, 0, e)


def _plan_wstack_boxes_np(uvw, freq0, dfreq, num_chan, eff_sg_dist,
                          w_stack_dist, min_iu, n_iu, min_iv, n_iv,
                          min_iw, n_iw):
    counts = np.zeros((n_iw, n_iu, n_iv), np.int64)
    wmin = np.full((n_iw, n_iu, n_iv), np.inf)
    wmax = np.full((n_iw, n_iu, n_iv), -np.inf)
    u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    zeros = np.zeros(uvw.shape[0])
    full = np.full(uvw.shape[0], float(num_chan))
    w0 = freq0 * w / 299792458.0
    dw = dfreq * w / 299792458.0
    for jw in range(n_iw):
        lo_w = (min_iw + jw) * w_stack_dist - w_stack_dist / 2
        s_w, e_w = _clamp_np(w, freq0, dfreq, zeros, full, lo_w,
                             lo_w + w_stack_dist)
        if not np.any(s_w < e_w):
            continue
        for ju in range(n_iu):
            lo_u = (min_iu + ju) * eff_sg_dist - eff_sg_dist / 2
            s_u, e_u = _clamp_np(u, freq0, dfreq, s_w, e_w, lo_u,
                                 lo_u + eff_sg_dist)
            if not np.any(s_u < e_u):
                continue
            for jv in range(n_iv):
                lo_v = (min_iv + jv) * eff_sg_dist - eff_sg_dist / 2
                s, e = _clamp_np(v, freq0, dfreq, s_u, e_u, lo_v,
                                 lo_v + eff_sg_dist)
                sel = s < e
                if not np.any(sel):
                    continue
                counts[jw, ju, jv] = int(np.sum(e[sel] - s[sel]))
                a = w0[sel] + s[sel] * dw[sel]
                b = w0[sel] + (e[sel] - 1) * dw[sel]
                wmin[jw, ju, jv] = min(a.min(), b.min())
                wmax[jw, ju, jv] = max(a.max(), b.max())
    return counts, wmin, wmax


def packed_plan_arrays(uvw, freq0_hz, dfreq_hz, num_chan, eff_sg_dist,
                       theta, w_step, height, ov, w_ov, sgs, support,
                       w_support, task_id, first_t, off_w_t,
                       num_planes_t, num_slabs, num_octets, block_v,
                       uv_table, w_table):
    """Native two-pass packed-ingest planner (see host_runtime.cpp).

    Returns None when the native library is unavailable (the caller
    falls back to the NumPy path), else a dict with the padded sorted
    arrays + bucket counts; raises on the processed-vis invariant.
    """
    lib = _get_lib()
    if lib is None:
        return None
    uvw = np.ascontiguousarray(uvw, np.float64)
    task_id = np.ascontiguousarray(task_id, np.int64)
    first_t = np.ascontiguousarray(first_t, np.int64)
    off_w_t = np.ascontiguousarray(off_w_t, np.int64)
    num_planes_t = np.ascontiguousarray(num_planes_t, np.int64)
    uv_table = np.ascontiguousarray(uv_table, np.float64)
    w_table = np.ascontiguousarray(w_table, np.float64)
    num_rows = uvw.shape[0]
    num_vis = num_rows * num_chan
    num_buckets = int(first_t.shape[0]) * num_slabs * num_octets

    bucket = np.empty(num_vis, np.int64)
    counts = np.empty(num_buckets, np.int64)
    bad = lib.sdp_host_packed_buckets(
        uvw, num_rows, freq0_hz, dfreq_hz, num_chan,
        eff_sg_dist, theta, w_step, height,
        ov, w_ov, sgs, support, w_support,
        task_id, first_t, off_w_t, num_planes_t,
        num_slabs, num_octets, num_buckets, bucket, counts)
    if bad:
        from ..utility.errors import SdpRuntimeError

        raise SdpRuntimeError(
            f"packed plan: {int(bad)} of {num_vis} visibilities fall "
            "outside their task's w-tower range")

    padded = -(-counts // block_v) * block_v
    pad_off = np.zeros(num_buckets + 1, np.int64)
    np.cumsum(padded, out=pad_off[1:])
    total = int(pad_off[-1])

    # np.empty: the native fill writes every valid slot and memsets the
    # pad tails itself (np.zeros cost ~0.6 s of memset per warm 4M-vis
    # plan on the single-core host).
    sort_index = np.empty(total, np.int64)
    valid = np.empty(total, np.uint8)
    u_off = np.empty(total, np.int32)
    iv0 = np.empty(total, np.int32)
    uk = np.empty((total, support), np.float32)
    vk = np.empty((total, support), np.float32)
    wk = np.empty((total, w_support), np.float32)
    u_frac = np.empty(total, np.int32)
    v_frac = np.empty(total, np.int32)
    w_row = np.empty(total, np.int32)
    lib.sdp_host_packed_fill(
        uvw, num_rows, freq0_hz, dfreq_hz, num_chan,
        eff_sg_dist, theta, w_step, height,
        ov, w_ov, sgs, support, w_support,
        task_id, first_t, off_w_t,
        bucket, pad_off, num_buckets,
        uv_table, w_table,
        sort_index, valid, u_off, iv0, uk, vk, wk,
        u_frac, v_frac, w_row)
    return dict(sort_index=sort_index, valid=valid.astype(bool),
                u_off=u_off, iv0=iv0, uk=uk, vk=vk, wk=wk,
                u_frac=u_frac, v_frac=v_frac, w_row=w_row,
                counts=counts, padded=padded, total=total,
                block_v=block_v)


def packed_tasks(uvw, freq0_hz: float, dfreq_hz: float, num_chan: int,
                 eff_sg_dist: float, w_stack_dist: float):
    """Native task enumeration for the packed planner.

    Returns (task_id [rows*chan], boxes [T, 3] as (biw, biu, biv),
    wmin_t, wmax_t) with tasks in ascending packed-key order (the
    NumPy path's np.unique semantics), or None when the native library
    is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    uvw = np.ascontiguousarray(uvw, np.float64)
    num_rows = uvw.shape[0]
    num_vis = num_rows * num_chan
    max_tasks = 1 << 20
    task_id = np.empty(num_vis, np.int64)
    keys = np.empty(max_tasks, np.int64)
    wmin = np.empty(max_tasks, np.float64)
    wmax = np.empty(max_tasks, np.float64)
    n = int(lib.sdp_host_packed_tasks(
        uvw, num_rows, freq0_hz, dfreq_hz, num_chan, eff_sg_dist,
        w_stack_dist, max_tasks, task_id, keys, wmin, wmax))
    if n < 0:
        return None
    keys = keys[:n]
    span = 1 << 20
    boxes = np.stack([keys // (span * span) - span // 2,
                      (keys // span) % span - span // 2,
                      keys % span - span // 2], axis=1)
    return task_id, boxes, wmin[:n].copy(), wmax[:n].copy()


def hash_arrays(arrays) -> Optional[str]:
    """Chained 64-bit content digest over a sequence of ndarrays
    (plan cache identity; ~20x sha256's rate on multicore hosts).
    Returns None when the native library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    acc = 14695981039346656037
    for a in arrays:
        buf = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        acc = int(lib.sdp_host_hash64(buf, buf.size,
                                     ctypes.c_uint64(acc).value))
    return f"fnv64:{acc:016x}"


def sort_rows_by_w(uvw) -> np.ndarray:
    """Stable argsort of rows by w (bucket-sort permutation)."""
    uvw = np.ascontiguousarray(uvw, np.float64)
    lib = _get_lib()
    if lib is not None:
        perm = np.empty(uvw.shape[0], np.int64)
        lib.sdp_host_sort_rows_by_w(uvw, uvw.shape[0], perm)
        return perm
    return np.argsort(uvw[:, 2], kind="stable")


def prefix_sum(counts) -> np.ndarray:
    """Exclusive prefix sum with total appended (length n+1)."""
    counts = np.ascontiguousarray(counts, np.int64).reshape(-1)
    lib = _get_lib()
    if lib is not None:
        out = np.empty(counts.size + 1, np.int64)
        lib.sdp_host_prefix_sum(counts, counts.size, out)
        return out
    out = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=out[1:])
    return out


__all__ = [
    "available",
    "hash_arrays",
    "packed_plan_arrays",
    "packed_tasks",
    "plan_wstack_boxes",
    "prefix_sum",
    "sort_rows_by_w",
    "uvw_bounds",
]
