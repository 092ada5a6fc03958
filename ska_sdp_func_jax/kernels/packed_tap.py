"""Bucket-blocked gridding and degridding for the packed w-towers path.

The packed plan (:mod:`ska_sdp_func_jax.parallel.packed`) sorts the
visibility stream into **buckets** keyed by ``(task, w-slab k0,
u-octet g)`` and pads each bucket to a multiple of ``block_v`` slots.
Every visibility of a bucket touches the same 16-row window
``u in [8g, 8g+16)`` of the same ``w_support`` absolute layers
``k0 .. k0+w_support-1`` of its task's tower stack, so a bucket's
whole contribution is one matrix product

    window[m, c] += sum_p U[m, p] * V[p, c]

over its slots ``p``.  Window row ``m = (h*4 + l)*16 + r`` holds grid
row ``u = 8g + r`` of layer ``k0 + l``, real part for ``h = 0`` and
imaginary part for ``h = 1``; ``U[m, p] = uk[r - u_off[p], p] *
wk[l, p] * (re|im)(vis[p])`` and ``V[p, c] = vk[c - iv0[p], p]`` (taps
are zero outside their support).  Degridding is the adjoint: each slot
reads ``sum_{m, c} U[m, p] * window[m, c] * V[p, c]`` with ``U``
carrying no visibility.

Stack layout (shared with the drivers): ``[T, 2, K*(N+8), N]`` f32 —
re/im planes of every task's K-layer tower, each layer padded by 8
rows because the last octet's 16-row window overhangs the subgrid.

Two implementations of each direction:

* a Pallas kernel through Triton (``backend="triton"``): one program
  per bucket and 128-lane chunk.  The program builds ``U`` and ``V``
  tile by tile in registers from the per-slot taps, sums the bucket's
  ``[128, 128]`` window in registers and writes it once; a dense XLA
  fold adds the overlapping windows of neighbouring octets and slabs
  into the stack.  The degrid program loads its bucket's window once
  and writes the bucket's visibilities; programs never share outputs.
* the plain XLA formulation: per-block batched products, then a
  scatter-add into (or a gather from) the stack.  It is the reference
  the kernels are checked against, and the path on the CPU.

:func:`grid_stack` / :func:`degrid_stack` pick the kernel on the GPU
for the bf16-product precisions (``"high"``, ``"bf16"``) and the XLA
formulation on the CPU and for ``"highest"`` (see
``KERNEL_PRECISIONS``; the platform comes from
:mod:`ska_sdp_func_jax.utility.device`); ``interpret=True`` runs the
kernel in the Pallas interpreter.

Reference equivalent: the per-row atomicAdd scatter and per-row gather
of sdp_gridder_wtower_uvw.cu:129-241; the bucket sort follows the
reference's tiling idea (sdp_tiled_functions.cu).
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..utility.device import use_gpu_kernels

Array = jax.Array

WIN_ROWS = 16             # 8-aligned octet base + support (<= 8)
MAX_SUPPORT = 8
MAX_W_SUPPORT = 4
WIN_M = 2 * MAX_W_SUPPORT * WIN_ROWS      # window rows (re/im x layer x u)
LANE_CHUNK = 128          # lanes per kernel program
TILE_V = 32               # slots per kernel step (the product's depth)
PRECISIONS = ("highest", "high", "bf16")
# Precisions the kernels run. Triton's true-f32 (IEEE) product is a
# CUDA-core loop that ran 2-20x slower than XLA's f32 formulation on an
# H100, so "highest" runs the XLA formulation on every platform.
KERNEL_PRECISIONS = ("high", "bf16")


class Taps(NamedTuple):
    """Per-slot operands of the packed stream (sorted order).

    ``u_off``: [V] int32 in [0, 8), u cell inside the octet window;
    ``iv0``: [V] int32, first v cell; ``uk``/``vk``: [S, V] f32 u/v
    taps; ``wk``: [Sw, V] f32 w taps, zero on padding and invalid slots
    (which is what keeps them out of both directions).
    """

    u_off: Array
    iv0: Array
    uk: Array
    vk: Array
    wk: Array


def split_bf16(x, pieces: int = 2):
    """bf16 decomposition ``x ~ sum(pieces)``, robust to excess-precision
    folding; each further piece adds ~8 mantissa bits.

    The naive ``x - f32(bf16(x))`` may be folded to zero by a compiler
    allowed excess precision (XLA on the GPU, LLVM on the CPU). Round
    the upper 16 bits to nearest-even explicitly instead; the
    subtraction is then plain f32 arithmetic nothing can fold away.
    """
    parts = []
    for _ in range(pieces - 1):
        u = jax.lax.bitcast_convert_type(x, jnp.uint32)
        rounded = (u + jnp.uint32(0x7FFF) + ((u >> 16) & jnp.uint32(1))) \
            & jnp.uint32(0xFFFF0000)
        hi_f = jax.lax.bitcast_convert_type(rounded, jnp.float32)
        parts.append(hi_f.astype(jnp.bfloat16))
        x = x - hi_f
    parts.append(x.astype(jnp.bfloat16))
    return tuple(parts)


def _dot(a, b, precision: str, dims=None):
    """f32 product at one of the three precision modes, f32 out.

    ``highest``: true f32 (not TF32);
    ``high``: three-piece bf16 split of both operands and the six
    single-pass bf16 products down to ~2^-24 relative (a two-piece
    split keeps only ~2^-17 per operand: 1.1e-5 of peak on the
    1024^2 degrid, outside the 1e-5 budget);
    ``bf16``: ``a`` rounded to bf16 once, the tap operand ``b`` split
    in two (two single-pass products; rounding both operands cost
    5.2e-3 of peak on the 1024^2 degrid, outside the 5e-3 budget).
    ``b`` is the kernels' tap band in every call. ``dims``:
    dot_general dimension numbers (default: plain [M, K] @ [K, N]).
    """
    if dims is None:
        def d(x, y, prec):
            return jnp.dot(x, y, preferred_element_type=jnp.float32,
                           precision=prec)
    else:
        def d(x, y, prec):
            return jax.lax.dot_general(
                x, y, dims, preferred_element_type=jnp.float32,
                precision=prec)
    if precision == "bf16":
        a0 = a.astype(jnp.bfloat16)
        b0, b1 = split_bf16(b)
        p = jax.lax.Precision.DEFAULT
        return d(a0, b0, p) + d(a0, b1, p)
    if precision == "high":
        a0, a1, a2 = split_bf16(a, 3)
        b0, b1, b2 = split_bf16(b, 3)
        p = jax.lax.Precision.DEFAULT
        small = d(a0, b2, p) + d(a1, b1, p) + d(a2, b0, p)
        return d(a0, b0, p) + ((d(a0, b1, p) + d(a1, b0, p)) + small)
    if precision != "highest":
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return d(a, b, jax.lax.Precision.HIGHEST)


def _window_rows(t, k0, g, m, num_layers: int, lanes: int,
                 w_support: int):
    """Flat stack row of window row ``m`` of bucket ``(t, k0, g)``.

    Rows of layers beyond ``w_support`` (zero taps) are clamped onto
    the last real layer so every address stays inside the stack.
    """
    r = m & (WIN_ROWS - 1)
    layer = jnp.minimum((m >> 4) & (MAX_W_SUPPORT - 1), w_support - 1)
    half = m >> 6
    return (((t * 2 + half) * num_layers + k0 + layer) * (lanes + 8)
            + 8 * g + r)


def _run_lengths(t_idx, k_idx, g_idx, num_layers: int, lanes: int,
                 nonempty=None):
    """Blocks in each bucket run, stored at the run's first block (0
    elsewhere). Empty blocks (``nonempty`` False) join no run."""
    nb = t_idx.shape[0]
    key = (t_idx * num_layers + k_idx) * (lanes // 8) + g_idx
    blk = jnp.arange(nb, dtype=jnp.int32)
    if nonempty is not None:
        key = jnp.where(nonempty, key, -1 - blk)
    first = jnp.concatenate([jnp.ones((1,), bool), key[1:] != key[:-1]])
    run = jnp.cumsum(first.astype(jnp.int32)) - 1
    length = jnp.zeros((nb,), jnp.int32).at[run].add(1)
    live = first if nonempty is None else first & nonempty
    return jnp.where(live, length[run], 0)


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------


def _tile_u(uoff_ref, uk_ref, wk_ref, sl, support: int, w_support: int):
    """[WIN_M, TILE_V] u-tap x w-tap rows of one tile of slots."""
    m = jax.lax.broadcasted_iota(jnp.int32, (WIN_M, TILE_V), 0)
    r = m & (WIN_ROWS - 1)
    layer = (m >> 4) & (MAX_W_SUPPORT - 1)
    u_off = uoff_ref[sl][None, :]
    ub = jnp.zeros((WIN_M, TILE_V), jnp.float32)
    for s in range(support):
        ub = jnp.where(r == u_off + s, uk_ref[s, sl][None, :], ub)
    wsel = jnp.zeros((WIN_M, TILE_V), jnp.float32)
    for w in range(w_support):
        wsel = jnp.where(layer == w, wk_ref[w, sl][None, :], wsel)
    return ub * wsel


def _tile_v(iv0_ref, vk_ref, sl, lane0, support: int, transpose: bool):
    """v-tap band of one tile over one lane chunk: [TILE_V, LANE_CHUNK]
    (``transpose``: [LANE_CHUNK, TILE_V])."""
    if transpose:
        shape, c_dim = (LANE_CHUNK, TILE_V), 0
        iv0 = iv0_ref[sl][None, :]
    else:
        shape, c_dim = (TILE_V, LANE_CHUNK), 1
        iv0 = iv0_ref[sl][:, None]
    c = jax.lax.broadcasted_iota(jnp.int32, shape, c_dim) + lane0
    vb = jnp.zeros(shape, jnp.float32)
    for s in range(support):
        vk = vk_ref[s, sl]
        vk = vk[None, :] if transpose else vk[:, None]
        vb = jnp.where(c == iv0 + s, vk, vb)
    return vb


def _grid_kernel(start_ref, nblk_ref, uoff_ref, iv0_ref, uk_ref, vk_ref,
                 wk_ref, vre_ref, vim_ref, win_ref, *, support: int,
                 w_support: int, block_v: int, precision: str):
    bucket = pl.program_id(0)
    lane0 = pl.program_id(1) * LANE_CHUNK
    n_tiles = nblk_ref[bucket] * (block_v // TILE_V)
    start = start_ref[bucket] * block_v
    half = jax.lax.broadcasted_iota(jnp.int32, (WIN_M, TILE_V), 0) >> 6

    def body(i, acc):
        sl = pl.ds(start + i * TILE_V, TILE_V)
        vis = jnp.where(half == 0, vre_ref[sl][None, :],
                        vim_ref[sl][None, :])
        u = _tile_u(uoff_ref, uk_ref, wk_ref, sl, support, w_support)
        v = _tile_v(iv0_ref, vk_ref, sl, lane0, support, False)
        return acc + _dot(u * vis, v, precision)

    acc = jax.lax.fori_loop(0, n_tiles, body,
                            jnp.zeros((WIN_M, LANE_CHUNK), jnp.float32))
    win_ref[pl.ds(bucket * WIN_M, WIN_M), pl.ds(lane0, LANE_CHUNK)] = acc


def _degrid_kernel(nblk_ref, t_ref, k_ref, g_ref, uoff_ref, iv0_ref,
                   uk_ref, vk_ref, wk_ref, stack_ref, _re_in, _im_in,
                   re_ref, im_ref, *, num_layers: int, lanes: int,
                   support: int, w_support: int, block_v: int,
                   precision: str):
    b = pl.program_id(0)
    n_tiles = nblk_ref[b] * (block_v // TILE_V)

    @pl.when(n_tiles > 0)
    def _():
        _degrid_run(b, n_tiles, t_ref, k_ref, g_ref, uoff_ref, iv0_ref,
                    uk_ref, vk_ref, wk_ref, stack_ref, re_ref, im_ref,
                    num_layers=num_layers, lanes=lanes, support=support,
                    w_support=w_support, block_v=block_v,
                    precision=precision)


def _degrid_run(b, n_tiles, t_ref, k_ref, g_ref, uoff_ref, iv0_ref,
                uk_ref, vk_ref, wk_ref, stack_ref, re_ref, im_ref, *,
                num_layers: int, lanes: int, support: int, w_support: int,
                block_v: int, precision: str):
    start = b * block_v
    m = jax.lax.broadcasted_iota(jnp.int32, (WIN_M, LANE_CHUNK), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (WIN_M, LANE_CHUNK), 1)
    rows = _window_rows(t_ref[b], k_ref[b], g_ref[b], m, num_layers,
                        lanes, w_support)
    chunks = range(0, lanes, LANE_CHUNK)

    def window(lane0):
        return stack_ref[rows, c + lane0]

    # One lane chunk (the common subgrid of 128): load the bucket's
    # window once; wider subgrids re-read it per tile from L2.
    resident = window(0) if lanes == LANE_CHUNK else None
    half = jax.lax.broadcasted_iota(jnp.int32, (WIN_M, TILE_V), 0) >> 6

    def body(i, carry):
        sl = pl.ds(start + i * TILE_V, TILE_V)
        t = None
        for lane0 in chunks:
            win = resident if resident is not None else window(lane0)
            v_t = _tile_v(iv0_ref, vk_ref, sl, lane0, support, True)
            part = _dot(win, v_t, precision)
            t = part if t is None else t + part
        prod = t * _tile_u(uoff_ref, uk_ref, wk_ref, sl, support,
                           w_support)
        re_ref[sl] = jnp.sum(jnp.where(half == 0, prod, 0.0), axis=0)
        im_ref[sl] = jnp.sum(jnp.where(half == 0, 0.0, prod), axis=0)
        return carry

    jax.lax.fori_loop(0, n_tiles, body, 0)


def _check_geometry(lanes: int, support: int, w_support: int,
                    block_v: int, precision: str):
    if precision not in KERNEL_PRECISIONS:
        raise ValueError(f"the kernels run precision {KERNEL_PRECISIONS}"
                         f", got {precision!r}")
    if lanes % LANE_CHUNK or support > MAX_SUPPORT \
            or w_support > MAX_W_SUPPORT or block_v % TILE_V:
        raise ValueError(
            f"packed kernels need subgrid % {LANE_CHUNK} == 0, support <= "
            f"{MAX_SUPPORT}, w_support <= {MAX_W_SUPPORT} and block_v % "
            f"{TILE_V} == 0 (got {lanes}, {support}, {w_support}, "
            f"{block_v})")


# Four warps and 32-slot tiles ran fastest of {4, 8} x {32, 64} on an
# H100 at the 1024^2 / 4.2M-visibility plan.
_COMPILER = pltriton.CompilerParams(num_warps=4, num_stages=2)


def _bucket_runs(t_idx, k_idx, g_idx, num_tasks: int, num_layers: int,
                 lanes: int, w_support: int, nonempty=None):
    """(first block, block count) of every bucket's run; buckets
    ``(t*S + k)*G + g`` with no live block get count 0."""
    num_slabs = num_layers - w_support + 1
    num_octets = lanes // 8
    nbk = num_tasks * num_slabs * num_octets
    nblk = _run_lengths(t_idx, k_idx, g_idx, num_layers, lanes, nonempty)
    key = (t_idx * num_slabs + k_idx) * num_octets + g_idx
    key = jnp.where(nblk > 0, key, nbk)
    blk = jnp.arange(t_idx.shape[0], dtype=jnp.int32)
    start = jnp.zeros((nbk,), jnp.int32).at[key].set(blk, mode="drop")
    count = jnp.zeros((nbk,), jnp.int32).at[key].set(nblk, mode="drop")
    return start, count


def fold_windows(win, num_tasks: int, num_layers: int, lanes: int,
                 w_support: int) -> Array:
    """Per-bucket windows ``[T*S*G*WIN_M, N]`` -> ``[T, 2, K*(N+8), N]``
    stack: each window's two 8-row halves land on their octet and the
    next, each slab's layers on absolute layers ``k0 + l`` (dense
    slice-adds, no scatter)."""
    num_slabs = num_layers - w_support + 1
    g = lanes // 8
    w = win.reshape(num_tasks, num_slabs, g, 2, MAX_W_SUPPORT, WIN_ROWS,
                    lanes)[:, :, :, :, :w_support]
    zero = ((0, 0),) * 7
    lo = jnp.pad(w[..., :8, :], zero[:2] + ((0, 1),) + zero[3:])
    hi = jnp.pad(w[..., 8:, :], zero[:2] + ((1, 0),) + zero[3:])
    rows = jnp.moveaxis(lo + hi, 2, 4).reshape(
        num_tasks, num_slabs, 2, w_support, (g + 1) * 8, lanes)
    stack = None
    for layer in range(w_support):
        part = jnp.pad(rows[:, :, :, layer],
                       ((0, 0), (layer, w_support - 1 - layer),
                        (0, 0), (0, 0), (0, 0)))
        stack = part if stack is None else stack + part
    return jnp.moveaxis(stack, 1, 2).reshape(
        num_tasks, 2, num_layers * (lanes + 8), lanes)


def grid_stack_triton(taps: Taps, t_idx, k_idx, g_idx, vre, vim,
                      num_tasks: int, num_layers: int, lanes: int,
                      block_v: int, precision: str = "high",
                      nonempty=None, interpret: bool = False) -> Array:
    """Triton gridding kernel -> ``[T, 2, K*(N+8), N]`` stack.

    One program per bucket (and lane chunk) writes the bucket's summed
    window, zero for an empty bucket, so every window is written once
    and no atomics are needed; :func:`fold_windows` then adds the
    overlapping windows into the stack.
    """
    support, w_support = taps.uk.shape[0], taps.wk.shape[0]
    _check_geometry(lanes, support, w_support, block_v, precision)
    start, count = _bucket_runs(t_idx, k_idx, g_idx, num_tasks,
                                num_layers, lanes, w_support, nonempty)
    kern = functools.partial(
        _grid_kernel, support=support, w_support=w_support,
        block_v=block_v, precision=precision)
    win = pl.pallas_call(
        kern, grid=(start.shape[0], lanes // LANE_CHUNK),
        out_shape=jax.ShapeDtypeStruct((start.shape[0] * WIN_M, lanes),
                                       jnp.float32),
        compiler_params=_COMPILER, backend="triton", interpret=interpret,
        name="packed_grid",
    )(start, count, taps.u_off, taps.iv0, taps.uk, taps.vk, taps.wk,
      vre, vim)
    return fold_windows(win, num_tasks, num_layers, lanes, w_support)


def degrid_stack_triton(stack, taps: Taps, t_idx, k_idx, g_idx,
                        block_v: int, precision: str = "high",
                        nonempty=None, interpret: bool = False):
    """Triton degridding kernel -> (re, im) [V] f32 in stream order."""
    support, w_support = taps.uk.shape[0], taps.wk.shape[0]
    num_tasks, _, ksp, lanes = stack.shape
    num_layers = ksp // (lanes + 8)
    _check_geometry(lanes, support, w_support, block_v, precision)
    total = taps.u_off.shape[0]
    nblk = _run_lengths(t_idx, k_idx, g_idx, num_layers, lanes, nonempty)
    kern = functools.partial(
        _degrid_kernel, num_layers=num_layers, lanes=lanes,
        support=support, w_support=w_support, block_v=block_v,
        precision=precision)
    return pl.pallas_call(
        kern, grid=(t_idx.shape[0],),
        out_shape=(jax.ShapeDtypeStruct((total,), jnp.float32),) * 2,
        input_output_aliases={10: 0, 11: 1}, compiler_params=_COMPILER,
        backend="triton", interpret=interpret, name="packed_degrid",
    )(nblk, t_idx, k_idx, g_idx, taps.u_off, taps.iv0, taps.uk, taps.vk,
      taps.wk, stack.reshape(-1, lanes), jnp.zeros((total,), jnp.float32),
      jnp.zeros((total,), jnp.float32))


# ---------------------------------------------------------------------------
# Plain XLA formulation (the reference, and the CPU path)
# ---------------------------------------------------------------------------


def _blocks(x, nb: int):
    """[..., V] -> [nb, ..., B] per-block view."""
    x = x.reshape(x.shape[:-1] + (nb, -1))
    return jnp.moveaxis(x, -2, 0)


def _block_u(taps: Taps, nb: int):
    """[nb, WIN_M, B] u-tap x w-tap rows of every block."""
    m = jnp.arange(WIN_M, dtype=jnp.int32)[None, :, None]
    r = m & (WIN_ROWS - 1)
    layer = (m >> 4) & (MAX_W_SUPPORT - 1)
    u_off = _blocks(taps.u_off, nb)[:, None, :]
    uk, wk = _blocks(taps.uk, nb), _blocks(taps.wk, nb)
    ub = jnp.zeros((nb, WIN_M, u_off.shape[-1]), jnp.float32)
    for s in range(uk.shape[1]):
        ub = jnp.where(r == u_off + s, uk[:, s:s + 1], ub)
    wsel = jnp.zeros_like(ub)
    for w in range(wk.shape[1]):
        wsel = jnp.where(layer == w, wk[:, w:w + 1], wsel)
    return ub * wsel


def _block_v(taps: Taps, nb: int, lanes: int):
    """[nb, B, lanes] v-tap bands of every block."""
    c = jnp.arange(lanes, dtype=jnp.int32)
    iv0 = _blocks(taps.iv0, nb)[:, :, None]
    vk = _blocks(taps.vk, nb)
    vb = jnp.zeros(iv0.shape[:2] + (lanes,), jnp.float32)
    for s in range(vk.shape[1]):
        vb = jnp.where(c == iv0 + s, vk[:, s, :, None], vb)
    return vb


def _block_rows(t_idx, k_idx, g_idx, num_layers: int, lanes: int,
                w_support: int):
    m = jnp.arange(WIN_M, dtype=jnp.int32)[None, :]
    return _window_rows(t_idx[:, None], k_idx[:, None], g_idx[:, None], m,
                        num_layers, lanes, w_support)


def grid_stack_xla(taps: Taps, t_idx, k_idx, g_idx, vre, vim,
                   num_tasks: int, num_layers: int, lanes: int,
                   precision: str = "highest") -> Array:
    """Plain XLA gridding -> ``[T, 2, K*(N+8), N]`` stack."""
    nb = t_idx.shape[0]
    w_support = taps.wk.shape[0]
    half = (jnp.arange(WIN_M) >> 6)[None, :, None]
    vis = jnp.where(half == 0, _blocks(vre, nb)[:, None, :],
                    _blocks(vim, nb)[:, None, :])
    contrib = _dot(_block_u(taps, nb) * vis, _block_v(taps, nb, lanes),
                   precision, dims=(((2,), (1,)), ((0,), (0,))))
    rows = _block_rows(t_idx, k_idx, g_idx, num_layers, lanes, w_support)
    nrows = num_tasks * 2 * num_layers * (lanes + 8)
    stack = jnp.zeros((nrows, lanes), jnp.float32).at[rows].add(contrib)
    return stack.reshape(num_tasks, 2, num_layers * (lanes + 8), lanes)


def degrid_stack_xla(stack, taps: Taps, t_idx, k_idx, g_idx,
                     precision: str = "highest"):
    """Plain XLA degridding -> (re, im) [V] f32 in stream order."""
    nb = t_idx.shape[0]
    _, _, ksp, lanes = stack.shape
    num_layers = ksp // (lanes + 8)
    rows = _block_rows(t_idx, k_idx, g_idx, num_layers, lanes,
                       taps.wk.shape[0])
    win = stack.reshape(-1, lanes)[rows]                  # [nb, M, N]
    t = _dot(win, _block_v(taps, nb, lanes), precision,
             dims=(((2,), (2,)), ((0,), (0,))))           # [nb, M, B]
    prod = t * _block_u(taps, nb)
    half = (jnp.arange(WIN_M) >> 6)[None, :, None]
    re = jnp.sum(jnp.where(half == 0, prod, 0.0), axis=1)
    im = jnp.sum(jnp.where(half == 0, 0.0, prod), axis=1)
    return re.reshape(-1), im.reshape(-1)


# ---------------------------------------------------------------------------
# Entry points: kernel on the GPU, XLA formulation on the CPU
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=(
    "num_tasks", "num_layers", "lanes", "block_v", "precision",
    "interpret"))
def grid_stack(taps: Taps, t_idx, k_idx, g_idx, vre, vim, num_tasks: int,
               num_layers: int, lanes: int, block_v: int,
               precision: str = "highest", nonempty=None,
               interpret: bool = False) -> Array:
    """Grid a bucket-sorted stream into per-task tower stacks.

    ``t_idx``/``k_idx``/``g_idx``: [NB] int32 (task, w-slab, u-octet)
    of each block; blocks of one bucket are contiguous. ``vre``/``vim``:
    [V] f32 visibilities (``V = NB * block_v``). ``nonempty``: optional
    [NB] bool, False for blocks that hold no visibility (skipped by the
    kernel). Returns ``[T, 2, K*(N+8), N]`` f32.
    """
    if interpret or (precision in KERNEL_PRECISIONS
                     and use_gpu_kernels()):
        return grid_stack_triton(taps, t_idx, k_idx, g_idx, vre, vim,
                                 num_tasks, num_layers, lanes, block_v,
                                 precision, nonempty, interpret)
    return grid_stack_xla(taps, t_idx, k_idx, g_idx, vre, vim, num_tasks,
                          num_layers, lanes, precision)


@functools.partial(jax.jit, static_argnames=(
    "block_v", "precision", "interpret"))
def degrid_stack(stack, taps: Taps, t_idx, k_idx, g_idx, block_v: int,
                 precision: str = "highest", nonempty=None,
                 interpret: bool = False):
    """Degrid a bucket-sorted stream from per-task tower stacks.

    Mirror of :func:`grid_stack`; returns (re, im) [V] f32 in stream
    order (zero on slots of empty blocks).
    """
    if interpret or (precision in KERNEL_PRECISIONS
                     and use_gpu_kernels()):
        return degrid_stack_triton(stack, taps, t_idx, k_idx, g_idx,
                                   block_v, precision, nonempty, interpret)
    return degrid_stack_xla(stack, taps, t_idx, k_idx, g_idx, precision)
