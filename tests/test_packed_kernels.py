"""Packed bucket-blocked kernels agree with an in-file NumPy oracle.

The packed gridding/degridding (kernels/packed_tap.py) comes in two
implementations: the Triton kernel, run here in the Pallas interpreter,
and the plain XLA formulation that the CPU runs. Both are validated
against a direct NumPy scatter/gather oracle (the reference's oracle
pattern, tests/grid_data/test_gridder_wtower_uvw.py), at each precision
mode's own floor.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ska_sdp_func_jax.kernels import packed_tap
from ska_sdp_func_jax.kernels.packed_tap import (
    TILE_V,
    Taps,
    degrid_stack,
    degrid_stack_xla,
    grid_stack,
    grid_stack_xla,
)

S, SW = 8, 4
LANES = 128
NUM_T = 2
NUM_K = 6
NUM_SLABS = NUM_K - SW + 1
G = LANES // 8
BLOCK = TILE_V

# Relative error floors: f32 reassociation (also the three-piece bf16
# split of "high"), single-pass bf16's ~2^-8.
TOL = {"highest": 2e-6, "high": 2e-6, "bf16": 2e-2}
# The kernels run the bf16-product precisions; "highest" is XLA's.
CASES = [("kernel", p) for p in packed_tap.KERNEL_PRECISIONS] \
    + [("xla", p) for p in TOL]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    num = 400
    task = rng.integers(0, NUM_T, num)
    iu0 = rng.integers(0, LANES - S + 1, num)
    iv0 = rng.integers(0, LANES - S + 1, num)
    k0 = rng.integers(0, NUM_SLABS, num)
    uk = rng.standard_normal((num, S)).astype(np.float32)
    vk = rng.standard_normal((num, S)).astype(np.float32)
    wk = rng.standard_normal((num, SW)).astype(np.float32)
    vis = (rng.standard_normal(num)
           + 1j * rng.standard_normal(num)).astype(np.complex64)

    # Host bucket sort by (task, slab, u-octet), padded to BLOCK
    # multiples (the packed plan's stream layout).
    bucket = ((task * NUM_SLABS + k0) * G + iu0 // 8).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    chunks = []
    for bid in range(NUM_T * NUM_SLABS * G):
        sel = order[bucket[order] == bid]
        if sel.size:
            chunks.append((bid, sel, (-sel.size) % BLOCK))
    total = sum(s.size + p for _, s, p in chunks)
    idx = np.zeros(total, np.int64)
    valid = np.zeros(total, bool)
    block_bucket = np.zeros(total // BLOCK, np.int64)
    pos = blk = 0
    for bid, sel, pad in chunks:
        idx[pos:pos + sel.size] = sel
        valid[pos:pos + sel.size] = True
        nb = (sel.size + pad) // BLOCK
        block_bucket[blk:blk + nb] = bid
        pos += sel.size + pad
        blk += nb

    def placed(x):
        return np.where(valid.reshape((-1,) + (1,) * (x.ndim - 1)),
                        x[idx], 0)

    taps = Taps(
        u_off=jnp.asarray(placed(iu0 % 8).astype(np.int32)),
        iv0=jnp.asarray(placed(iv0).astype(np.int32)),
        uk=jnp.asarray(placed(uk).T.astype(np.float32)),
        vk=jnp.asarray(placed(vk).T.astype(np.float32)),
        wk=jnp.asarray(placed(wk).T.astype(np.float32)))
    vis_s = placed(vis)
    bb = block_bucket
    return dict(
        num=num, task=task, iu0=iu0, iv0=iv0, k0=k0, uk=uk, vk=vk,
        wk=wk, vis=vis, idx=idx, valid=valid, taps=taps,
        t_idx=jnp.asarray((bb // (NUM_SLABS * G)).astype(np.int32)),
        k_idx=jnp.asarray(((bb // G) % NUM_SLABS).astype(np.int32)),
        g_idx=jnp.asarray((bb % G).astype(np.int32)),
        vre=jnp.asarray(vis_s.real.astype(np.float32)),
        vim=jnp.asarray(vis_s.imag.astype(np.float32)))


def _stack_to_layers(stack):
    st = np.asarray(stack).reshape(NUM_T, 2, NUM_K, LANES + 8, LANES)
    # The 8-row octet overhang below each layer must stay untouched
    # by anything but zero-tap rows.
    assert np.abs(st[:, :, :, LANES:]).max() == 0
    return st[:, 0, :, :LANES] + 1j * st[:, 1, :, :LANES]


def _grid(s, impl, precision):
    args = (s["taps"], s["t_idx"], s["k_idx"], s["g_idx"], s["vre"],
            s["vim"])
    if impl == "xla":
        return grid_stack_xla(*args, NUM_T, NUM_K, LANES, precision)
    return grid_stack(*args, NUM_T, NUM_K, LANES, BLOCK, precision,
                      interpret=True)


def _degrid(s, stack, impl, precision):
    args = (stack, s["taps"], s["t_idx"], s["k_idx"], s["g_idx"])
    if impl == "xla":
        return degrid_stack_xla(*args, precision)
    return degrid_stack(*args, BLOCK, precision, interpret=True)


@pytest.fixture(scope="module")
def grid_oracle(setup):
    s = setup
    oracle = np.zeros((NUM_T, NUM_K, LANES, LANES), np.complex128)
    for p in range(s["num"]):
        patch = np.outer(s["uk"][p], s["vk"][p])
        for layer in range(SW):
            oracle[s["task"][p], s["k0"][p] + layer,
                   s["iu0"][p]:s["iu0"][p] + S,
                   s["iv0"][p]:s["iv0"][p] + S] += \
                s["wk"][p, layer] * s["vis"][p] * patch
    return oracle


@pytest.mark.parametrize("impl,precision", CASES)
def test_grid_packed_matches_numpy_scatter(setup, grid_oracle, impl,
                                           precision):
    result = _stack_to_layers(_grid(setup, impl, precision))
    err = np.abs(result - grid_oracle).max() / np.abs(grid_oracle).max()
    assert err < TOL[precision]


@pytest.mark.parametrize("impl,precision", CASES)
def test_degrid_fused_matches_numpy_gather(setup, impl, precision):
    """Degridding from the tower stacks matches the NumPy gather oracle
    (the name dates from the fused-window kernel this first pinned)."""
    s = setup
    rng = np.random.default_rng(7)
    layers = (rng.standard_normal((NUM_T, NUM_K, LANES, LANES))
              + 1j * rng.standard_normal((NUM_T, NUM_K, LANES, LANES))
              ).astype(np.complex64)
    oracle = np.zeros(s["num"], np.complex128)
    for p in range(s["num"]):
        patch = np.outer(s["uk"][p], s["vk"][p])
        for layer in range(SW):
            oracle[p] += s["wk"][p, layer] * np.sum(
                patch * layers[s["task"][p], s["k0"][p] + layer,
                               s["iu0"][p]:s["iu0"][p] + S,
                               s["iv0"][p]:s["iv0"][p] + S])

    st = np.zeros((NUM_T, 2, NUM_K, LANES + 8, LANES), np.float32)
    st[:, 0, :, :LANES] = layers.real
    st[:, 1, :, :LANES] = layers.imag
    stack = jnp.asarray(st.reshape(NUM_T, 2, NUM_K * (LANES + 8), LANES))
    re, im = _degrid(s, stack, impl, precision)
    vis_out = np.asarray(re) + 1j * np.asarray(im)
    # Padding slots carry zero w-taps and must read exactly zero.
    assert np.abs(vis_out[~s["valid"]]).max(initial=0.0) == 0
    out = np.zeros(s["num"], np.complex128)
    out[s["idx"][s["valid"]]] = vis_out[s["valid"]]
    err = np.abs(out - oracle).max() / np.abs(oracle).max()
    assert err < TOL[precision]


@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_kernel_skips_empty_blocks(setup, direction):
    """Blocks flagged empty (a streaming chunk's capacity tail) join no
    bucket run: their slots neither grid nor degrid, even when their
    taps and visibilities are not zero."""
    s = setup
    nb = s["t_idx"].shape[0]
    nonempty = jnp.arange(nb) < nb // 2
    keep = np.repeat(np.asarray(nonempty), BLOCK)
    if direction == "grid":
        args = (s["taps"], s["t_idx"], s["k_idx"], s["g_idx"])
        got = grid_stack(*args, s["vre"], s["vim"], NUM_T, NUM_K, LANES,
                         BLOCK, "high", nonempty=nonempty, interpret=True)
        ref = grid_stack_xla(*args, jnp.where(keep, s["vre"], 0.0),
                             jnp.where(keep, s["vim"], 0.0), NUM_T,
                             NUM_K, LANES, "high")
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   atol=1e-5)
    else:
        stack = _grid(s, "xla", "highest")
        re, im = degrid_stack(stack, s["taps"], s["t_idx"], s["k_idx"],
                              s["g_idx"], BLOCK, "high", nonempty=nonempty,
                              interpret=True)
        ref_re, ref_im = degrid_stack_xla(stack, s["taps"], s["t_idx"],
                                          s["k_idx"], s["g_idx"], "high")
        np.testing.assert_allclose(np.asarray(re),
                                   np.where(keep, ref_re, 0.0), atol=1e-4)
        np.testing.assert_allclose(np.asarray(im),
                                   np.where(keep, ref_im, 0.0), atol=1e-4)


def test_run_lengths_mark_bucket_starts():
    t = jnp.asarray([0, 0, 0, 1, 1, 1, 1], jnp.int32)
    k = jnp.asarray([0, 0, 1, 0, 0, 0, 0], jnp.int32)
    g = jnp.asarray([3, 3, 3, 3, 3, 3, 4], jnp.int32)
    runs = packed_tap._run_lengths(t, k, g, 4, LANES)
    np.testing.assert_array_equal(np.asarray(runs), [2, 0, 1, 3, 0, 0, 1])
    nonempty = jnp.asarray([1, 1, 1, 1, 0, 0, 1], bool)
    runs = packed_tap._run_lengths(t, k, g, 4, LANES, nonempty)
    np.testing.assert_array_equal(np.asarray(runs), [2, 0, 1, 1, 0, 0, 1])


def test_kernel_geometry_limits(setup):
    """The kernels state their own limits and reject what they cannot
    express instead of returning a wrong stack."""
    s = setup
    with pytest.raises(ValueError, match="subgrid"):
        packed_tap.grid_stack_triton(
            s["taps"], s["t_idx"], s["k_idx"], s["g_idx"], s["vre"],
            s["vim"], NUM_T, NUM_K, 96, BLOCK, interpret=True)
    with pytest.raises(ValueError, match="block_v"):
        packed_tap.grid_stack_triton(
            s["taps"], s["t_idx"], s["k_idx"], s["g_idx"], s["vre"],
            s["vim"], NUM_T, NUM_K, LANES, BLOCK // 2, interpret=True)
    with pytest.raises(ValueError, match="precision"):
        packed_tap.grid_stack_triton(
            s["taps"], s["t_idx"], s["k_idx"], s["g_idx"], s["vre"],
            s["vim"], NUM_T, NUM_K, LANES, BLOCK, "highest",
            interpret=True)


@pytest.mark.parametrize("platform,precision,expected", [
    ("gpu", "high", "kernel"), ("gpu", "bf16", "kernel"),
    ("gpu", "highest", "xla"), ("cpu", "high", "xla"),
    ("rocm", "high", None)])
def test_platform_routing(setup, monkeypatch, platform, precision,
                          expected):
    """One module knows the platform: the GPU runs the compiled kernel
    (true-f32 "highest" runs XLA's formulation), the CPU the XLA
    formulation, anything else raises."""
    from ska_sdp_func_jax.utility import device
    from ska_sdp_func_jax.utility.errors import SdpRuntimeError

    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(packed_tap, "grid_stack_triton",
                        lambda *a, **k: calls.append("kernel") or 0)
    monkeypatch.setattr(packed_tap, "grid_stack_xla",
                        lambda *a, **k: calls.append("xla") or 0)
    s = setup
    call = packed_tap.grid_stack.__wrapped__
    args = (s["taps"], s["t_idx"], s["k_idx"], s["g_idx"], s["vre"],
            s["vim"], NUM_T, NUM_K, LANES, BLOCK, precision)
    if expected is None:
        with pytest.raises(SdpRuntimeError, match="unsupported"):
            device.platform()
        with pytest.raises(SdpRuntimeError):
            call(*args)
        return
    assert device.platform() == platform
    call(*args)
    assert calls == [expected]


def test_split_bf16_lo_half_survives_compilation():
    """Regression guard for the excess-precision hazard: the naive
    ``x - f32(bf16(x))`` split is folded to zero by XLA under
    --xla_allow_excess_precision (and by LLVM on CPU), silently
    degrading precision='high' to bf16-class 1e-3 error. The
    bit-level split_bf16 must keep a non-trivial lo half and
    reconstruct to ~2^-17 under jit on ANY backend."""
    from ska_sdp_func_jax.kernels.packed_tap import split_bf16

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((64, 256)).astype(np.float32))
    hi, lo = jax.jit(split_bf16)(x)
    assert hi.dtype == jnp.bfloat16 and lo.dtype == jnp.bfloat16
    lo_f = np.asarray(lo.astype(jnp.float32))
    assert np.abs(lo_f).max() > 0.0, "lo half collapsed to zero"
    rec = np.asarray(hi.astype(jnp.float32)) + lo_f
    rel = np.abs(rec - np.asarray(x)).max() / np.abs(x).max()
    assert rel < 1e-4, f"hi+lo reconstruction error {rel:.2e}"


@pytest.mark.gpu
@pytest.mark.parametrize("precision", packed_tap.KERNEL_PRECISIONS)
@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_compiled_kernel_matches_xla(gpu, setup, direction, precision):
    """The kernel as compiled for the card (no interpreter) against the
    XLA formulation at "highest" on the same card."""
    s = setup
    args = (s["taps"], s["t_idx"], s["k_idx"], s["g_idx"])
    ref = grid_stack_xla(*args, s["vre"], s["vim"], NUM_T, NUM_K, LANES,
                         "highest")
    if direction == "grid":
        got = packed_tap.grid_stack_triton(
            *args, s["vre"], s["vim"], NUM_T, NUM_K, LANES, BLOCK,
            precision)
        err = float(jnp.abs(got - ref).max() / jnp.abs(ref).max())
    else:
        want = degrid_stack_xla(ref, *args, "highest")
        got = packed_tap.degrid_stack_triton(ref, *args, BLOCK, precision)
        scale = max(float(jnp.abs(w).max()) for w in want)
        err = max(float(jnp.abs(g - w).max())
                  for g, w in zip(got, want)) / scale
    assert err < TOL[precision]


@pytest.mark.gpu
def test_gpu_routes_to_kernel(gpu):
    """On the card the platform module selects the compiled kernels."""
    from ska_sdp_func_jax.utility import device

    assert device.platform() == "gpu"
    assert device.use_gpu_kernels()
