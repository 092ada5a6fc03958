#!/usr/bin/env python3
"""Run the packed imaging path end to end on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh paths only
    python chip_smoke.py --tiny    # CPU rehearsal at toy sizes

One process drives the card; every phase raises on failure and the
script then exits non-zero. Phases on one card:

1. device    — JAX must see a GPU; prints the card (``nvidia-smi``),
   the JAX version and ``XLA_FLAGS``.
2. tests     — the tests marked ``gpu`` (pytest, in this process).
3. kernels   — at the large-image plan (1024^2 image, subgrid 128,
   16384 rows x 256 channels, support 8, w_support 4, oversampling
   16384), the packed grid and degrid at each kernel precision against
   the XLA formulation at "highest"; then the packed path against the
   per-task w-towers XLA driver at 512^2 / 1M visibilities.
4. main path — a point-source sky predicted exactly by the DFT, three
   major cycles of ``major_cycle_imager(..., bucketed=True)``.
5. streaming — ``StreamingGridder`` over four chunks of the same data
   against the packed grid, then ``StreamingDegridder.predict``.

``--four`` runs only the four-card paths and what they are compared
with: the sharded major cycle, the sharded streaming gridder,
distributed SwiFTly (1-D and 2-D) and ``__graft_entry__``'s dryrun.
``--tiny`` runs the one-card phases on the CPU at toy sizes (with
``--four``: the four-card phases on four virtual CPU devices) and
prints no result line.

The last line of a run on the card is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
C_0 = 299792458.0

# The large-image configuration (reference kernel settings, SURVEY §7).
# ``cap``: streaming capacity over the chunk's visibilities (sparse
# chunks pad each bucket to a whole block).
FULL = dict(image=1024, subgrid=128, rows=16384, chans=256, cap=2.0)
ORACLE = dict(image=512, subgrid=128, rows=16384, chans=64, cap=2.0)
TINY = dict(image=256, subgrid=128, rows=256, chans=8, cap=40.0)
THETA, W_STEP, HEIGHT = 0.002, 100.0, 4.0
KERNEL = dict(support=8, oversampling=16384, w_support=4,
              w_oversampling=16384, w_tower_height=HEIGHT)

# Tolerances against the XLA formulation at "highest", relative to the
# reference's scale (taper-weighted images, peak |vis|): "high" keeps
# ~16 mantissa bits per operand, "bf16" ~8.
TOL = {"high": 1e-5, "bf16": 5e-3}
ORACLE_TOL = 2.5e-4     # the f32 path's envelope against the f64-exact
                        # per-task driver, of peak


def card() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Log:
    """Prints phase lines; every time carries the card and its limit."""

    def __init__(self, card_name: str):
        self.card = card_name

    def __call__(self, msg: str):
        print(msg, flush=True)

    def ms(self, what: str, seconds: float):
        self(f"time {what}: {1e3 * seconds:.3f} ms [{self.card}]")


def timed(fn, *args, reps: int = 5):
    """Median seconds of ``fn(*args)`` to block_until_ready (warm)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def scenario(size: dict, seed: int):
    """uvw drawn as bench.py draws it: a filled uv box over 3x3 subgrid
    boxes per side at 512^2 and several w planes."""
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-1, 1, (size["rows"], 3))
    uvw[:, :2] *= 0.45 * size["image"] / 2 / THETA
    uvw[:, 2] *= 1.5 * W_STEP * HEIGHT
    return uvw, C_0, C_0 / (100 * size["chans"])


def make_plan(size: dict, uvw, freq0, dfreq):
    from ska_sdp_func_jax.parallel import plan_wstack

    return plan_wstack(uvw, freq0, dfreq, size["chans"], size["image"],
                       size["subgrid"], THETA, W_STEP, **KERNEL)


def sky(size: dict):
    """Point sources (pixel offsets from the centre, flux)."""
    n = size["image"]
    pts = [(n // 8, -n // 10, 1.0), (-n // 6, n // 7, 0.6),
           (n // 20, n // 5, 0.4)]
    image = np.zeros((n, n))
    for dy, dx, f in pts:
        image[n // 2 + dy, n // 2 + dx] = f
    return image, [(n // 2 + dy, n // 2 + dx, f) for dy, dx, f in pts]


def predict(image, uvw, freq0, dfreq, num_chan):
    import jax.numpy as jnp

    from ska_sdp_func_jax.grid_data import dft, image_to_flmn

    flux, lmn = image_to_flmn(image, THETA, 0.0, 0.0)
    return dft(jnp.asarray(uvw), jnp.asarray(flux, jnp.complex64),
               jnp.asarray(lmn), freq0_hz=freq0, dfreq_hz=dfreq,
               num_chan=num_chan).astype(jnp.complex64)


def taper(plan):
    import jax.numpy as jnp

    n = plan.image_size
    return 1.0 / np.asarray(plan.kernel().grid_correct(
        jnp.ones((n, n), jnp.float32)))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device(tiny: bool, count: int):
    import jax

    from ska_sdp_func_jax.utility.device import platform as backend

    platform = backend()
    if platform != "gpu" and not tiny:
        raise SystemExit(f"chip_smoke: no GPU (JAX runs on {platform})")
    devices = jax.devices()
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} devices, JAX sees "
                         f"{len(devices)}")
    card_name = card() if platform == "gpu" else "cpu rehearsal"
    print(card_name, flush=True)
    print(f"jax {jax.__version__}, devices {len(devices)} x "
          f"{devices[0].device_kind}, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    return devices, card_name


def phase_tests(log: Log):
    import jax
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-rs", os.path.join(ROOT, "tests")])
    # tests/conftest.py enables x64 for the CPU oracles; the phases
    # below run the f32 production configuration.
    jax.config.update("jax_enable_x64", False)
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit {rc})")
    log("phase tests: ok")


def phase_kernels(log: Log, size: dict, seed: int, tiny: bool):
    import jax
    import jax.numpy as jnp

    from ska_sdp_func_jax.kernels.packed_tap import KERNEL_PRECISIONS
    from ska_sdp_func_jax.parallel.packed import PackedGridder, plan_packed

    uvw, freq0, dfreq = scenario(size, seed)
    plan = make_plan(size, uvw, freq0, dfreq)
    t0 = time.perf_counter()
    pplan = plan_packed(plan, uvw)
    log(f"plan: {len(pplan.tasks)} tasks, {pplan.num_layers} layers, "
        f"{pplan.total} slots ({pplan.total / uvw.shape[0] / size['chans']:.3f}"
        f" padding), {pplan.num_blocks} blocks of {pplan.block_v}, "
        f"host planning {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 1)
    vis = (rng.standard_normal((size["rows"], size["chans"]))
           + 1j * rng.standard_normal((size["rows"], size["chans"]))
           ).astype(np.complex64)
    image, _ = sky(size)
    model = jnp.asarray(image, jnp.float32)
    tap = taper(plan)

    ref = PackedGridder(pplan, precision="highest")
    vre, vim = ref.sort(jnp.asarray(vis))
    img_ref = np.asarray(ref.grid_sorted(vre, vim))
    vis_ref = np.asarray(ref.degrid_sorted(model))
    scale = float(np.abs(img_ref * tap).max())
    vscale = float(np.abs(vis_ref).max())
    if not (np.isfinite(scale) and np.isfinite(vscale) and scale > 0):
        raise RuntimeError("XLA reference produced no finite image")
    if not tiny:
        log(f"grid step memory: "
            f"{ref._grid_jit.lower(vre, vim, ref.taps, ref._grid_indices(), ref.ladder_grid, ref.pref_grid, ref.screens_grid).compile().memory_analysis()}")
        log.ms("grid end to end, xla highest",
               timed(ref.grid_sorted, vre, vim))
        log.ms("degrid end to end, xla highest",
               timed(ref.degrid_sorted, model))
    for precision in KERNEL_PRECISIONS:
        g = PackedGridder(pplan, precision=precision)
        img = np.asarray(g.grid_sorted(vre, vim))
        err = float(np.abs((img - img_ref) * tap).max()) / scale
        derr = float(np.abs(np.asarray(g.degrid_sorted(model))
                            - vis_ref).max()) / vscale
        log(f"kernel {precision}: grid {err:.3e}, degrid {derr:.3e} of "
            f"scale (limit {TOL[precision]:.0e})")
        if not (err < TOL[precision] and derr < TOL[precision]):
            raise RuntimeError(f"{precision} kernels disagree with XLA")
        if not tiny:
            log.ms(f"grid end to end, kernel {precision}",
                   timed(g.grid_sorted, vre, vim))
            log.ms(f"degrid end to end, kernel {precision}",
                   timed(g.degrid_sorted, model))
            _time_stages(log, g, vre, vim, precision)
        del g
    del ref
    jax.clear_caches()


def _time_stages(log: Log, g, vre, vim, precision: str):
    """The gridding stage alone: the Triton kernel against the XLA
    formulation at the same precision, on the gridder's own stream."""
    import jax

    from ska_sdp_func_jax.kernels import packed_tap

    pp = g.pplan
    t, k, o = g._grid_indices()
    dims = (len(pp.tasks), pp.num_layers, pp.wplan.subgrid_size)
    stack = g._stage_kernel(vre, vim, g.taps, (t, k, o))
    for name, fn in (
            ("kernel", lambda *a: packed_tap.grid_stack_triton(
                *a, *dims, pp.block_v, precision)),
            ("xla", lambda *a: packed_tap.grid_stack_xla(
                *a, *dims, precision))):
        log.ms(f"grid stage, {name} {precision}",
               timed(jax.jit(fn), g.taps, t, k, o, vre, vim))
    for name, fn in (
            ("kernel", lambda st, *a: packed_tap.degrid_stack_triton(
                st, *a, pp.block_v, precision)),
            ("xla", lambda st, *a: packed_tap.degrid_stack_xla(
                st, *a, precision))):
        log.ms(f"degrid stage, {name} {precision}",
               timed(jax.jit(fn), stack, g.taps, t, k, o))


def phase_oracle(log: Log, size: dict, seed: int):
    """Packed path vs the per-task w-towers XLA driver (f32)."""
    import jax.numpy as jnp

    from ska_sdp_func_jax.parallel.packed import packed_gridder, plan_packed
    from ska_sdp_func_jax.parallel.wstack import (
        degrid_all_tasks,
        grid_all_tasks,
    )

    log(f"oracle scenario: {size['image']}^2, {size['rows']} rows x "
        f"{size['chans']} channels (the per-task driver touches every "
        "visibility once per task, too slow at 1024^2)")
    uvw, freq0, dfreq = scenario(size, seed)
    plan = make_plan(size, uvw, freq0, dfreq)
    pplan = plan_packed(plan, uvw)
    rng = np.random.default_rng(seed + 2)
    vis = (rng.standard_normal((size["rows"], size["chans"]))
           + 1j * rng.standard_normal((size["rows"], size["chans"]))
           ).astype(np.complex64)
    image, _ = sky(size)
    tap = taper(plan)
    n = size["rows"]
    st = jnp.zeros((n,), jnp.int32)
    en = jnp.full((n,), size["chans"], jnp.int32)
    kern = plan.kernel()
    img_o = np.asarray(grid_all_tasks(plan, kern, jnp.asarray(vis),
                                      jnp.asarray(uvw, jnp.float32), st,
                                      en).real)
    vis_o = np.asarray(degrid_all_tasks(
        plan, kern, jnp.asarray(image, jnp.complex64),
        jnp.asarray(uvw, jnp.float32), st, en, jnp.complex64))
    scale = float(np.abs(img_o * tap).max())
    vscale = float(np.abs(vis_o).max())
    for precision in ("highest", "high"):
        g = packed_gridder(pplan, precision=precision)
        img = np.asarray(g.grid(jnp.asarray(vis)))
        err = float(np.abs((img - img_o) * tap).max()) / scale
        derr = float(np.abs(np.asarray(g.degrid(jnp.asarray(
            image, jnp.float32))) - vis_o).max()) / vscale
        log(f"packed {precision} vs per-task driver: grid {err:.3e}, "
            f"degrid {derr:.3e} of peak (limit {ORACLE_TOL:.1e})")
        if not (err < ORACLE_TOL and derr < ORACLE_TOL):
            raise RuntimeError("packed path outside the oracle envelope")


def phase_main_path(log: Log, size: dict, seed: int, mesh=None):
    import jax.numpy as jnp

    from ska_sdp_func_jax.pipeline import major_cycle_imager

    uvw, freq0, dfreq = scenario(size, seed)
    image, sources = sky(size)
    vis = predict(image, uvw, freq0, dfreq, size["chans"])
    plan = make_plan(size, uvw, freq0, dfreq)
    t0 = time.perf_counter()
    result = major_cycle_imager(plan, vis, jnp.asarray(uvw), n_major=3,
                                loop_gain=0.2, bucketed=True, mesh=mesh)
    model = np.asarray(result.model)
    wall = time.perf_counter() - t0
    hist = [float(h) for h in result.peak_history]
    fluxes = [float(model[y - 2:y + 3, x - 2:x + 3].sum())
              for y, x, _ in sources]
    log(f"major cycle{' (mesh)' if mesh is not None else ''}: fluxes "
        f"{[round(f, 4) for f in fluxes]} (true "
        f"{[f for _, _, f in sources]}), residual peaks "
        f"{[round(h, 5) for h in hist]}, {wall:.1f} s with compilation")
    for got, (_, _, want) in zip(fluxes, sources):
        if abs(got - want) > 0.05 * want:
            raise RuntimeError(f"flux {got} not within 5% of {want}")
    if not all(b < a for a, b in zip(hist, hist[1:])):
        raise RuntimeError(f"residual peaks do not decrease: {hist}")
    return model


def _parity(img, ref, tap, margin: int = 32):
    """(raw interior, taper-weighted) max |img - ref| over the peak."""
    m = margin
    raw = float(np.abs(img - ref)[m:-m, m:-m].max()
                / np.abs(ref[m:-m, m:-m]).max())
    return raw, float(np.abs((img - ref) * tap).max()
                      / np.abs(ref * tap).max())


def _stream(splan, uvw, vis, chunk, mesh=None):
    from ska_sdp_func_jax.parallel import StreamingGridder

    sg = StreamingGridder(splan, mesh=mesh)
    for lo in range(0, uvw.shape[0], chunk):
        sg.accumulate(uvw[lo:lo + chunk], vis[lo:lo + chunk])
    return np.asarray(sg.finalize())


def phase_streaming(log: Log, size: dict, seed: int):
    import jax.numpy as jnp

    from ska_sdp_func_jax.parallel import (
        StreamingDegridder,
        plan_stream,
        stream_tasks,
    )
    from ska_sdp_func_jax.parallel.packed import packed_gridder, plan_packed

    uvw, freq0, dfreq = scenario(size, seed)
    plan = make_plan(size, uvw, freq0, dfreq)
    rng = np.random.default_rng(seed + 3)
    vis = (rng.standard_normal((size["rows"], size["chans"]))
           + 1j * rng.standard_normal((size["rows"], size["chans"]))
           ).astype(np.complex64)
    chunk = size["rows"] // 4
    splan = plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=chunk,
                        block_v=64, cap_factor=size["cap"])
    t0 = time.perf_counter()
    img = _stream(splan, uvw, vis, chunk)
    wall = time.perf_counter() - t0
    ref = np.asarray(packed_gridder(plan_packed(plan, uvw)).grid(
        jnp.asarray(vis)))
    raw, err = _parity(img, ref, taper(plan))
    log(f"streaming: 4 chunks of {chunk} rows, interior (margin 32) "
        f"parity {raw:.3e}, taper-weighted {err:.3e} of peak (limit "
        f"2e-4), {wall:.1f} s with compilation")
    if not err < 2e-4:
        raise RuntimeError("streaming image disagrees with packed grid")
    image, _ = sky(size)
    sd = StreamingDegridder(splan).set_model(jnp.asarray(image,
                                                         jnp.float32))
    pred = np.concatenate([np.asarray(sd.predict(uvw[lo:lo + chunk]))
                           for lo in range(0, uvw.shape[0], chunk)])
    sd.check()
    ref_v = np.asarray(packed_gridder(plan_packed(plan, uvw)).degrid(
        jnp.asarray(image, jnp.float32)))
    verr = float(np.abs(pred - ref_v).max() / np.abs(ref_v).max())
    log(f"streaming predict: {verr:.3e} of peak vs packed degrid "
        "(limit 2e-4)")
    if not verr < 2e-4:
        raise RuntimeError("streaming predict disagrees with packed")


def phase_four(log: Log, size: dict, seed: int):
    """The four-device paths and what each is compared with."""
    import jax.numpy as jnp

    from ska_sdp_func_jax.parallel import make_mesh, plan_stream, \
        stream_tasks

    mesh = make_mesh(4)
    single = phase_main_path(log, size, seed)
    sharded = phase_main_path(log, size, seed, mesh=mesh)
    d = float(np.abs(sharded - single).max())
    log(f"four-card major cycle vs one card: model max |diff| {d:.3e} "
        "(limit 2e-4)")
    if not d < 2e-4:
        raise RuntimeError("sharded major cycle disagrees")

    uvw, freq0, dfreq = scenario(size, seed)
    plan = make_plan(size, uvw, freq0, dfreq)
    rng = np.random.default_rng(seed + 4)
    vis = (rng.standard_normal((size["rows"], size["chans"]))
           + 1j * rng.standard_normal((size["rows"], size["chans"]))
           ).astype(np.complex64)
    chunk = size["rows"] // 4
    splan = plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=chunk,
                        block_v=64, cap_factor=size["cap"])
    one = _stream(splan, uvw, vis, chunk)
    four = _stream(splan, uvw, vis, chunk, mesh=mesh)
    raw, err = _parity(four, one, taper(plan))
    log(f"four-card streaming vs one card: interior (margin 32) "
        f"{raw:.3e}, taper-weighted {err:.3e} of peak (limit 2e-4)")
    if not err < 2e-4:
        raise RuntimeError("sharded streaming disagrees")

    _swiftly_four(log)

    sys.path.insert(0, ROOT)
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    log("dryrun_multichip(4): ok")
    del jnp


def _swiftly_four(log: Log):
    """SwiftlyDistributed (1-D and 2-D) vs the local Swiftly chains."""
    import jax.numpy as jnp

    from ska_sdp_func_jax.fourier_transforms import Swiftly
    from ska_sdp_func_jax.parallel import make_mesh
    from ska_sdp_func_jax.parallel.swiftly_dist import SwiftlyDistributed

    n, yn, xm, d = 1024, 512, 256, 4
    yb = xa = n // d
    offs = [(i - d // 2) * yb + yb // 2 for i in range(d)]
    sw = Swiftly(n, yn, xm, 13.5625)
    dist = SwiftlyDistributed(sw, make_mesh(d))
    rng = np.random.default_rng(7)
    facets = (rng.standard_normal((d, yb))
              + 1j * rng.standard_normal((d, yb))).astype(np.complex64)
    got = np.asarray(dist.facets_to_subgrids(jnp.asarray(facets), offs,
                                             offs, xa))
    want = []
    for sg_off in offs:
        acc = jnp.zeros((xm,), jnp.complex64)
        for i, f_off in enumerate(offs):
            prep = sw.prepare_facet(jnp.asarray(facets[i]), f_off)
            acc = sw.add_to_subgrid(sw.extract_from_facet(prep, sg_off),
                                    acc, f_off)
        want.append(np.asarray(sw.finish_subgrid(acc, xa, sg_off)))
    err1 = float(np.abs(got - np.stack(want)).max()
                 / np.abs(np.stack(want)).max())

    offs2 = [((r - 1) * 2 * yb + yb, (c - 1) * 2 * yb + yb)
             for r in range(2) for c in range(2)]
    facets2 = (rng.standard_normal((d, yb, yb))
               + 1j * rng.standard_normal((d, yb, yb))).astype(
                   np.complex64)
    got2 = np.asarray(dist.facets_to_subgrids_2d(
        jnp.asarray(facets2), offs2, offs2, xa))
    want2 = []
    for s0, s1 in offs2:
        acc = jnp.zeros((xm, xm), jnp.complex64)
        for i, (f0, f1) in enumerate(offs2):
            prep = sw.prepare_facet(jnp.asarray(facets2[i]), f1)
            prep = sw.prepare_facet(prep.swapaxes(-1, -2), f0)
            contrib = sw.extract_from_facet(prep.swapaxes(-1, -2), s1)
            contrib = sw.extract_from_facet(contrib.swapaxes(-1, -2), s0)
            acc = sw.add_to_subgrid_2d(contrib.swapaxes(-1, -2), acc, f0,
                                       f1)
        buf = jnp.fft.ifft2(jnp.roll(acc, (xm // 2, xm // 2),
                                     axis=(-2, -1)), axes=(-2, -1))
        i = np.arange(xa)
        j0 = (i - xa // 2 + s0 + xm) % xm
        j1 = (i - xa // 2 + s1 + xm) % xm
        want2.append(np.asarray(buf)[j0[:, None], j1[None, :]])
    want2 = np.stack(want2)
    err2 = float(np.abs(got2 - want2).max() / np.abs(want2).max())
    log(f"distributed SwiFTly vs local: 1-D {err1:.3e}, 2-D {err2:.3e} "
        "(limit 1e-5, complex64)")
    if not (err1 < 1e-5 and err2 < 1e-5):
        raise RuntimeError("distributed SwiFTly disagrees")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal at toy sizes; prints no result")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    count = 4 if args.four else 1
    if args.tiny:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    from ska_sdp_func_jax.utility.device import use_compile_cache

    use_compile_cache(os.path.join(ROOT, ".jax_cache"))
    devices, card_name = phase_device(args.tiny, count)
    log = Log(card_name)
    size = TINY if args.tiny else FULL
    if args.four:
        phase_four(log, TINY if args.tiny else ORACLE, args.seed)
    else:
        phase_tests(log)
        phase_kernels(log, size, args.seed, args.tiny)
        phase_oracle(log, TINY if args.tiny else ORACLE, args.seed)
        phase_main_path(log, size, args.seed)
        phase_streaming(log, size, args.seed)
    if args.tiny:
        log("rehearsal: every phase passed")
        return
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
