"""SwiFTly primitive latency harness.

Mirrors the reference's pytest-benchmark suite
(tests/fourier_transforms/test_swiftly_bench.py:17-55 — N=16384/20480,
xM=1024, per-op timings, no stored baselines): times each facet->subgrid
primitive at the reference's 16k configuration, prints the per-op
latencies, and asserts only that the chain is finite (the reference
stores no numbers either). Marked slow; run explicitly with
``pytest -m slow tests/test_swiftly_bench.py -s``.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ska_sdp_func_jax.fourier_transforms import Swiftly


@pytest.mark.slow
def test_swiftly_primitive_latencies_16k():
    # Reference config "16k[1]-n4k-1k" (W=13.5625, N=16384, yN=4096,
    # xM=1024, xA=896).
    N, yN, xM, W = 16384, 4096, 1024, 13.5625
    xA, yB = 896, 3328
    sw = Swiftly(N, yN, xM, W)

    rng = np.random.default_rng(0)
    facet = jnp.asarray(rng.standard_normal(yB)
                        + 1j * rng.standard_normal(yB))

    def timed(name, fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 5
        print(f"{name}: {dt * 1e3:.2f} ms")
        return out

    prep = timed("prepare_facet", sw.prepare_facet, facet, 0)
    contrib = timed("extract_from_facet", sw.extract_from_facet, prep, 0)
    acc = jnp.zeros((xM,), jnp.complex128)
    acc = timed("add_to_subgrid", sw.add_to_subgrid, contrib, acc, 0)
    subgrid = timed("finish_subgrid", sw.finish_subgrid, acc, xA, 0)
    assert bool(jnp.all(jnp.isfinite(subgrid)))

    # Reverse chain.
    sg = jnp.asarray(rng.standard_normal(xM)
                     + 1j * rng.standard_normal(xM))
    prep_sg = timed("prepare_subgrid_inplace", sw.prepare_subgrid_inplace,
                    sg, 0)
    fac_contrib = timed("extract_from_subgrid", sw.extract_from_subgrid,
                        prep_sg, 0)
    pf = jnp.zeros((yN,), jnp.complex128)
    pf = timed("add_to_facet", sw.add_to_facet, fac_contrib, pf, 0)
    back = timed("finish_facet", sw.finish_facet, pf, yB, 0)
    assert bool(jnp.all(jnp.isfinite(back)))
