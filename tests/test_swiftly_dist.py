"""Distributed SwiFTly on the 8-device mesh.

The distributed chains (traced offsets + one all_to_all) must reproduce
the local static-offset chains exactly, and the analytic point-source
oracle (the reference pattern from tests/fourier_transforms/helpers.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.fourier_transforms import Swiftly
from ska_sdp_func_jax.parallel import make_mesh
from ska_sdp_func_jax.parallel.swiftly_dist import SwiftlyDistributed

PARAMS = dict(W=13.5625, N=1024, yN_size=512, xM_size=256)
D = 8
YB = 128     # facet size: D * YB == N
XA = 128     # subgrid size: D * XA == N
OFFS = [(d - D // 2) * 128 + 64 for d in range(D)]


def facet_from_sources(sources, image_size, facet_size, facet_offset):
    facet = np.zeros(facet_size, complex)
    for intensity, x in sources:
        pos = (x - facet_offset + facet_size // 2) % image_size
        if 0 <= pos < facet_size:
            facet[pos] += intensity
    return facet


def subgrid_from_sources(sources, image_size, subgrid_size, subgrid_offset):
    us = np.arange(subgrid_offset - subgrid_size // 2,
                   subgrid_offset + (subgrid_size + 1) // 2)
    subgrid = np.zeros(subgrid_size, complex)
    for intensity, x in sources:
        subgrid += (intensity / image_size) * np.exp(
            2j * np.pi * us * x / image_size)
    return subgrid


@pytest.fixture(scope="module")
def setup():
    sw = Swiftly(PARAMS["N"], PARAMS["yN_size"], PARAMS["xM_size"],
                 PARAMS["W"])
    rng = np.random.default_rng(7)
    sources = [(float(rng.standard_normal()), int(x))
               for x in rng.integers(-PARAMS["N"] // 2,
                                     PARAMS["N"] // 2 - 1, 12)]
    facets = np.stack([
        facet_from_sources(sources, PARAMS["N"], YB, off) for off in OFFS])
    dist = SwiftlyDistributed(sw, make_mesh(D))
    return dict(sw=sw, dist=dist, facets=facets, sources=sources)


def _local_facets_to_subgrids(sw, facets):
    """Reference: the local static-offset chain, all pairs."""
    out = []
    for sg_off in OFFS:
        acc = jnp.zeros((sw.xM_size,), jnp.complex128)
        for d, f_off in enumerate(OFFS):
            prep = sw.prepare_facet(jnp.asarray(facets[d]), f_off)
            contrib = sw.extract_from_facet(prep, sg_off)
            acc = sw.add_to_subgrid(contrib, acc, f_off)
        out.append(np.asarray(sw.finish_subgrid(acc, XA, sg_off)))
    return np.stack(out)


def test_facets_to_subgrids_matches_local(setup):
    s = setup
    got = np.asarray(s["dist"].facets_to_subgrids(
        jnp.asarray(s["facets"]), OFFS, OFFS, XA))
    want = _local_facets_to_subgrids(s["sw"], s["facets"])
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_facets_to_subgrids_matches_analytic(setup):
    s = setup
    got = np.asarray(s["dist"].facets_to_subgrids(
        jnp.asarray(s["facets"]), OFFS, OFFS, XA))
    for m, sg_off in enumerate(OFFS):
        want = subgrid_from_sources(s["sources"], PARAMS["N"], XA, sg_off)
        np.testing.assert_array_almost_equal(got[m], want, decimal=6)


def test_subgrids_to_facets_round_trip(setup):
    """subgrid -> facet adjoint chain: feeding the analytic subgrids
    through the reverse chain must reproduce each facet (the SwiFTly
    round-trip identity on band-limited data)."""
    s = setup
    sw = s["sw"]
    subgrids = np.stack([
        subgrid_from_sources(s["sources"], PARAMS["N"], sw.xM_size, off)
        for off in OFFS])
    got = np.asarray(s["dist"].subgrids_to_facets(
        jnp.asarray(subgrids), OFFS, OFFS, YB))
    # Local reference chain.
    for d, f_off in enumerate(OFFS):
        acc = jnp.zeros((sw.yN_size,), jnp.complex128)
        for m, sg_off in enumerate(OFFS):
            prep = sw.prepare_subgrid_inplace(jnp.asarray(subgrids[m]),
                                              sg_off)
            contrib = sw.extract_from_subgrid(prep, f_off)
            acc = sw.add_to_facet(contrib, acc, sg_off)
        want = np.asarray(sw.finish_facet(acc, YB, f_off))
        np.testing.assert_allclose(got[d], want, atol=1e-12)


def test_facets_to_subgrids_2d_matches_local(setup):
    """2-D distributed chain vs the local static-offset 2-D ops."""
    sw = setup["sw"]
    dist = setup["dist"]
    rng = np.random.default_rng(3)
    # 8 devices: facets on a (2, 4) grid of (l, m) offsets.
    offs2 = [((r - 1) * 256 + 128, (c - 2) * 256 + 128)
             for r in range(2) for c in range(4)]
    sources = [(float(rng.standard_normal()), int(x), int(y))
               for x, y in zip(rng.integers(-300, 300, 8),
                               rng.integers(-300, 300, 8))]
    facets = np.zeros((D, YB, YB), complex)
    for d, (o0, o1) in enumerate(offs2):
        for a, x, y in sources:
            p0 = (x - o0 + YB // 2) % PARAMS["N"]
            p1 = (y - o1 + YB // 2) % PARAMS["N"]
            if 0 <= p0 < YB and 0 <= p1 < YB:
                facets[d, p0, p1] += a
    got = np.asarray(dist.facets_to_subgrids_2d(
        jnp.asarray(facets), offs2, offs2, XA))
    # Local reference: all (facet, subgrid) pairs through the static ops.
    for m_i, (s0, s1) in enumerate(offs2):
        acc = jnp.zeros((sw.xM_size, sw.xM_size), jnp.complex128)
        for d, (f0, f1) in enumerate(offs2):
            prep = sw.prepare_facet(jnp.asarray(facets[d]), f1)
            prep = sw.prepare_facet(prep.swapaxes(-1, -2), f0)
            prep = prep.swapaxes(-1, -2)
            contrib = sw.extract_from_facet(prep, s1)
            contrib = sw.extract_from_facet(contrib.swapaxes(-1, -2), s0)
            contrib = contrib.swapaxes(-1, -2)
            acc = sw.add_to_subgrid_2d(contrib, acc, f0, f1)
        fin = sw.finish_subgrid_inplace_2d(acc, s0, s1)
        # window the xA region with the finish_subgrid convention
        xM = sw.xM_size
        i = np.arange(XA)
        j0 = (i - XA // 2 + s0 + xM) % xM
        j1 = (i - XA // 2 + s1 + xM) % xM
        # finish_subgrid_inplace_2d rolled by -(off + xM/2); recompute
        # via the unrolled buffer for exactness:
        buf = jnp.fft.ifft2(jnp.roll(acc, (xM // 2, xM // 2),
                                     axis=(-2, -1)), axes=(-2, -1))
        want = np.asarray(buf)[j0[:, None], j1[None, :]]
        np.testing.assert_allclose(got[m_i], want, atol=1e-12)


def test_subgrids_to_facets_2d_point_sources(setup):
    """2-D reverse chain: analytic point-source subgrids -> facets
    reproduce the source intensities at their pixels."""
    sw = setup["sw"]
    dist = setup["dist"]
    offs2 = [((r - 1) * 256 + 128, (c - 2) * 256 + 128)
             for r in range(2) for c in range(4)]
    sources = [(1.0, 40, -30), (0.5, -200, 150)]
    N = PARAMS["N"]
    xM = sw.xM_size

    def subgrid2d(off0, off1):
        u0 = np.arange(off0 - xM // 2, off0 + xM // 2)
        u1 = np.arange(off1 - xM // 2, off1 + xM // 2)
        sg = np.zeros((xM, xM), complex)
        for a, x, y in sources:
            sg += (a / N / N) * np.exp(
                2j * np.pi * (u0[:, None] * x + u1[None, :] * y) / N)
        return sg

    subgrids = np.stack([subgrid2d(o0, o1) for o0, o1 in offs2])
    got = np.asarray(dist.subgrids_to_facets_2d(
        jnp.asarray(subgrids), offs2, offs2, YB))
    for d, (o0, o1) in enumerate(offs2):
        for a, x, y in sources:
            p0 = (x - o0 + YB // 2) % N
            p1 = (y - o1 + YB // 2) % N
            if 0 <= p0 < YB and 0 <= p1 < YB:
                np.testing.assert_allclose(got[d, p0, p1], a, atol=2e-6)
