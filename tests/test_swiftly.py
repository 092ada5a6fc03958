"""SwiFTly tests: analytic point-source facets/subgrids
(reference pattern: tests/fourier_transforms/test_swiftly.py with
helpers.make_facet_from_sources / make_subgrid_from_sources)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.fourier_transforms import Swiftly

PARAMS = dict(W=13.5625, N=1024, yB_size=416, yN_size=512, xA_size=228,
              xM_size=256)


def facet_from_sources(sources, image_size, facet_size, facet_offset):
    """Place integer-coordinate sources on a facet (coords relative to
    image centre; everything modulo image_size)."""
    facet = np.zeros(facet_size, complex)
    for intensity, x in sources:
        pos = (x - facet_offset + facet_size // 2) % image_size
        if 0 <= pos < facet_size:
            facet[pos] += intensity
    return facet


def subgrid_from_sources(sources, image_size, subgrid_size, subgrid_offset):
    """Exact DFT of the sources, sampled on the subgrid."""
    us = np.arange(subgrid_offset - subgrid_size // 2,
                   subgrid_offset + (subgrid_size + 1) // 2)
    subgrid = np.zeros(subgrid_size, complex)
    for intensity, x in sources:
        subgrid += (intensity / image_size) * np.exp(
            2j * np.pi * us * x / image_size)
    return subgrid


def facet_to_subgrid(swiftly, facet, facet_off, sg_off, xA_size):
    prepped = swiftly.prepare_facet(jnp.asarray(facet), facet_off)
    contrib = swiftly.extract_from_facet(prepped, sg_off)
    acc = swiftly.add_to_subgrid(
        contrib, jnp.zeros(swiftly.xM_size, complex), facet_off)
    return np.asarray(swiftly.finish_subgrid(acc, xA_size, sg_off))


def test_facet_to_subgrid_constant():
    """A unit source at the image centre must produce a constant val/N
    over the entire subgrid, for any facet/subgrid offsets."""
    p = PARAMS
    sw = Swiftly(p["N"], p["yN_size"], p["xM_size"], p["W"])
    Nx = p["N"] // p["yN_size"]
    Ny = p["N"] // p["xM_size"]
    for val, facet_off in itertools.product(
            [1.0, 0.1], np.arange(-5 * Ny, 5 * Ny // 2, Ny)):
        facet = np.zeros(p["yB_size"], complex)
        facet[p["yB_size"] // 2 - facet_off] = val
        for sg_off in np.arange(0, 10 * Nx, Nx):
            subgrid = facet_to_subgrid(sw, facet, int(facet_off),
                                       int(sg_off), p["xA_size"])
            np.testing.assert_array_almost_equal(
                subgrid, val / p["N"], decimal=15)


@pytest.mark.parametrize("xA_size", [PARAMS["xA_size"],
                                     PARAMS["xA_size"] - 1])
@pytest.mark.parametrize("yB_size", [PARAMS["yB_size"],
                                     PARAMS["yB_size"] - 1])
def test_facet_to_subgrid_dft_1d(xA_size, yB_size):
    p = PARAMS
    sw = Swiftly(p["N"], p["yN_size"], p["xM_size"], p["W"])
    Nx = p["N"] // p["yN_size"]
    Ny = p["N"] // p["xM_size"]
    source_sets = [
        [(1, 0)], [(2, 1)], [(1, -3)], [(-0.1, 5)],
        [(1 / 8, 20), (2 / 8, 5), (3 / 8, -4)],
        [(1 / 16, i) for i in range(-10, 10)],
    ]
    for sources, facet_off in itertools.product(
            source_sets, np.arange(-50 * Ny, 50 * Ny, 20 * Ny)):
        facet_off = int(facet_off)
        min_x = -(yB_size - 1) // 2 + facet_off
        max_x = min_x + yB_size - 1
        sources = [(i, min(max(x, min_x), max_x)) for i, x in sources]
        facet = facet_from_sources(sources, p["N"], yB_size, facet_off)
        assert np.sum(facet) == sum(s[0] for s in sources)
        for sg_off in [0, Nx, -Nx, p["N"]]:
            subgrid = facet_to_subgrid(sw, facet, facet_off, int(sg_off),
                                       xA_size)
            expected = subgrid_from_sources(sources, p["N"], xA_size,
                                            int(sg_off))
            np.testing.assert_array_almost_equal(subgrid, expected,
                                                 decimal=8)


def test_facet_to_subgrid_dft_2d():
    p = PARAMS
    sw = Swiftly(p["N"], p["yN_size"], p["xM_size"], p["W"])
    yB, xA = p["yB_size"], p["xA_size"]
    sources = [(1.0, 2, 3), (0.5, -10, 5)]
    facet_off0, facet_off1 = 0, 4
    sg_off0, sg_off1 = 4, 0

    facet = np.zeros((yB, yB), complex)
    for inten, x0, x1 in sources:
        facet[(x0 - facet_off0 + yB // 2) % p["N"],
              (x1 - facet_off1 + yB // 2) % p["N"]] += inten

    # axis 0 then axis 1 preparation/extraction (the reference's usage:
    # 1D ops broadcast along the other axis).
    prepped0 = sw.prepare_facet(jnp.asarray(facet).T, facet_off0).T
    prepped = sw.prepare_facet(prepped0, facet_off1)
    contrib0 = sw.extract_from_facet(prepped.T, sg_off0).T
    contrib = sw.extract_from_facet(contrib0, sg_off1)
    acc = sw.add_to_subgrid_2d(
        contrib, jnp.zeros((sw.xM_size, sw.xM_size), complex),
        facet_off0, facet_off1)
    full = np.asarray(
        sw.finish_subgrid_inplace_2d(acc, sg_off0, sg_off1))
    # Only the central xA usable region is valid (xA <= xM - W N / yN).
    lo = sw.xM_size // 2 - xA // 2
    subgrid = full[lo:lo + xA, lo:lo + xA]

    # DFT oracle over the usable xA region
    u0 = np.arange(sg_off0 - xA // 2, sg_off0 + (xA + 1) // 2)
    u1 = np.arange(sg_off1 - xA // 2, sg_off1 + (xA + 1) // 2)
    expected = np.zeros((xA, xA), complex)
    for inten, x0, x1 in sources:
        expected += (inten / p["N"] ** 2) * np.exp(
            2j * np.pi * (u0[:, None] * x0 + u1[None, :] * x1) / p["N"])
    np.testing.assert_array_almost_equal(subgrid, expected, decimal=8)


def test_subgrid_to_facet_dft():
    """Reverse chain: a partially-filled (xA-sized, scaled) subgrid must
    reproduce the source pixels of the facet
    (tests/fourier_transforms/test_swiftly.py:341-395 pattern)."""
    p = PARAMS
    sw = Swiftly(p["N"], p["yN_size"], p["xM_size"], p["W"])
    Nx = p["N"] // p["yN_size"]
    Ny = p["N"] // p["xM_size"]
    yB, xM, xA = p["yB_size"], p["xM_size"], p["xA_size"]
    source_lists = [[(1.0, 0)], [(2.0, 1)], [(1.0, -3)], [(-0.1, 5)]]
    for sources, sg_off in itertools.product(
            source_lists, Nx * np.arange(-9, 8, 4)):
        sg_off = int(sg_off)
        # Partially-filled grid needs scaling by N / xA.
        subgrid = subgrid_from_sources(sources, p["N"], xA, sg_off) \
            / xA * p["N"]
        lo = xM // 2 - xA // 2
        padded = np.zeros(xM, complex)
        padded[lo:lo + xA] = subgrid
        prep_sg = sw.prepare_subgrid_inplace(jnp.asarray(padded), sg_off)
        for facet_off in (Ny * np.arange(-9, 8, 4)).tolist():
            contrib = sw.extract_from_subgrid(prep_sg, int(facet_off))
            prepped = sw.add_to_facet(
                contrib, jnp.zeros(p["yN_size"], complex), sg_off)
            facet = np.asarray(sw.finish_facet(prepped, yB,
                                               int(facet_off)))
            expected = facet_from_sources(sources, p["N"], yB,
                                          int(facet_off))
            nz = expected != 0
            np.testing.assert_array_almost_equal(
                facet[nz], expected[nz], decimal=11)
            if sources[0][0] > 0:
                np.testing.assert_array_less(facet[~nz].real,
                                             np.max(expected.real))


def test_prepare_finish_subgrid_inverse():
    rng = np.random.default_rng(0)
    p = PARAMS
    sw = Swiftly(p["N"], p["yN_size"], p["xM_size"], p["W"])
    data = rng.standard_normal(p["xM_size"]) \
        + 1j * rng.standard_normal(p["xM_size"])
    for off in [0, 4, -8, 100]:
        back = np.asarray(sw.finish_subgrid_inplace(
            sw.prepare_subgrid_inplace(jnp.asarray(data), off), off))
        np.testing.assert_allclose(back, data, atol=1e-12)
    data2 = rng.standard_normal((p["xM_size"], p["xM_size"])) + 0j
    back2 = np.asarray(sw.finish_subgrid_inplace_2d(
        sw.prepare_subgrid_inplace_2d(jnp.asarray(data2), 4, -8), 4, -8))
    np.testing.assert_allclose(back2, data2, atol=1e-12)


def test_batched_broadcast():
    """1D ops broadcast over leading axes — one XLA call per facet batch."""
    p = PARAMS
    sw = Swiftly(p["N"], p["yN_size"], p["xM_size"], p["W"])
    rng = np.random.default_rng(1)
    batch = rng.standard_normal((3, p["yB_size"])) + 0j
    prepped = sw.prepare_facet(jnp.asarray(batch), 0)
    assert prepped.shape == (3, p["yN_size"])
    single = sw.prepare_facet(jnp.asarray(batch[1]), 0)
    np.testing.assert_allclose(np.asarray(prepped[1]), np.asarray(single),
                               atol=1e-14)


def test_swiftly_validation():
    from ska_sdp_func_jax.utility.errors import SdpInvalidArgumentError
    with pytest.raises(SdpInvalidArgumentError):
        Swiftly(1024, 500, 256, 13.0)   # N % yN != 0
    with pytest.raises(SdpInvalidArgumentError):
        Swiftly(1024, 512, 255, 13.0)   # odd xM
    sw = Swiftly(1024, 512, 256, 13.5625)
    assert sw.get_image_size() == 1024
    assert sw.get_facet_size() == 512
    assert sw.get_subgrid_size() == 256
    assert sw.get_contribution_size() == 128
