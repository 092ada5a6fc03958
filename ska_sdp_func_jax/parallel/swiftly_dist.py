"""Distributed SwiFTly: facet <-> subgrid exchange over a device mesh.

The reference documents the SwiFTly contribution array as "optimised for
representing this data in a compact way, and should be used for
distribution" but ships no transport (sdp_swiftly.h:104-126; SURVEY.md
§2.10.5). Here the transport is built in: facet workers and subgrid
workers are co-located on the devices of a 1-D mesh, and the
``xM * yN / N``-sized contributions move with ONE `jax.lax.all_to_all`
per direction — the blockwise-exchange (ring-attention-style)
alternative to materialising the full image anywhere.

The local :class:`~ska_sdp_func_jax.fourier_transforms.Swiftly` ops bake
facet/subgrid offsets into static index maps; under `shard_map` every
device runs the SAME traced program with a DIFFERENT offset, so this
module re-derives each op with traced offsets (gathers/scatters with
traced index arrays, `jax.lax.div` for the C-style divisions). The
static-offset class remains the reference implementation the distributed
ops are tested against.
"""

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..fourier_transforms.swiftly import Swiftly
from .mesh import ROW_AXIS

Array = jax.Array


def _c_div_t(a, b: int):
    """C-style (truncate toward zero) integer division, traced."""
    return jax.lax.div(a, jnp.asarray(b, a.dtype))


# ---------------------------------------------------------------------------
# Traced-offset op variants (mirror Swiftly methods; see swiftly.py for
# the reference file:line anchors)
# ---------------------------------------------------------------------------

def _prepare_facet_dyn(sw: Swiftly, facet: Array, facet_offset) -> Array:
    yN = sw.yN_size
    xA = facet.shape[-1]
    j = jnp.arange(xA)
    positions = (facet_offset - xA // 2 + j) % yN
    fb = jnp.asarray(sw.Fb)[j + yN // 2 - xA // 2]
    out = jnp.zeros(facet.shape[:-1] + (yN,),
                    jnp.result_type(facet.dtype, jnp.complex64))
    out = out.at[..., positions].set(facet * fb.astype(facet.dtype))
    return jnp.fft.ifft(out, axis=-1)


def _extract_from_facet_dyn(sw: Swiftly, prep: Array,
                            subgrid_offset) -> Array:
    m = sw.xM_yN_size
    yN = sw.yN_size
    sg_offs = _c_div_t(subgrid_offset, sw.image_size // yN)
    aliased = (sg_offs - m // 2) % m
    offs = sg_offs - aliased - m // 2
    i = jnp.arange(m)
    src = jnp.where(i < aliased, (i + offs + m) % yN, (i + offs) % yN)
    return jnp.fft.fft(prep[..., src], axis=-1)


def _subgrid_indices_dyn(sw: Swiftly, facet_offset, use_mod: bool):
    m = sw.xM_yN_size
    xM = sw.xM_size
    step = sw.image_size // xM
    if use_mod:
        fct_offs = (facet_offset % sw.image_size) // step
    else:
        fct_offs = _c_div_t(facet_offset, step)
    offs = (-(m // 2) + xM // 2 + fct_offs) % xM
    i = jnp.arange(m)
    tgt = (i + offs) % xM
    src = (i + fct_offs + m // 2) % m
    return i, tgt, src


def _add_to_subgrid_dyn(sw: Swiftly, contribution: Array,
                        subgrid_image: Array, facet_offset) -> Array:
    i, tgt, src = _subgrid_indices_dyn(sw, facet_offset, use_mod=True)
    vals = jnp.asarray(sw.Fn).astype(contribution.dtype) \
        * contribution[..., src]
    return subgrid_image.at[..., tgt].add(vals.astype(subgrid_image.dtype))


def _finish_subgrid_dyn(sw: Swiftly, subgrid_image: Array, xA_size: int,
                        subgrid_offset) -> Array:
    xM = sw.xM_size
    buf = jnp.fft.ifft(jnp.roll(subgrid_image, xM // 2, axis=-1), axis=-1)
    i = jnp.arange(xA_size)
    j = (i - xA_size // 2 + subgrid_offset + xM) % xM
    return buf[..., j]


def _prepare_subgrid_dyn(sw: Swiftly, subgrid: Array,
                         subgrid_offset) -> Array:
    xM = sw.xM_size
    u = jnp.roll(subgrid, subgrid_offset + xM // 2, axis=-1)
    return jnp.roll(jnp.fft.fft(u, axis=-1), -(xM // 2), axis=-1)


def _extract_from_subgrid_dyn(sw: Swiftly, subgrid_image: Array,
                              facet_offset) -> Array:
    i, tgt, src = _subgrid_indices_dyn(sw, facet_offset, use_mod=False)
    inv = jnp.argsort(src)          # src is a permutation of [0, m)
    vals = subgrid_image[..., tgt[inv]] \
        * jnp.asarray(sw.Fn)[inv].astype(subgrid_image.dtype)
    return jnp.fft.ifft(vals, axis=-1)


def _add_to_facet_dyn(sw: Swiftly, contribution: Array, prep_facet: Array,
                      subgrid_offset) -> Array:
    m = sw.xM_yN_size
    yN = sw.yN_size
    sg_offs = _c_div_t(subgrid_offset, sw.image_size // yN)
    aliased = (sg_offs - m // 2) % m
    offs = sg_offs - aliased - m // 2
    i = jnp.arange(m)
    tgt = jnp.where(i < aliased, (i + offs + m) % yN, (i + offs) % yN)
    return prep_facet.at[..., tgt].add(
        contribution.astype(prep_facet.dtype))


def _finish_facet_dyn(sw: Swiftly, prep_facet: Array, xA_size: int,
                      facet_offset) -> Array:
    yN = sw.yN_size
    transformed = jnp.fft.fft(prep_facet, axis=-1)
    j = jnp.arange(xA_size)
    positions = (facet_offset - xA_size // 2 + j) % yN
    fb = jnp.asarray(sw.Fb)[j + yN // 2 - xA_size // 2]
    return transformed[..., positions] * fb.astype(transformed.dtype)


# -- traced 2-D variants (compose the 1-D ops over both trailing axes) --

def _apply2(fn, x: Array, off0, off1, *args):
    """Apply a last-axis op along both trailing axes."""
    out = fn(x, off1, *args)
    out = fn(out.swapaxes(-1, -2), off0, *args)
    return out.swapaxes(-1, -2)


def _prepare_facet_2d_dyn(sw, facet, off0, off1):
    return _apply2(lambda x, o: _prepare_facet_dyn(sw, x, o),
                   facet, off0, off1)


def _extract_from_facet_2d_dyn(sw, prep, soff0, soff1):
    return _apply2(lambda x, o: _extract_from_facet_dyn(sw, x, o),
                   prep, soff0, soff1)


def _add_to_subgrid_2d_dyn(sw: Swiftly, contribution: Array,
                           subgrid_image: Array, foff0, foff1) -> Array:
    # NB: the 2-D variant does NOT wrap offsets modulo the image size
    # (matching the reference, sdp_swiftly.cpp:399-478).
    i0, tgt0, src0 = _subgrid_indices_dyn(sw, foff0, use_mod=False)
    i1, tgt1, src1 = _subgrid_indices_dyn(sw, foff1, use_mod=False)
    fn = jnp.asarray(sw.Fn)
    vals = (fn[i0][:, None] * fn[i1][None, :]).astype(contribution.dtype) \
        * contribution[..., src0[:, None], src1[None, :]]
    return subgrid_image.at[..., tgt0[:, None], tgt1[None, :]].add(
        vals.astype(subgrid_image.dtype))


def _finish_subgrid_2d_dyn(sw: Swiftly, subgrid: Array, soff0,
                           soff1) -> Array:
    xM = sw.xM_size
    rolled = jnp.roll(subgrid, (xM // 2, xM // 2), axis=(-2, -1))
    tmp = jnp.fft.ifft2(rolled, axes=(-2, -1))
    return jnp.roll(tmp, (-(soff0 + xM // 2), -(soff1 + xM // 2)),
                    axis=(-2, -1))


def _prepare_subgrid_2d_dyn(sw: Swiftly, subgrid: Array, soff0,
                            soff1) -> Array:
    xM = sw.xM_size
    u = jnp.roll(subgrid, (soff0 + xM // 2, soff1 + xM // 2),
                 axis=(-2, -1))
    return jnp.roll(jnp.fft.fft2(u, axes=(-2, -1)),
                    (-(xM // 2), -(xM // 2)), axis=(-2, -1))


def _extract_from_subgrid_2d_dyn(sw: Swiftly, subgrid_image: Array,
                                 foff0, foff1) -> Array:
    i0, tgt0, src0 = _subgrid_indices_dyn(sw, foff0, use_mod=False)
    i1, tgt1, src1 = _subgrid_indices_dyn(sw, foff1, use_mod=False)
    inv0 = jnp.argsort(src0)
    inv1 = jnp.argsort(src1)
    fn = jnp.asarray(sw.Fn)
    fnw = (fn[inv0][:, None] * fn[inv1][None, :]).astype(
        subgrid_image.dtype)
    vals = fnw * subgrid_image[..., tgt0[inv0][:, None],
                               tgt1[inv1][None, :]]
    return jnp.fft.ifft2(vals, axes=(-2, -1))


def _add_to_facet_2d_dyn(sw, contribution, prep_facet, soff0, soff1):
    out = _add_to_facet_axis(sw, contribution, soff1)
    out = _add_to_facet_axis(sw, out.swapaxes(-1, -2), soff0)
    return prep_facet + out.swapaxes(-1, -2).astype(prep_facet.dtype)


def _add_to_facet_axis(sw: Swiftly, contribution: Array, soff) -> Array:
    """Spread a contribution's last axis into yN positions (the gather
    dual of _add_to_facet_dyn's scatter, as a dense placement)."""
    m = sw.xM_yN_size
    yN = sw.yN_size
    sg_offs = _c_div_t(soff, sw.image_size // yN)
    aliased = (sg_offs - m // 2) % m
    offs = sg_offs - aliased - m // 2
    i = jnp.arange(m)
    tgt = jnp.where(i < aliased, (i + offs + m) % yN, (i + offs) % yN)
    out = jnp.zeros(contribution.shape[:-1] + (yN,), contribution.dtype)
    return out.at[..., tgt].set(contribution)


def _finish_facet_2d_dyn(sw, prep_facet, xA0: int, xA1: int, foff0,
                         foff1):
    out = _finish_facet_dyn(sw, prep_facet, xA1, foff1)
    out = _finish_facet_dyn(sw, out.swapaxes(-1, -2), xA0, foff0)
    return out.swapaxes(-1, -2)


# ---------------------------------------------------------------------------
# Mesh drivers: one all_to_all per direction
# ---------------------------------------------------------------------------

class SwiftlyDistributed:
    """1-D SwiFTly over a device mesh: device d holds facet d and is
    responsible for subgrid d; contributions are exchanged with a single
    `all_to_all` over the mesh axis."""

    def __init__(self, swiftly: Swiftly, mesh: Mesh,
                 axis_name: str = ROW_AXIS):
        self.sw = swiftly
        self.mesh = mesh
        self.axis_name = axis_name
        self.num = int(mesh.devices.size)

    def facets_to_subgrids(self, facets: Array,
                           facet_offsets: Sequence[int],
                           subgrid_offsets: Sequence[int],
                           xA_size: int) -> Array:
        """[D, yB] facets (sharded) -> [D, xA] subgrids (sharded)."""
        sw, axis = self.sw, self.axis_name
        f_offs = jnp.asarray(facet_offsets, jnp.int32)
        s_offs = jnp.asarray(subgrid_offsets, jnp.int32)

        def body(facet, my_f_off, my_s_off):
            prep = _prepare_facet_dyn(sw, facet[0], my_f_off[0])
            # Contribution for every subgrid worker: [D, xM_yN].
            contribs = jax.vmap(
                lambda so: _extract_from_facet_dyn(sw, prep, so))(s_offs)
            # The exchange: row d goes to device d; we receive one row
            # from every facet worker.
            received = jax.lax.all_to_all(contribs, axis, 0, 0, tiled=True)

            acc0 = jnp.zeros((sw.xM_size,), prep.dtype)

            def step(acc, inp):
                contrib, f_off = inp
                return _add_to_subgrid_dyn(sw, contrib, acc, f_off), None

            acc, _ = jax.lax.scan(step, acc0, (received, f_offs))
            return _finish_subgrid_dyn(sw, acc, xA_size,
                                       my_s_off[0])[None, :]

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=P(axis), check_vma=False))(
                facets, f_offs, s_offs)

    def subgrids_to_facets(self, subgrids: Array,
                           subgrid_offsets: Sequence[int],
                           facet_offsets: Sequence[int],
                           yB_size: int) -> Array:
        """[D, xM] subgrids (sharded) -> [D, yB] facets (sharded)."""
        sw, axis = self.sw, self.axis_name
        f_offs = jnp.asarray(facet_offsets, jnp.int32)
        s_offs = jnp.asarray(subgrid_offsets, jnp.int32)

        def body(subgrid, my_s_off, my_f_off):
            prep = _prepare_subgrid_dyn(sw, subgrid[0], my_s_off[0])
            contribs = jax.vmap(
                lambda fo: _extract_from_subgrid_dyn(sw, prep, fo))(f_offs)
            received = jax.lax.all_to_all(contribs, axis, 0, 0, tiled=True)

            acc0 = jnp.zeros((sw.yN_size,), prep.dtype)

            def step(acc, inp):
                contrib, s_off = inp
                return _add_to_facet_dyn(sw, contrib, acc, s_off), None

            acc, _ = jax.lax.scan(step, acc0, (received, s_offs))
            return _finish_facet_dyn(sw, acc, yB_size,
                                     my_f_off[0])[None, :]

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=P(axis), check_vma=False))(
                subgrids, s_offs, f_offs)

    # -- 2-D chains (facet/subgrid offsets are (l, m) pairs) ------------

    def facets_to_subgrids_2d(self, facets: Array, facet_offsets,
                              subgrid_offsets, xA_size: int) -> Array:
        """[D, yB, yB] facets (sharded) -> [D, xA, xA] subgrids."""
        sw, axis = self.sw, self.axis_name
        f_offs = jnp.asarray(facet_offsets, jnp.int32)   # [D, 2]
        s_offs = jnp.asarray(subgrid_offsets, jnp.int32)

        def body(facet, my_f_off, my_s_off):
            prep = _prepare_facet_2d_dyn(sw, facet[0], my_f_off[0, 0],
                                         my_f_off[0, 1])
            contribs = jax.vmap(
                lambda so: _extract_from_facet_2d_dyn(
                    sw, prep, so[0], so[1]))(s_offs)     # [D, m, m]
            received = jax.lax.all_to_all(contribs, axis, 0, 0, tiled=True)

            acc0 = jnp.zeros((sw.xM_size, sw.xM_size), prep.dtype)

            def step(acc, inp):
                contrib, f_off = inp
                return _add_to_subgrid_2d_dyn(sw, contrib, acc, f_off[0],
                                              f_off[1]), None

            acc, _ = jax.lax.scan(step, acc0, (received, f_offs))
            # finish_subgrid convention per axis (swiftly.py
            # finish_subgrid): iFFT of the half-rolled grid, then the
            # offset xA window.
            xM = sw.xM_size
            buf = jnp.fft.ifft2(
                jnp.roll(acc, (xM // 2, xM // 2), axis=(-2, -1)),
                axes=(-2, -1))
            i = jnp.arange(xA_size)
            j0 = (i - xA_size // 2 + my_s_off[0, 0] + xM) % xM
            j1 = (i - xA_size // 2 + my_s_off[0, 1] + xM) % xM
            return buf[j0[:, None], j1[None, :]][None]

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=P(axis), check_vma=False))(facets, f_offs, s_offs)

    def subgrids_to_facets_2d(self, subgrids: Array, subgrid_offsets,
                              facet_offsets, yB_size: int) -> Array:
        """[D, xM, xM] subgrids (sharded) -> [D, yB, yB] facets."""
        sw, axis = self.sw, self.axis_name
        f_offs = jnp.asarray(facet_offsets, jnp.int32)
        s_offs = jnp.asarray(subgrid_offsets, jnp.int32)

        def body(subgrid, my_s_off, my_f_off):
            prep = _prepare_subgrid_2d_dyn(sw, subgrid[0], my_s_off[0, 0],
                                           my_s_off[0, 1])
            contribs = jax.vmap(
                lambda fo: _extract_from_subgrid_2d_dyn(
                    sw, prep, fo[0], fo[1]))(f_offs)
            received = jax.lax.all_to_all(contribs, axis, 0, 0, tiled=True)

            acc0 = jnp.zeros((sw.yN_size, sw.yN_size), prep.dtype)

            def step(acc, inp):
                contrib, s_off = inp
                return _add_to_facet_2d_dyn(sw, contrib, acc, s_off[0],
                                            s_off[1]), None

            acc, _ = jax.lax.scan(step, acc0, (received, s_offs))
            return _finish_facet_2d_dyn(sw, acc, yB_size, yB_size,
                                        my_f_off[0, 0],
                                        my_f_off[0, 1])[None]

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=P(axis), check_vma=False))(subgrids, s_offs, f_offs)
