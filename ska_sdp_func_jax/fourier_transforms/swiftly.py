"""SwiFTly: streaming widefield Fourier transform for large-scale
interferometry — the facet <-> subgrid contribution algebra for a
*distributed* FFT.

Reference: fourier_transforms/sdp_swiftly.{h,cpp}. Facet workers and
subgrid workers exchange compact contributions of size
``xM_yN = xM * yN / N`` — the wire format for distribution
(sdp_swiftly.h:104-126). Constraint: ``xA <= xM - W * N / yN``.

Forward chain (facet -> subgrid):
    prepare_facet (x Fb, iFFT) -> extract_from_facet (compact shipping
    contribution) -> add_to_subgrid[_2d] (x Fn, accumulate)
    -> finish_subgrid[_inplace][_2d] (final FFT + offsets)
Reverse chain (subgrid -> facet):
    prepare_subgrid_inplace[_2d] -> extract_from_subgrid[_2d]
    -> add_to_facet -> finish_facet

Implementation notes (vs the reference's index loops):
- All index gymnastics reduce to rolls, modular gathers and scatter-adds
  over the last axis (or last two axes for the 2d variants); leading axes
  broadcast, so whole batches of facets/subgrids process in one XLA call.
- The reference's `prepare_subgrid_inplace` applies its shifts via an
  accumulated phase ramp after the FFT (sdp_swiftly.cpp:758-776); here the
  mathematically identical roll-before-FFT form is used, which is exact
  (no phasor accumulation drift) and exactly inverts
  `finish_subgrid_inplace`.
- FFT normalisation matches PocketFFT calls: BACKWARD with 1/n == numpy
  ifft; FORWARD unscaled == numpy fft.

On a device mesh, contributions are exactly what `jax.lax.all_to_all` moves
between facet-holding and subgrid-holding devices — see
:mod:`ska_sdp_func_jax.parallel.swiftly_dist`.
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utility.errors import SdpInvalidArgumentError, SdpShapeError
from .pswf import generate_pswf

Array = jax.Array


def _c_div(a: int, b: int) -> int:
    """C-style integer division (truncation toward zero)."""
    return int(np.trunc(a / b)) if (a < 0) != (b < 0) else a // b


class Swiftly:
    """SwiFTly plan (`sdp_swiftly_create`, sdp_swiftly.h:47-53).

    :param image_size: size N of the entire (virtual) image in pixels.
    :param yN_size: internal padded facet size.
    :param xM_size: internal padded subgrid size.
    :param W: PSWF parameter.
    """

    def __init__(self, image_size: int, yN_size: int, xM_size: int,
                 W: float):
        if image_size <= 0 or xM_size <= 0 or yN_size <= 0:
            raise SdpInvalidArgumentError("sizes must be positive")
        if image_size % xM_size:
            raise SdpInvalidArgumentError(
                "image size not divisible by subgrid size")
        if image_size % yN_size:
            raise SdpInvalidArgumentError(
                "image size not divisible by facet size")
        if (xM_size * yN_size) % image_size:
            raise SdpInvalidArgumentError("contribution size not integer")
        if xM_size % 2 or yN_size % 2:
            raise SdpInvalidArgumentError(
                "subgrid and facet sizes must be even")
        self.image_size = int(image_size)
        self.yN_size = int(yN_size)
        self.xM_size = int(xM_size)
        self.W = float(W)
        self.xM_yN_size = (self.xM_size * self.yN_size) // self.image_size

        pswf = generate_pswf(0, W * (np.pi / 2), self.yN_size)
        xM_step = self.image_size // self.xM_size
        fn_offset = (self.yN_size // 2) % xM_step
        self.Fn = jnp.asarray(
            pswf[fn_offset:fn_offset + self.xM_yN_size * xM_step:xM_step])
        fb = pswf.copy()
        fb[1:] = 1.0 / fb[1:]
        self.Fb = jnp.asarray(fb)

    # -- queries (sdp_swiftly_get_*) ----------------------------------------
    def get_image_size(self) -> int:
        return self.image_size

    def get_facet_size(self) -> int:
        return self.yN_size

    def get_subgrid_size(self) -> int:
        return self.xM_size

    def get_contribution_size(self) -> int:
        return self.xM_yN_size

    # -- facet -> subgrid chain ---------------------------------------------
    def prepare_facet(self, facet: Array, facet_offset: int) -> Array:
        """Multiply by Fb and inverse-Fourier transform
        (`sdp_swiftly_prepare_facet`, sdp_swiftly.cpp:173-267).

        ``facet`` has the true facet data (size <= yN) on its LAST axis;
        leading axes broadcast. Returns the prepared facet [..., yN].
        """
        facet = jnp.asarray(facet)
        xA = facet.shape[-1]
        yN = self.yN_size
        if xA > yN:
            raise SdpShapeError(f"Facet data too large ({xA}>{yN})!")
        j = np.arange(xA)
        start = (facet_offset - xA // 2) % yN
        positions = (start + j) % yN
        fb = self.Fb[j + yN // 2 - xA // 2]
        out = jnp.zeros(facet.shape[:-1] + (yN,),
                        jnp.result_type(facet.dtype, jnp.complex64))
        out = out.at[..., positions].set(facet * fb.astype(facet.dtype))
        return jnp.fft.ifft(out, axis=-1)

    def extract_from_facet(self, prep_facet: Array,
                           subgrid_offset: int) -> Array:
        """Extract a compact subgrid contribution [..., xM_yN]
        (`sdp_swiftly_extract_from_facet`, sdp_swiftly.cpp:270-343)."""
        prep_facet = jnp.asarray(prep_facet)
        if prep_facet.shape[-1] != self.yN_size:
            raise SdpShapeError("prepared facet must have yN size")
        m = self.xM_yN_size
        yN = self.yN_size
        sg_offs = _c_div(int(subgrid_offset),
                         self.image_size // self.yN_size)
        aliased = (sg_offs - m // 2) % m
        offs = sg_offs - aliased - m // 2
        i = np.arange(m)
        src = np.where(i < aliased, (i + offs + m) % yN, (i + offs) % yN)
        return jnp.fft.fft(prep_facet[..., src], axis=-1)

    def _subgrid_indices(self, facet_offset: int, use_mod: bool):
        """Target/source index maps for add_to/extract_from subgrid."""
        m = self.xM_yN_size
        xM = self.xM_size
        step = self.image_size // xM
        if use_mod:
            fct_offs = (facet_offset % self.image_size) // step
        else:
            fct_offs = _c_div(int(facet_offset), step)
        offs = (-(m // 2) + xM // 2 + fct_offs) % xM
        i = np.arange(m)
        tgt = (i + offs) % xM
        src = (i + fct_offs + m // 2) % m
        return i, tgt, src

    def add_to_subgrid(self, contribution: Array, subgrid_image: Array,
                       facet_offset: int) -> Array:
        """Accumulate a facet contribution into a subgrid image
        (`sdp_swiftly_add_to_subgrid`, sdp_swiftly.cpp:346-396)."""
        contribution = jnp.asarray(contribution)
        subgrid_image = jnp.asarray(subgrid_image)
        i, tgt, src = self._subgrid_indices(facet_offset, use_mod=True)
        vals = self.Fn[i].astype(contribution.dtype) \
            * contribution[..., src]
        return subgrid_image.at[..., tgt].add(
            vals.astype(subgrid_image.dtype))

    def add_to_subgrid_2d(self, contribution: Array, subgrid_image: Array,
                          facet_offset0: int, facet_offset1: int) -> Array:
        """2-D accumulate over the last two axes
        (`sdp_swiftly_add_to_subgrid_2d`, sdp_swiftly.cpp:399-478).
        NB: unlike the 1-D variant, offsets are NOT wrapped modulo the
        image size (matching the reference)."""
        contribution = jnp.asarray(contribution)
        subgrid_image = jnp.asarray(subgrid_image)
        i0, tgt0, src0 = self._subgrid_indices(facet_offset0, use_mod=False)
        i1, tgt1, src1 = self._subgrid_indices(facet_offset1, use_mod=False)
        fn = (self.Fn[i0][:, None] * self.Fn[i1][None, :]).astype(
            contribution.dtype)
        vals = fn * contribution[..., src0[:, None], src1[None, :]]
        return subgrid_image.at[..., tgt0[:, None], tgt1[None, :]].add(
            vals.astype(subgrid_image.dtype))

    def finish_subgrid_inplace(self, subgrid: Array,
                               subgrid_offset: int) -> Array:
        """Final iFFT + offset application
        (`sdp_swiftly_finish_subgrid_inplace`, sdp_swiftly.cpp:481-546)."""
        subgrid = jnp.asarray(subgrid)
        xM = self.xM_size
        tmp = jnp.fft.ifft(jnp.roll(subgrid, xM // 2, axis=-1), axis=-1)
        return jnp.roll(tmp, -(int(subgrid_offset) + xM // 2), axis=-1)

    def finish_subgrid(self, subgrid_image: Array, xA_size: int,
                       subgrid_offset: int) -> Array:
        """Finish into a (possibly smaller) output of size xA
        (`sdp_swiftly_finish_subgrid`, sdp_swiftly.cpp:549-619)."""
        subgrid_image = jnp.asarray(subgrid_image)
        xM = self.xM_size
        if xA_size > xM:
            raise SdpShapeError(f"Subgrid data too large ({xA_size}>{xM})!")
        buf = jnp.fft.ifft(jnp.roll(subgrid_image, xM // 2, axis=-1),
                           axis=-1)
        i = np.arange(xA_size)
        j = (i - xA_size // 2 + int(subgrid_offset) + xM) % xM
        return buf[..., j]

    def finish_subgrid_inplace_2d(self, subgrid: Array,
                                  subgrid_offset0: int,
                                  subgrid_offset1: int) -> Array:
        """2-D finish over the last two axes
        (`sdp_swiftly_finish_subgrid_inplace_2d`,
        sdp_swiftly.cpp:622-723)."""
        subgrid = jnp.asarray(subgrid)
        xM = self.xM_size
        rolled = jnp.roll(subgrid, (xM // 2, xM // 2), axis=(-2, -1))
        tmp = jnp.fft.ifft2(rolled, axes=(-2, -1))
        return jnp.roll(tmp, (-(int(subgrid_offset0) + xM // 2),
                              -(int(subgrid_offset1) + xM // 2)),
                        axis=(-2, -1))

    # -- subgrid -> facet chain ---------------------------------------------
    def prepare_subgrid_inplace(self, subgrid: Array,
                                subgrid_offset: int) -> Array:
        """Exact inverse of :meth:`finish_subgrid_inplace`
        (`sdp_swiftly_prepare_subgrid_inplace`, sdp_swiftly.cpp:726-777;
        roll-form instead of the reference's in-place phase ramp)."""
        subgrid = jnp.asarray(subgrid)
        xM = self.xM_size
        u = jnp.roll(subgrid, int(subgrid_offset) + xM // 2, axis=-1)
        return jnp.roll(jnp.fft.fft(u, axis=-1), -(xM // 2), axis=-1)

    def prepare_subgrid_inplace_2d(self, subgrid: Array,
                                   subgrid_offset0: int,
                                   subgrid_offset1: int) -> Array:
        """Exact inverse of :meth:`finish_subgrid_inplace_2d`
        (`sdp_swiftly_prepare_subgrid_inplace_2d`,
        sdp_swiftly.cpp:780-845)."""
        subgrid = jnp.asarray(subgrid)
        xM = self.xM_size
        u = jnp.roll(subgrid, (int(subgrid_offset0) + xM // 2,
                               int(subgrid_offset1) + xM // 2),
                     axis=(-2, -1))
        return jnp.roll(jnp.fft.fft2(u, axes=(-2, -1)),
                        (-(xM // 2), -(xM // 2)), axis=(-2, -1))

    def extract_from_subgrid(self, subgrid_image: Array,
                             facet_offset: int) -> Array:
        """Extract a facet contribution from a prepared subgrid
        (`sdp_swiftly_extract_from_subgrid`, sdp_swiftly.cpp:851-914)."""
        subgrid_image = jnp.asarray(subgrid_image)
        m = self.xM_yN_size
        xM = self.xM_size
        i, tgt, src = self._subgrid_indices(facet_offset, use_mod=False)
        # contrib[src[i]] = sg[tgt[i]] * Fn[i]  -> gather via the inverse
        # permutation of src.
        inv = np.empty(m, np.int64)
        inv[src] = i
        vals = subgrid_image[..., tgt[inv]] \
            * self.Fn[inv].astype(subgrid_image.dtype)
        return jnp.fft.ifft(vals, axis=-1)

    def extract_from_subgrid_2d(self, subgrid_image: Array,
                                facet_offset0: int,
                                facet_offset1: int) -> Array:
        """2-D extract (`sdp_swiftly_extract_from_subgrid_2d`,
        sdp_swiftly.cpp:917-1010)."""
        subgrid_image = jnp.asarray(subgrid_image)
        m = self.xM_yN_size
        i0, tgt0, src0 = self._subgrid_indices(facet_offset0, use_mod=False)
        i1, tgt1, src1 = self._subgrid_indices(facet_offset1, use_mod=False)
        inv0 = np.empty(m, np.int64)
        inv0[src0] = i0
        inv1 = np.empty(m, np.int64)
        inv1[src1] = i1
        fn = (self.Fn[inv0][:, None] * self.Fn[inv1][None, :]).astype(
            subgrid_image.dtype)
        vals = fn * subgrid_image[..., tgt0[inv0][:, None],
                                  tgt1[inv1][None, :]]
        return jnp.fft.ifft2(vals, axes=(-2, -1))

    def add_to_facet(self, contribution: Array, prep_facet: Array,
                     subgrid_offset: int) -> Array:
        """Accumulate a subgrid contribution into a prepared facet
        (`sdp_swiftly_add_to_facet`, sdp_swiftly.cpp:1016-1076)."""
        contribution = jnp.asarray(contribution)
        prep_facet = jnp.asarray(prep_facet)
        m = self.xM_yN_size
        yN = self.yN_size
        sg_offs = _c_div(int(subgrid_offset),
                         self.image_size // self.yN_size)
        aliased = (sg_offs - m // 2) % m
        offs = sg_offs - aliased - m // 2
        i = np.arange(m)
        tgt = np.where(i < aliased, (i + offs + m) % yN, (i + offs) % yN)
        return prep_facet.at[..., tgt].add(
            contribution.astype(prep_facet.dtype))

    def finish_facet(self, prep_facet: Array, xA_size: int,
                     facet_offset: int) -> Array:
        """FFT and multiply by Fb to recover the facet
        (`sdp_swiftly_finish_facet`, sdp_swiftly.cpp:1079-1157)."""
        prep_facet = jnp.asarray(prep_facet)
        yN = self.yN_size
        if xA_size > yN:
            raise SdpShapeError(f"Facet data too large ({xA_size}>{yN})!")
        transformed = jnp.fft.fft(prep_facet, axis=-1)
        j = np.arange(xA_size)
        start = (facet_offset - xA_size // 2) % yN
        positions = (start + j) % yN
        fb = self.Fb[j + yN // 2 - xA_size // 2]
        return transformed[..., positions] \
            * fb.astype(transformed.dtype)
