"""Batched complex-to-complex FFTs and the multiplicative fft-shift trick.

Reference: fourier_transforms/sdp_fft.{h,cpp} plans a C2C FFT over the last
``num_dims_fft`` dimensions with implicit batching over leading dimensions
(sdp_fft.h:41-66), across cuFFT/MKL/PocketFFT backends. Here there is one
backend — the XLA FFT — so the "plan" reduces to a thin callable; it is kept
for API parity and carries the normalisation/shift helpers.

Conventions matched to the reference:

- Transforms are UNNORMALISED in both directions (PocketFFT is called with
  fct=1.0, sdp_fft.cpp:640-666; cuFFT likewise). The inverse here therefore
  uses ``norm="forward"`` so that ifft == N^d * numpy.fft.ifftn.
- ``fft_phase`` implements fftshift *multiplicatively* via a (-1)^(i+j)
  checkerboard instead of moving memory (sdp_fft.h:119-128) — the
  multiplication by exact +-1 is lossless, and for even sizes
  ``phase -> fft -> phase`` equals ``fftshift(fft(ifftshift(x)))``.
- ``sdp_fft_padded_size`` returns the next even 11-smooth size
  (sdp_fft_padded_size.h:20).
"""

from functools import partial
from typing import Sequence, Union

import jax
import jax.numpy as jnp

from ..utility.errors import SdpDataTypeError, SdpInvalidArgumentError

Array = jax.Array


def _check_complex(data) -> None:
    if not jnp.issubdtype(data.dtype, jnp.complexfloating):
        raise SdpDataTypeError(f"FFT input must be complex; got {data.dtype}")


@partial(jax.jit, static_argnames=("num_dims_fft", "forward"))
def _fft_nd(data: Array, num_dims_fft: int, forward: bool) -> Array:
    axes = tuple(range(data.ndim - num_dims_fft, data.ndim))
    if forward:
        return jnp.fft.fftn(data, axes=axes)
    # Unnormalised inverse (matches cuFFT/PocketFFT with fct=1).
    return jnp.fft.ifftn(data, axes=axes, norm="forward")


def fft_phase(data: Array) -> Array:
    """Multiply by a (-1)^(i+j+...) checkerboard over the trailing dims.

    Equivalent of `sdp_fft_phase` (sdp_fft.h:119-128) over the last two
    dimensions for 2D data (or the last dimension for 1D data). Leading
    dimensions are treated as batch.
    """
    _check_complex(data)
    ndim = min(data.ndim, 2)
    shape = data.shape[-ndim:]
    parity = jnp.zeros((), jnp.int32)
    grids = jnp.indices(shape, dtype=jnp.int32)
    for g in grids:
        parity = parity + g
    sign = jnp.where(parity % 2 == 0, 1.0, -1.0).astype(data.real.dtype)
    return data * sign


def fft_norm(data: Array) -> Array:
    """Divide by the product of the final two dimensions (sdp_fft_norm)."""
    _check_complex(data)
    num = data.shape[-1] * (data.shape[-2] if data.ndim >= 2 else 1)
    return data / jnp.asarray(num, data.real.dtype)


class Fft:
    """Planned batched C2C FFT over the last ``num_dims_fft`` dimensions.

    Mirrors `sdp_Fft` (sdp_fft.h:22-66): created with a template array, a
    transform rank and a direction; ``exec`` applies the (unnormalised)
    transform, ``exec_shift`` wraps it in the multiplicative shift and an
    optional normalisation (sdp_fft.h:99-117, impl :924-934).
    """

    def __init__(self, template: Array, num_dims_fft: int,
                 forward: bool = True):
        _check_complex(template)
        if not 1 <= num_dims_fft <= template.ndim:
            raise SdpInvalidArgumentError(
                f"num_dims_fft must be in [1, {template.ndim}]; "
                f"got {num_dims_fft}"
            )
        self.num_dims_fft = int(num_dims_fft)
        self.forward = bool(forward)
        self.shape = tuple(template.shape)
        self.dtype = template.dtype

    def exec(self, data: Array) -> Array:
        _check_complex(data)
        if tuple(data.shape) != self.shape:
            # The reference rejects plan/data mismatches
            # (sdp_fft.cpp exec checks; tests/.../test_fft.cpp:202).
            raise SdpInvalidArgumentError(
                f"data shape {tuple(data.shape)} does not match the "
                f"plan template {self.shape}")
        return _fft_nd(data, self.num_dims_fft, self.forward)

    def exec_shift(self, data: Array, norm: bool = False) -> Array:
        out = fft_phase(self.exec(fft_phase(data)))
        if norm:
            out = fft_norm(out)
        return out

    def __call__(self, data: Array) -> Array:
        return self.exec(data)


def fft_shifted(data: Array, num_dims_fft: int = 2) -> Array:
    """phase -> unnormalised FFT -> phase (even-size fftshifted transform)."""
    return fft_phase(_fft_nd(fft_phase(data), num_dims_fft, True))


def ifft_shifted(data: Array, num_dims_fft: int = 2) -> Array:
    """phase -> unnormalised iFFT -> phase.

    Note: like numpy ``ifftn`` scaled by N^d — i.e. no 1/N^d factor —
    matching the reference's backward PocketFFT/cuFFT calls.
    """
    return fft_phase(_fft_nd(fft_phase(data), num_dims_fft, False))


def ifft_shifted_norm(data: Array, num_dims_fft: int = 2) -> Array:
    """phase -> normalised (1/N^d) iFFT -> phase."""
    out = ifft_shifted(data, num_dims_fft)
    num = 1
    for extent in data.shape[-num_dims_fft:]:
        num *= extent
    return out / jnp.asarray(num, data.real.dtype)


def padded_fft_size(size: int, padding_factor: float = 1.0) -> int:
    """Next even number >= size*padding_factor whose prime factors are
    all in {2, 3, 5, 7, 11} (reference: sdp_fft_padded_size.h:20)."""
    candidate = max(2, int(size * padding_factor + 0.5))
    if candidate % 2:
        candidate += 1
    while True:
        n = candidate
        for p in (2, 3, 5, 7, 11):
            while n % p == 0:
                n //= p
        if n == 1:
            return candidate
        candidate += 2
