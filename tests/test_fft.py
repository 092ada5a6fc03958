"""Tests for the FFT layer (oracle: numpy.fft).

Replicates the reference's sweep over dtypes/batching and the
unnormalised-in-both-directions convention
(tests/fourier_transforms/test_fft.cpp; sdp_fft.cpp:640-666).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ska_sdp_func_jax.fourier_transforms import (
    Fft,
    fft_norm,
    fft_phase,
    fft_shifted,
    ifft_shifted,
    padded_fft_size,
)
from ska_sdp_func_jax.utility.errors import SdpDataTypeError


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape", [(64,), (32, 32), (4, 16, 16)])
def test_fft_forward_matches_numpy(dtype, shape):
    rng = np.random.default_rng(123)
    data = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)
    ndim = min(len(shape), 2)
    fft = Fft(jnp.asarray(data), num_dims_fft=ndim, forward=True)
    result = np.asarray(fft.exec(jnp.asarray(data)))
    axes = tuple(range(len(shape) - ndim, len(shape)))
    expected = np.fft.fftn(data, axes=axes)
    tol = 1e-12 if dtype == np.complex128 else 1e-4
    np.testing.assert_allclose(result, expected, atol=tol * np.abs(
        expected).max(), rtol=tol)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_fft_inverse_is_unnormalised(dtype):
    """Inverse must match numpy ifft * N (no 1/N factor), like PocketFFT
    with fct=1.0."""
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((16, 16))
            + 1j * rng.standard_normal((16, 16))).astype(dtype)
    fft = Fft(jnp.asarray(data), num_dims_fft=2, forward=False)
    result = np.asarray(fft.exec(jnp.asarray(data)))
    expected = np.fft.ifftn(data) * data.size
    tol = 1e-12 if dtype == np.complex128 else 1e-3
    np.testing.assert_allclose(result, expected, atol=tol * np.abs(
        expected).max(), rtol=tol)


def test_fft_roundtrip_with_norm():
    rng = np.random.default_rng(7)
    data = rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32))
    fwd = Fft(jnp.asarray(data), 2, forward=True)
    inv = Fft(jnp.asarray(data), 2, forward=False)
    back = fft_norm(inv.exec(fwd.exec(jnp.asarray(data))))
    np.testing.assert_allclose(np.asarray(back), data, atol=1e-13)


def test_fft_phase_is_checkerboard():
    data = np.ones((4, 4), np.complex128)
    out = np.asarray(fft_phase(jnp.asarray(data)))
    i, j = np.indices((4, 4))
    np.testing.assert_array_equal(out, ((-1.0) ** (i + j)).astype(complex))


def test_fft_shifted_equals_fftshift_composition():
    """For even sizes, phase-fft-phase == fftshift(fft(ifftshift(x)))."""
    rng = np.random.default_rng(11)
    data = rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32))
    result = np.asarray(fft_shifted(jnp.asarray(data)))
    expected = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(data)))
    np.testing.assert_allclose(result, expected, atol=1e-12)

    result = np.asarray(ifft_shifted(jnp.asarray(data)))
    expected = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(data)))
    expected *= data.size
    np.testing.assert_allclose(result, expected, atol=1e-12)


def test_fft_rejects_real_input():
    with pytest.raises(SdpDataTypeError):
        Fft(jnp.ones((8, 8)), 2)


def test_padded_fft_size():
    # Next even 11-smooth sizes (sdp_fft_padded_size.h:20).
    assert padded_fft_size(2, 1.0) == 2
    assert padded_fft_size(13, 1.0) == 14
    assert padded_fft_size(17, 1.0) == 18
    assert padded_fft_size(23, 1.0) == 24
    assert padded_fft_size(512, 1.25) == 640
    # 2 * 13 = 26 is not 11-smooth -> 28.
    assert padded_fft_size(25, 1.0) == 28
    for size in [100, 300, 1000]:
        padded = padded_fft_size(size, 1.5)
        assert padded >= size * 1.5
        assert padded % 2 == 0
        n = padded
        for p in (2, 3, 5, 7, 11):
            while n % p == 0:
                n //= p
        assert n == 1
