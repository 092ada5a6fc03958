"""Gridding-kernel construction: window -> oversampled Fourier kernel.

Reference: sdp_gridder_make_kernel / sdp_gridder_make_pswf_kernel /
sdp_gridder_make_w_pattern (grid_data/sdp_gridder_utils.cpp:385-425,
1329-1381). These run once at plan time, so they are computed host-side in
float64 numpy (vectorised — the reference's triple loop becomes one einsum)
and converted to device arrays by the plans that embed them.
"""

import numpy as np

from ..fourier_transforms.pswf import generate_pswf
from ..utility.errors import SdpInvalidArgumentError


def make_kernel(window: np.ndarray, oversampling: int) -> np.ndarray:
    """Convert an image-space window to an oversampled uv-space kernel.

    Output shape ``(oversampling + 1, support)``; row ``i`` holds the kernel
    for fractional offset du = (i - oversampling)/oversampling in [-1, 0],
    column ``s`` the tap at u = (s - support//2) - du:

        kernel[i, s] = (1/S) * sum_{s_in} window[s_in] * cos(2 pi u l),
        l = (s_in - S//2) / S

    i.e. the real part of a DFT of the window
    (sdp_gridder_utils.cpp:385-425).
    """
    window = np.asarray(window, dtype=np.float64)
    if window.ndim != 1:
        raise SdpInvalidArgumentError("window must be 1D")
    support = window.shape[0]
    half_support = support // 2
    du = np.arange(oversampling + 1, dtype=np.float64) - oversampling
    s_out = np.arange(support, dtype=np.float64) - half_support
    # u[i, s] = s_out[s] - du[i]/oversampling
    u = s_out[None, :] - du[:, None] / oversampling
    l = (np.arange(support, dtype=np.float64) - half_support) / support
    # kernel[i, s] = sum_k window[k] cos(2 pi u[i,s] l[k]) / support
    phases = 2.0 * np.pi * u[:, :, None] * l[None, None, :]
    kernel = np.cos(phases) @ window / support
    return kernel


def make_pswf_kernel(support: int, vr_size: int,
                     oversampling: int) -> np.ndarray:
    """Oversampled kernel from a PSWF window with c = support*pi/2.

    The window is sampled at ``vr_size`` points with the first sample
    replaced by 1e-15 when ``vr_size`` is even (avoids a zero at the edge;
    sdp_gridder_utils.cpp:1329-1350). Output shape
    ``(oversampling + 1, vr_size)``.
    """
    window = generate_pswf(0, support * (np.pi / 2), vr_size,
                           end_correction=True)
    return make_kernel(window, oversampling)


def kernel_tap_coeffs(support: int, vr_size: int, oversampling: int,
                      degree: int = 11) -> np.ndarray:
    """Chebyshev coefficients of each kernel tap as a function of the
    fractional offset row r/oversampling in [0, 1].

    The oversampled PSWF kernel's taps are smooth in the fractional
    offset — degree 11 fits the 16385-row table to ~1e-13 — so the hot
    paths evaluate taps with a vectorised Clenshaw recurrence instead of
    gathering table rows (the reference flags the same fetch latency as its CPU bottleneck,
    sdp_gridder_wtower_uvw.cpp:446-450).

    Returns float64 ``[degree+1, support]``.
    """
    table = make_pswf_kernel(support, vr_size, oversampling)
    x = 2.0 * (np.arange(oversampling + 1) / oversampling) - 1.0
    return np.polynomial.chebyshev.chebfit(x, table, degree)


def eval_kernel_taps(row, coeffs, oversampling: int):
    """Clenshaw evaluation of the tap polynomials (jittable).

    row: integer array [V] (the oversampled kernel row, 0..oversampling);
    coeffs: [degree+1, support] (numpy — embeds as a constant).
    Returns [V, support] taps in row's float dtype.
    """
    import jax.numpy as jnp

    x = (2.0 / oversampling) * row.astype(jnp.float32) - 1.0
    x = x[:, None]
    c = np.asarray(coeffs, np.float32)
    b1 = jnp.zeros((x.shape[0], c.shape[1]), x.dtype)
    b2 = jnp.zeros_like(b1)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k] + 2.0 * x * b1 - b2, b1
    return c[0] + x * b1 - b2


def lm_to_n(l, m, shear_u: float, shear_v: float):
    """Convert (l, m) to n direction cosines, allowing for shear.

    Works elementwise for numpy or jax inputs
    (reference: sdp_gridder_utils.h:397-412).
    """
    if shear_u == 0.0 and shear_v == 0.0:
        return (1 - l * l - m * m) ** 0.5 - 1
    hul_hvm_1 = shear_u * l + shear_v * m - 1
    hu2_hv2_1 = shear_u * shear_u + shear_v * shear_v + 1
    return (
        (hul_hvm_1 * hul_hvm_1 - hu2_hv2_1 * (l * l + m * m)) ** 0.5
        + hul_hvm_1
    ) / hu2_hv2_1


def make_w_pattern(subgrid_size: int, theta: float, shear_u: float,
                   shear_v: float, w_step: float) -> np.ndarray:
    """Generate the w-pattern: iDFT of a single visibility at (0, 0, w_step).

    ``w_pattern[il, im] = exp(+2 pi i w_step n(l, m))`` with
    ``l = (il - N/2) theta / N`` (sdp_gridder_utils.cpp:1353-1381).
    Complex128, shape ``(subgrid_size, subgrid_size)``.
    """
    half = subgrid_size // 2
    l = (np.arange(subgrid_size) - half) * theta / subgrid_size
    ll, mm = np.meshgrid(l, l, indexing="ij")
    n = lm_to_n(ll, mm, shear_u, shear_v)
    return np.exp(2j * np.pi * w_step * n)
