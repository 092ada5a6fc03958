"""Grid correction: divide facets by the image-space kernel response.

Reference: grid_data/sdp_gridder_grid_correct.{h,cpp,cu}:
- `sdp_gridder_grid_correct_pswf` divides the facet by the separable PSWF
  image response pswf_l(pl) * pswf_m(pm) and by the w-kernel response
  pswf_n(|2 n w_step|) (grid_corr_pswf, sdp_gridder_grid_correct.cpp:19-74).
- `sdp_gridder_grid_correct_w_stack` multiplies (gridding) or divides
  (degridding) by the exact w-screen exp(2 pi i w_step n w_offset)
  (grid_corr_w_stack, :77-115).

The PSWF responses depend only on static plan parameters, so they are
precomputed host-side (float64, scipy-backed PSWF) and cached; the actual
application is a fused elementwise multiply on device.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..fourier_transforms.pswf import generate_pswf, pswf_evaluate_host
from .kernels import lm_to_n


@lru_cache(maxsize=32)
def _pswf_correction_host(image_size: int, theta: float, w_step: float,
                          shear_u: float, shear_v: float, support: int,
                          w_support: int, num_l: int, num_m: int,
                          facet_offset_l: int, facet_offset_m: int
                          ) -> np.ndarray:
    """1 / (pswf_l * pswf_m * pswf_n) over the facet, float64."""
    pswf_lm = generate_pswf(0, support * (np.pi / 2), image_size,
                            end_correction=True)
    pl = np.arange(num_l) - num_l // 2 + facet_offset_l
    pm = np.arange(num_m) - num_m // 2 + facet_offset_m
    pswf_l = pswf_lm[pl + image_size // 2]
    pswf_m = pswf_lm[pm + image_size // 2]
    if w_support > 0:
        l = pl * theta / image_size
        m = pm * theta / image_size
        ll, mm = np.meshgrid(l, m, indexing="ij")
        n = lm_to_n(ll, mm, shear_u, shear_v)
        n_x = np.abs(n * 2.0 * w_step)
        pswf_n = np.where(n_x < 1.0,
                          pswf_evaluate_host(0, w_support * (np.pi / 2),
                                             np.minimum(n_x, 1.0 - 1e-15)),
                          1.0)
    else:
        # No w-kernel (direct gridder): skip the pswf_n term — the
        # reference's pswf_n_c > 0 guard (sdp_gridder_grid_correct.cpp:61).
        pswf_n = 1.0
    return 1.0 / (pswf_l[:, None] * pswf_m[None, :] * pswf_n)


def grid_correct_pswf(image_size: int, theta: float, w_step: float,
                      shear_u: float, shear_v: float, support: int,
                      w_support: int, facet, facet_offset_l: int = 0,
                      facet_offset_m: int = 0):
    """Divide the facet by the PSWF image responses (pure; returns new array).

    Equivalent of `sdp_gridder_grid_correct_pswf`
    (sdp_gridder_grid_correct.h:17-44).
    """
    facet = jnp.asarray(facet)
    num_l, num_m = facet.shape
    scale = _pswf_correction_host(
        int(image_size), float(theta), float(w_step), float(shear_u),
        float(shear_v), int(support), int(w_support), int(num_l), int(num_m),
        int(facet_offset_l), int(facet_offset_m))
    real_dtype = jnp.finfo(
        facet.dtype if jnp.issubdtype(facet.dtype, jnp.floating)
        else jnp.result_type(facet.dtype, jnp.float32)).dtype
    return facet * jnp.asarray(scale, real_dtype)


def w_screen_stack(image_size: int, theta: float, w_step: float,
                   shear_u: float, shear_v: float, w_offsets,
                   facet_offset_l: int = 0, facet_offset_m: int = 0,
                   num_l: int = None, num_m: int = None,
                   dtype=None):
    """Stacked w-stacking screens ``exp(+i 2 pi w_step w_offset n)``.

    The single source of the w-screen construction
    (grid_corr_w_stack, sdp_gridder_grid_correct.cpp:77-115), batched
    over a vector of plane offsets ``[P] -> [P, num_l, num_m]`` so the
    per-plane corrections of the whole-image drivers ride one
    image-sized elementwise pass (see
    :func:`ska_sdp_func_jax.parallel.packed._plane_screens`).
    """
    num_l = image_size if num_l is None else num_l
    num_m = image_size if num_m is None else num_m
    pl = jnp.arange(num_l) - num_l // 2 + facet_offset_l
    pm = jnp.arange(num_m) - num_m // 2 + facet_offset_m
    l = pl * (theta / image_size)
    m = pm * (theta / image_size)
    ll, mm = jnp.meshgrid(l, m, indexing="ij")
    n = lm_to_n(ll, mm, shear_u, shear_v)
    ang = (2.0 * jnp.pi * w_step) * n
    offs = jnp.asarray(w_offsets, ang.dtype)
    ang = ang[None] * offs[:, None, None]
    screens = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    return screens if dtype is None else screens.astype(dtype)


def grid_correct_w_stack(image_size: int, theta: float, w_step: float,
                         shear_u: float, shear_v: float, facet,
                         facet_offset_l: int = 0, facet_offset_m: int = 0,
                         w_offset: int = 0, inverse: bool = False):
    """Apply the w-stacking screen exp(2 pi i w_step n w_offset).

    Divides when ``inverse`` is False (gridding correction), multiplies when
    True (degridding), matching grid_corr_w_stack
    (sdp_gridder_grid_correct.cpp:77-115). No-op when ``w_offset`` is 0.
    """
    if w_offset == 0:
        return jnp.asarray(facet)
    facet = jnp.asarray(facet)
    num_l, num_m = facet.shape
    screen = w_screen_stack(image_size, theta, w_step, shear_u, shear_v,
                            jnp.asarray([w_offset]), facet_offset_l,
                            facet_offset_m, num_l, num_m,
                            dtype=facet.dtype)[0]
    if not inverse:
        return facet / screen
    return facet * screen
