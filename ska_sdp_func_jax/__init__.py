"""ska_sdp_func_jax — radio-interferometric processing functions in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the SKA SDP
Processing Function Library (ska-telescope/ska-sdp-func): visibility
gridding/degridding (w-towers/w-stacking, ES-FFT, direct DFT), FFT and
prolate-spheroidal window machinery, SwiFTly distributed facet<->subgrid
Fourier algebra, CLEAN deconvolution, visibility utilities and
station/element beams — expressed as pure JAX functions, Pallas (Triton)
GPU kernels and `shard_map` collectives instead of C++/OpenMP/CUDA.

Subpackage layout mirrors the reference Python API
(/root/reference/src/ska_sdp_func/*) so users of the reference find the same
capabilities here:

- :mod:`ska_sdp_func_jax.grid_data` — gridders and helpers
- :mod:`ska_sdp_func_jax.fourier_transforms` — FFT, PSWF, SwiFTly
- :mod:`ska_sdp_func_jax.clean` — Hogbom and multi-scale CLEAN
- :mod:`ska_sdp_func_jax.visibility` — DFT predict, phase rotation,
  flagging, weighting, uv tiling
- :mod:`ska_sdp_func_jax.station_beam` — aperture-array and element beams
- :mod:`ska_sdp_func_jax.numeric_functions` — FFT convolution
- :mod:`ska_sdp_func_jax.utility` — array contracts, sky coordinates,
  logging, timers

Additions with no reference equivalent ( the reference has no
distribution layer, see SURVEY.md §2.10):

- :mod:`ska_sdp_func_jax.parallel` — device-mesh sharding of visibilities
  and uv-grid reductions (`shard_map`, `psum`, `reduce_scatter`)
- :mod:`ska_sdp_func_jax.pipeline` — major-cycle imaging solver
  (grid -> FFT -> CLEAN -> degrid)
- :mod:`ska_sdp_func_jax.kernels` — gridding kernels for the hot paths
"""

__version__ = "0.2.0"

__all__ = [
    "clean",
    "fourier_transforms",
    "grid_data",
    "kernels",
    "numeric_functions",
    "parallel",
    "pipeline",
    "station_beam",
    "utility",
    "visibility",
]


def __getattr__(name):
    # Lazy subpackage import keeps `import ska_sdp_func_jax` light.
    if name in __all__:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
