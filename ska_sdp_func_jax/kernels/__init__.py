"""Gridding kernels for the hot paths.

The reference's CUDA scatter/gather gridding kernels
(grid_data/sdp_gridder_wtower_uvw.cu: one thread per row, atomicAdd on
the subgrid) are reformulated here as dense matrix products over
bucket-sorted visibility blocks: :mod:`.packed_tap` (the packed
whole-image path: a Triton kernel on the GPU and its plain XLA
formulation) and :mod:`.dense_tap` (banded matmuls in XLA for the
per-task and bucketed drivers).
"""

from .dense_tap import degrid_plane_dense, grid_plane_dense

__all__ = ["degrid_plane_dense", "grid_plane_dense"]
