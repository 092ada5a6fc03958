"""Multi-chip distribution layer (no reference equivalent).

The reference library has **no** distributed runtime — its parallelism is
OpenMP task self-scheduling over (sub-grid x row-chunk) tasks plus CUDA
SIMT (SURVEY.md §2.10; grid_data/sdp_grid_wstack_wtower.cpp:140-165,
388-440). Host frameworks were expected to shard visibility rows across
processes through the ``start_row``/``end_row`` and per-row channel-range
arguments.

Here the distribution layer is built in:

- :mod:`.mesh` — `jax.sharding.Mesh` construction and row-shard padding.
- :mod:`.wstack` — the w-stacking imaging operators over a device mesh:
  visibility rows are sharded across devices with `shard_map`, each
  device grids its shard through the static sub-grid task list, and
  partial uv-grids / images are reduced with `psum` (the equivalent
  of the reference's ``omp critical`` sub-grid add-back).
"""

from .bucketed import (
    BucketedPlan,
    degrid_all_bucketed,
    grid_all_bucketed,
    grid_all_bucketed_sharded,
    inverse_index_of,
    plan_bucketed,
)
from .mesh import make_mesh, pad_rows, row_sharding
from .packed import (
    PackedGridder,
    PackedPlan,
    degrid_all_packed,
    degrid_all_packed_sharded,
    grid_all_packed,
    grid_all_packed_sharded,
    packed_gridder,
    plan_packed,
)
from .streaming import (
    StreamingDegridder,
    StreamingGridder,
    StreamPlan,
    plan_stream,
    stream_tasks,
)
from .swiftly_dist import SwiftlyDistributed
from .wstack import (
    WStackPlan,
    WStackTask,
    plan_wstack,
    wstack_degrid_all_sharded,
    wstack_grid_all_sharded,
)

__all__ = [
    "BucketedPlan",
    "PackedGridder",
    "PackedPlan",
    "StreamPlan",
    "StreamingDegridder",
    "StreamingGridder",
    "SwiftlyDistributed",
    "WStackPlan",
    "WStackTask",
    "degrid_all_bucketed",
    "degrid_all_packed",
    "degrid_all_packed_sharded",
    "grid_all_bucketed",
    "grid_all_bucketed_sharded",
    "grid_all_packed",
    "grid_all_packed_sharded",
    "inverse_index_of",
    "make_mesh",
    "packed_gridder",
    "pad_rows",
    "plan_bucketed",
    "plan_packed",
    "plan_stream",
    "plan_wstack",
    "stream_tasks",
    "row_sharding",
    "wstack_degrid_all_sharded",
    "wstack_grid_all_sharded",
]
