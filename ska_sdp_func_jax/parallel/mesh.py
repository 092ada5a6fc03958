"""Device-mesh helpers for sharding visibility data.

The canonical layout shards the visibility **row** axis (time x baseline)
across devices — the analogue of the reference's ``start_row/end_row``
process-sharding hooks (grid_data/sdp_gridder_wtower_uvw.h:91-93).
"""

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

ROW_AXIS = "rows"


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = ROW_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a 1-D device mesh over the visibility-row axis.

    With no arguments uses all available devices. ``num_devices`` takes a
    prefix of `jax.devices()` (useful for scaling studies).
    """
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            if num_devices > len(devices):
                raise ValueError(
                    f"Requested {num_devices} devices but only "
                    f"{len(devices)} available")
            devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def row_sharding(mesh: Mesh, axis_name: str = ROW_AXIS) -> NamedSharding:
    """Sharding that splits the leading (row) axis across the mesh."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def pad_rows(num_rows: int, num_shards: int) -> Tuple[int, int]:
    """Return (padded_rows, pad) so padded_rows % num_shards == 0.

    Padded rows are masked out via ``end_ch = 0`` channel ranges (the same
    no-op selection the channel clamping produces for out-of-box rows), so
    they contribute nothing to any operator.
    """
    rem = num_rows % num_shards
    pad = 0 if rem == 0 else num_shards - rem
    return num_rows + pad, pad


def pad_rows_arrays(uvw, vis, start_chs, end_chs, num_shards: int):
    """Pad row-axis arrays to a multiple of ``num_shards``.

    Pad rows get ``start_ch = end_ch = 0`` so they select no channels.
    """
    num_rows = uvw.shape[0]
    _, pad = pad_rows(num_rows, num_shards)
    if pad == 0:
        return uvw, vis, start_chs, end_chs
    uvw = jnp.concatenate([uvw, jnp.zeros((pad, 3), uvw.dtype)])
    if vis is not None:
        vis = jnp.concatenate(
            [vis, jnp.zeros((pad,) + vis.shape[1:], vis.dtype)])
    start_chs = jnp.concatenate([start_chs,
                                 jnp.zeros((pad,), start_chs.dtype)])
    end_chs = jnp.concatenate([end_chs, jnp.zeros((pad,), end_chs.dtype)])
    return uvw, vis, start_chs, end_chs
