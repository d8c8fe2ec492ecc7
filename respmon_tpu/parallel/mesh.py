"""Device-mesh helpers.

The reference is single-process/single-device (SURVEY.md §2.2); this
design scales by placing independent video streams along a ``'streams'``
mesh axis (pure data parallelism — zero collectives) and optionally
sharding single large frames spatially (``parallel/spatial.py``, halo
exchange between neighbouring devices).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("streams",),
              devices=None) -> Mesh:
    """Build a mesh over the available devices (default: 1-D 'streams')."""
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    arr = np.asarray(devices).reshape(axis_sizes)
    return Mesh(arr, axis_names)


def stream_sharding(mesh: Mesh, ndim: int,
                    axis: str = "streams") -> NamedSharding:
    """Shard the leading (stream) axis, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
