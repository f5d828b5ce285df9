"""Device-mesh helpers for multi-chip execution.

The reference has no distributed capability at all (SURVEY.md §2.8: the
ROS node graph is its only parallelism); scale-out is a first-class
feature here: scans/keyframes shard over the ``data`` axis of a Mesh,
reductions are collectives over the mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_batch(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Leading-axis sharding for per-scan batches."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
