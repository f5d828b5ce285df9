"""Multi-host initialization and host-sharded scan feeding.

No reference counterpart (the reference is single-host, SURVEY.md
§2.8); this is the bootstrap for multi-host runs: one
``jax.distributed.initialize`` per host, a global mesh over all devices,
and helpers for feeding per-host scan shards into globally-sharded
batches (`multihost_utils`-style host-local -> global assembly).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up jax.distributed (no-op when single-process).

    Arguments default to the JAX_* environment contract of
    ``jax.distributed``: ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` (exactly the variables
    ``jax.distributed.initialize`` itself falls back to when it
    cannot detect a cluster). Explicit arguments win over the environment.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)


def global_mesh(axis: str = "data") -> Mesh:
    """One mesh over every chip of every host."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_local_batch_to_global(mesh: Mesh, local_batch, axis: str = "data"):
    """Assemble per-host scan batches into one globally-sharded batch.

    Each host passes its local shard (leading axis = scans this host
    ingested); the result is a global array whose leading axis is the
    concatenation over hosts, sharded over ``axis``. Uses
    ``jax.make_array_from_process_local_data`` so no cross-host copies
    happen through the host network.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sharding, x),
        local_batch)


def replicate_to_global(mesh: Mesh, tree):
    """Turn identical per-host data into a globally-replicated array.

    Every host must pass the SAME values (e.g. the feature maps each
    host loaded from the same file, or a deterministic pose graph): the
    result is one global jax.Array replicated over every device of the
    mesh, suitable for the replicated operands of pjit'd steps
    (``distributed.make_batched_localizer`` maps, pose-graph state).
    """
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)),
        tree)
