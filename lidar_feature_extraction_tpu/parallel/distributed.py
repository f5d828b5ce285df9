"""Data-parallel scan processing over a device mesh.

The reference processes one scan at a time in a single-threaded C++
callback (``extraction/app/feature_extraction.cpp:92``); this engine
batches scans and shards the batch over the mesh: extraction +
registration are pure per-scan functions, so DP is a ``vmap`` + batch
sharding and XLA partitions everything else automatically. Feature maps
are replicated (they are read-only during localization); the EKF and
pose feedback stay on the host driver.

This is the scans/s scaling surface for multi-chip BASELINE configs:
mapping a sequence = localize B scans per step, one batch per device
group, keyframe insertion afterward.
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lidar_feature_extraction_tpu.config import PipelineConfig
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.core.scan import RangeImage
from lidar_feature_extraction_tpu.pipeline.localization import (FeatureMaps,
                                                                localize_scan)


def make_batched_localizer(mesh: Mesh, cfg: PipelineConfig,
                           axis: str = "data"):
    """Returns a jitted fn(maps, images[B], priors[B]) -> (results[B],
    feats[B]) with the scan batch sharded over ``axis`` and maps
    replicated. B must be a multiple of the mesh size."""

    batched = jax.vmap(partial(localize_scan, cfg=cfg),
                       in_axes=(None, 0, 0))

    replicated = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(axis))

    fn = jax.jit(
        batched,
        in_shardings=(replicated,
                      RangeImage(sharded, sharded, sharded),
                      Pose(sharded, sharded)),
        out_shardings=(sharded, sharded),
    )

    def run(maps: FeatureMaps, images: RangeImage, priors: Pose):
        return fn(maps, images, priors)

    return run
