"""Multi-device scaling harness: batched localization throughput vs
device count (BASELINE.json config 5).

On real multi-chip hardware this measures scans/s at 1..N chips and the
scaling efficiency; in this single-chip environment run it on the
virtual CPU mesh to validate the sharded program end-to-end:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python bench_scaling.py

Prints one JSON line per device count plus a summary efficiency figure.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    import jax.numpy as jnp

    from bench import build_scene
    from lidar_feature_extraction_tpu.config import (ExtractionConfig,
                                                     PipelineConfig,
                                                     RegistrationConfig,
                                                     VoxelMapConfig)
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.core.scan import RangeImage
    from lidar_feature_extraction_tpu.parallel.mesh import make_mesh
    from lidar_feature_extraction_tpu.parallel.distributed import (
        make_batched_localizer)

    n_devices = len(jax.devices())
    scans_per_device = int(os.environ.get("SCALING_SCANS_PER_DEVICE", "2"))

    # Small shapes so the CPU-mesh validation stays fast; on real
    # hardware export SCALING_FULL=1 for KITTI-sized shapes.
    if os.environ.get("SCALING_FULL"):
        from lidar_feature_extraction_tpu.config import kitti_hdl64

        cfg = kitti_hdl64()
    else:
        vm = VoxelMapConfig(voxel_size=2.0, table_capacity=1 << 12,
                            points_per_voxel=8, max_probes=8)
        cfg = PipelineConfig(
            extraction=ExtractionConfig(
                n_rings=16, max_points_per_ring=512, nms_rounds=16,
                max_edges=512, max_surfaces=1024),
            registration=RegistrationConfig(
                n_neighbors=8, max_iterations=8, n_search_rounds=1,
                edge_map=vm, surface_map=vm, max_surface_points=1024))

    rng = np.random.default_rng(0)
    maps, image = build_scene(cfg, rng)

    results = {}
    counts = [c for c in [1, 2, 4, 8, n_devices]
              if c <= n_devices]
    for c in sorted(set(counts)):
        mesh = make_mesh(c)
        localizer = make_batched_localizer(mesh, cfg)
        b = c * scans_per_device
        images = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), image)
        priors = Pose(
            q=jnp.broadcast_to(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                               (b, 4)),
            t=jnp.zeros((b, 3), jnp.float32))
        out = localizer(maps, images, priors)
        jax.block_until_ready(out[0].pose.t)
        t0 = time.perf_counter()
        out = localizer(maps, images, priors)
        jax.block_until_ready(out[0].pose.t)
        dt = time.perf_counter() - t0
        sps = b / dt
        results[c] = sps
        print(json.dumps({"devices": c, "batch": b,
                          "scans_per_sec": round(sps, 2)}))

    if 1 in results and n_devices in results and n_devices > 1:
        eff = results[n_devices] / (results[1] * n_devices)
        print(json.dumps({"metric": "scaling_efficiency",
                          "devices": n_devices,
                          "value": round(eff, 3)}))


if __name__ == "__main__":
    main()
