"""Batched-serving throughput: vmap'd localize_scan at batch 2/4/8.

The headline bench (bench.py) measures the sequentially-dependent
replay chain — each scan's prior comes from the previous result, the
latency-critical online-localization shape. Production mapping and
multi-vehicle serving pipelines instead localize INDEPENDENT scans
(different vehicles, or offline mapping shards), where the chip can
overlap work across a batch: this bench measures that envelope.

Run: python bench_batch.py   (writes BATCH_BENCH.json)
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bench import build_scene
    from lidar_feature_extraction_tpu.config import kitti_hdl64
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.pipeline.localization import (
        localize_scan)
    from lidar_feature_extraction_tpu.utils.compile_cache import (
        enable_compile_cache)
    from lidar_feature_extraction_tpu.utils.device_info import (
        device_record)

    enable_compile_cache()
    device = device_record()
    cfg = kitti_hdl64()
    rng = np.random.default_rng(0)
    maps, image = build_scene(cfg, rng)
    prior = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                 t=jnp.asarray([0.3, -0.2, 0.05], jnp.float32))
    n_loop = int(os.environ.get("BENCH_BATCH_ITERS", "50"))

    results = []
    for B in (2, 4, 8, 16, 32):
        images = jax.tree.map(lambda x: jnp.stack([x] * B), image)
        priors = Pose(q=jnp.stack([prior.q] * B),
                      t=jnp.stack([prior.t] * B))

        def loop(maps, images, priors):
            # Chained carry: each step depends on the last.
            def body(i, carry):
                tot, t = carry
                ims = images._replace(
                    xyz=images.xyz + 1e-3 * t[None, None, None, :])
                prs = Pose(q=priors.q, t=priors.t + 1e-3 * t[None, :])
                res, _ = jax.vmap(
                    lambda im, p: localize_scan(maps, im, p, cfg))(ims,
                                                                   prs)
                return tot + jnp.sum(res.iterations), res.pose.t[0]
            return jax.lax.fori_loop(
                0, n_loop, body, (jnp.asarray(0, jnp.int32), prior.t))

        run = jax.jit(loop)
        out = run(maps, images, priors)
        jax.block_until_ready(out)
        dt = float("inf")
        for _ in range(4):
            t0 = time.perf_counter()
            out = run(maps, images, priors)
            jax.block_until_ready(out)
            dt = min(dt, time.perf_counter() - t0)
        n_scans = n_loop * B
        row = {"batch": B, "scans_per_sec": round(n_scans / dt, 1),
               "ms_per_scan": round(1000 * dt / n_scans, 3)}
        results.append(row)
        print(json.dumps(row), flush=True)

    with open("BATCH_BENCH.json", "w") as f:
        json.dump({"device": device, "rows": results}, f, indent=1)


if __name__ == "__main__":
    main()
