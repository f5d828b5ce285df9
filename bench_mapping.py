"""Full-mapping-pipeline throughput benchmark -> MAPPING_BENCH.json.

Measures the COMPLETE mapping workload (BASELINE.json config 4:
raycast sweeps -> extraction -> odometry -> keyframes -> loop closure
-> pose-graph back-end) at full KITTI-HDL64 shape, separating compile
from steady state, in both front-end modes:

* ``per_scan``: the host-stepped pipeline (pipeline/slam.py
  process_scan), with a per-stage split — extraction, odometry
  registration, bookkeeping (keyframes + loop closures + graph
  optimization), host glue.
* ``chunked``: the block front-end (pipeline/mapping_chunk.py), which
  amortizes the host-device round trip over ``--block`` scans per
  dispatch.

Steady state = a SECOND run of the same drive in the same process on a
fresh pipeline: every program is already compiled (shape buckets in
MappingPipeline.optimize keep back-end shapes stable), so the second
pass is pure execution + dispatch.

The drive itself is the eval_ate.py slam_loop drive (80 scans, ~63 m
circle); the benchmark asserts the benched trajectory is metric
(finite, ATE < 0.3 m) and refuses to write the artifact otherwise —
a throughput number for a broken drive is not a measurement.

Run: python bench_mapping.py            (default backend)
     JAX_PLATFORMS=cpu python bench_mapping.py
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_drive(cfg, n_scans, radius, rng):
    """Pre-generate raycast range images + ground truth on the host."""
    import jax.numpy as jnp

    from lidar_feature_extraction_tpu.core.scan import build_range_image
    from lidar_feature_extraction_tpu.utils import worldsim

    world = worldsim.make_world(rng, n_poles=50, extent=35.0)
    ex = cfg.extraction
    n = ex.n_rings * ex.max_points_per_ring
    images, gt = [], []
    for i in range(n_scans):
        pose = worldsim.circle_pose(i, n_scans, radius)
        pts, ring = worldsim.raycast_scan(world, pose, rng, n_rings=64,
                                          n_az=2048,
                                          elev_deg=(2.0, -24.8))
        buf = np.zeros((n, 3), np.float32)
        rid = np.zeros(n, np.int32)
        val = np.zeros(n, bool)
        m = min(len(pts), n)
        buf[:m] = pts[:m]
        rid[:m] = ring[:m]
        val[:m] = True
        images.append(build_range_image(
            jnp.asarray(buf), jnp.asarray(rid), jnp.asarray(val),
            ex.n_rings, ex.max_points_per_ring,
            min_points_per_ring=ex.padding + 1))
        gt.append(np.asarray(pose.t))
    return images, np.stack(gt)


def drive_per_scan(cfg, images, kwargs, instrument=False):
    """One full per-scan mapping drive; returns (pipeline, stage_s)."""
    import jax

    from lidar_feature_extraction_tpu.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu.pipeline.slam import MappingPipeline

    extract = jax.jit(lambda im: extract_features(im, cfg.extraction))
    pipeline = MappingPipeline(cfg, **kwargs)
    stage = {"extract": 0.0, "odometry": 0.0, "bookkeeping": 0.0,
             "host_glue": 0.0}
    t_all0 = time.perf_counter()
    for i, im in enumerate(images):
        t0 = time.perf_counter()
        f = extract(im)
        if instrument:
            jax.block_until_ready(f.edge_xyz)
        t1 = time.perf_counter()
        reg = pipeline.odometry.update(f.edge_xyz, f.edge_valid,
                                       f.surface_xyz, f.surface_valid)
        if instrument:
            jax.block_until_ready(pipeline.odometry.state.pose_t)
        t2 = time.perf_counter()
        pipeline.ingest_odometry_result(
            f.edge_xyz, f.edge_valid, f.surface_xyz, f.surface_valid,
            pipeline.odometry.pose, hessian=reg.hessian, stamp=0.1 * i)
        t3 = time.perf_counter()
        stage["extract"] += t1 - t0
        stage["odometry"] += t2 - t1
        stage["bookkeeping"] += t3 - t2
    pipeline.optimize()
    stage["total_wall"] = time.perf_counter() - t_all0
    stage["host_glue"] = stage["total_wall"] - (
        stage["extract"] + stage["odometry"] + stage["bookkeeping"])
    return pipeline, stage


def drive_chunked(cfg, images, kwargs, block):
    import jax
    import jax.numpy as jnp

    from lidar_feature_extraction_tpu.pipeline.mapping_chunk import (
        ChunkedMappingPipeline)

    pipeline = ChunkedMappingPipeline(cfg, **kwargs)
    t0 = time.perf_counter()
    for s in range(0, len(images), block):
        blk = images[s:s + block]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *blk)
        pipeline.process_block(stacked,
                               [0.1 * (s + k) for k in range(len(blk))])
    pipeline.optimize()
    return pipeline, time.perf_counter() - t0


def ate_of(pipeline, gt, n_scans):
    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    idx = [int(round(kf.stamp / 0.1)) for kf in pipeline.keyframes]
    return float(ate_rmse(pipeline.trajectory, gt[idx], align=False))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=80)
    ap.add_argument("--block", type=int, default=10)
    args = ap.parse_args()

    from lidar_feature_extraction_tpu.config import kitti_hdl64
    from lidar_feature_extraction_tpu.utils.compile_cache import (
        enable_compile_cache)
    from lidar_feature_extraction_tpu.utils.device_info import (
        device_record)

    enable_compile_cache()
    cfg = kitti_hdl64()
    kwargs = dict(loop_radius=6.0, loop_min_gap=10, optimize_every=8)
    rng = np.random.default_rng(0)
    print("building drive ...", flush=True)
    images, gt = build_drive(cfg, args.scans, 10.0, rng)

    out = {"device": device_record(), "n_scans": args.scans,
           "block": args.block}

    print("per-scan cold ...", flush=True)
    t0 = time.perf_counter()
    pipe_cold, _ = drive_per_scan(cfg, images, kwargs)
    cold_s = time.perf_counter() - t0
    print("per-scan steady ...", flush=True)
    pipe, stage = drive_per_scan(cfg, images, kwargs, instrument=True)
    ate = ate_of(pipe, gt, args.scans)
    out["per_scan"] = {
        "cold_wall_s": round(cold_s, 1),
        "steady_wall_s": round(stage["total_wall"], 2),
        "steady_scans_per_sec": round(
            args.scans / stage["total_wall"], 2),
        "stage_s": {k: round(v, 2) for k, v in stage.items()
                    if k != "total_wall"},
        "ate_rmse_m": round(ate, 4),
        "n_keyframes": len(pipe.keyframes),
    }
    print(json.dumps(out["per_scan"]), flush=True)

    print("chunked cold ...", flush=True)
    _, cold_c = drive_chunked(cfg, images, kwargs, args.block)
    print("chunked steady ...", flush=True)
    pipe_c, steady_c = drive_chunked(cfg, images, kwargs, args.block)
    ate_c = ate_of(pipe_c, gt, args.scans)
    out["chunked"] = {
        "cold_wall_s": round(cold_c, 1),
        "steady_wall_s": round(steady_c, 2),
        "steady_scans_per_sec": round(args.scans / steady_c, 2),
        "ate_rmse_m": round(ate_c, 4),
        "n_keyframes": len(pipe_c.keyframes),
    }
    print(json.dumps(out["chunked"]), flush=True)

    finite = all(np.isfinite(v) for v in
                 (out["per_scan"]["ate_rmse_m"],
                  out["chunked"]["ate_rmse_m"]))
    if not finite or out["per_scan"]["ate_rmse_m"] > 0.3 \
            or out["chunked"]["ate_rmse_m"] > 0.3:
        print("REFUSING to write MAPPING_BENCH.json: benched drive is "
              "not metric", flush=True)
        raise SystemExit(1)
    with open("MAPPING_BENCH.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
