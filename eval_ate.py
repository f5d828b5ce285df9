"""Closed-loop ATE evaluation of the production kitti_hdl64 stack.

Replays one pre-generated synthetic drive (utils/worldsim.py) through
the EXACT benched configuration (``config.py kitti_hdl64``:
64x2304 range image, GeometryMaps, compact extraction) AND through the
faithful path (FeatureMaps, full extraction, per-iteration
neighborhood refits) with identical extraction parameters, then prints
ATE-RMSE of both against ground truth and writes ``ATE_EVAL.json``.

This is the acceptance evidence for the production path's documented
deviations (docs/design.md §8). The CI-speed
regression guard lives in ``tests/test_production_parity.py``; this
script records the full-shape numbers quoted in BASELINE.md.

Runs on JAX's default backend; the committed ATE_EVAL.json is a CPU
run:
    JAX_PLATFORMS=cpu python eval_ate.py
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np


def main():
    import jax.numpy as jnp

    from lidar_feature_extraction_tpu.config import kitti_hdl64
    from lidar_feature_extraction_tpu.utils.compile_cache import (
        enable_compile_cache)
    from lidar_feature_extraction_tpu.utils.device_info import (
        device_record)
    from lidar_feature_extraction_tpu.pipeline.localization import (
        build_feature_maps, build_geometry_maps)
    from lidar_feature_extraction_tpu.utils import worldsim
    from lidar_feature_extraction_tpu.utils.evaluation import (
        ate_rmse, relative_translation_errors)

    enable_compile_cache()
    production = kitti_hdl64()
    # Faithful variant: identical extraction parameters and shapes; the
    # deviation stack off (full extraction -> point maps -> cached-
    # candidate kNN with per-iteration line/plane refits).
    faithful = dataclasses.replace(
        production,
        compact_extraction=False,
        registration=dataclasses.replace(production.registration,
                                         refit_per_iteration=True))

    rng = np.random.default_rng(0)
    # KITTI-like world ray-cast into full 64-ring HDL-64E sweeps
    # (~110k points/scan, real silhouette discontinuities + occlusion).
    world = worldsim.make_world(rng, n_poles=50, extent=35.0)
    world_edges, world_surfs = worldsim.world_maps(world, rng,
                                                  n_ground=30000)
    scans, gt = worldsim.make_scan_sequence(
        world, rng, n_scans=20, n_rings=64, n_az=2048,
        elev_deg=(2.0, -24.8))
    twists = worldsim.synth_twists(len(scans), rng=rng)

    args = (jnp.asarray(world_edges, jnp.float32),
            jnp.ones(len(world_edges), bool),
            jnp.asarray(world_surfs, jnp.float32),
            jnp.ones(len(world_surfs), bool))
    geometry_maps = build_geometry_maps(*args, production)
    feature_maps = build_feature_maps(*args, faithful)

    out = {}
    for name, maps, cfg in (("production_kitti_hdl64", geometry_maps,
                             production),
                            ("faithful", feature_maps, faithful)):
        t0 = time.time()
        est = worldsim.run_drive(maps, cfg, scans, twists=twists)
        out[name] = {
            "ate_rmse_m": round(ate_rmse(est, gt, align=False), 4),
            "ate_xy_rmse_m": round(ate_rmse(
                np.pad(est[:, :2], ((0, 0), (0, 1))),
                np.pad(gt[:, :2], ((0, 0), (0, 1))), align=False), 4),
            "mean_step_drift_m": round(float(np.mean(
                relative_translation_errors(est, gt))), 4),
            "wall_s": round(time.time() - t0, 1),
        }
        print(name, out[name], flush=True)

    out["ratio_production_over_faithful"] = round(
        out["production_kitti_hdl64"]["ate_rmse_m"]
        / max(out["faithful"]["ate_rmse_m"], 1e-9), 3)
    out["n_scans"] = len(scans)
    out["device"] = device_record()

    out["slam_loop"] = eval_slam_loop(production, world, rng)
    print("slam_loop", out["slam_loop"], flush=True)
    out["slam_loop_imu"] = eval_slam_loop(production, world, rng,
                                          with_imu=True)
    print("slam_loop_imu", out["slam_loop_imu"], flush=True)

    bad = _nonfinite_paths(out)
    if bad:
        # Structural guard: a failed drive must
        # never silently replace a good artifact — r3 and r4 both
        # ended with ATE_EVAL.json contradicting the docs because a
        # NaN run wrote the file and exited 0.
        print(f"REFUSING to write ATE_EVAL.json: non-finite metrics at "
              f"{bad}", flush=True)
        raise SystemExit(1)
    with open("ATE_EVAL.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


def _nonfinite_paths(tree, prefix=""):
    """Dotted paths of every non-finite number in a nested dict."""
    bad = []
    if isinstance(tree, dict):
        for key, val in tree.items():
            bad += _nonfinite_paths(val, f"{prefix}{key}.")
    elif isinstance(tree, (int, float)) and not np.isfinite(tree):
        bad.append(prefix.rstrip("."))
    return bad


def eval_slam_loop(cfg, world, rng, n_scans: int = 80,
                   radius: float = 10.0, with_imu: bool = False,
                   scan_period: float = 0.1):
    """Full mapping workload (BASELINE row 4): odometry front-end +
    keyframes + loop closure + pose-graph back-end over a closed
    circular drive on the ray-cast world; ATE of the optimized
    keyframe trajectory vs ground truth. ``with_imu`` feeds synthesized
    IMU windows (fusion/imu.py) as scan-matcher priors and keyframe
    factors — the LIO-SAM-style configuration the reference's stubbed
    imu_integration package intended. Delegates to
    ``worldsim.run_mapping_drive`` (shared with the reduced-shape CI
    regression, tests/test_slam_drive.py)."""
    import time

    from lidar_feature_extraction_tpu.utils import worldsim
    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    t0 = time.time()
    pipeline, gt = worldsim.run_mapping_drive(
        world, cfg, rng, n_scans=n_scans, radius=radius,
        scan_period=scan_period, with_imu=with_imu,
        pipeline_kwargs=dict(loop_radius=6.0, loop_min_gap=10,
                             optimize_every=8),
        n_rings=64, n_az=2048, elev_deg=(2.0, -24.8))
    est = pipeline.trajectory
    n_chain = len(pipeline.keyframes) - 1
    return {
        "ate_rmse_m": round(ate_rmse(est, gt, align=False), 4),
        "n_keyframes": len(pipeline.keyframes),
        "n_loop_constraints": len(pipeline.constraints) - n_chain,
        "wall_s": round(time.time() - t0, 1),
    }


if __name__ == "__main__":
    main()
