"""Scan-to-scan odometry benchmark: 100-frame chain, scans/s + drift.

Fills the BASELINE.md odometry row. The workload is
the reference's library-only odometry path (``localization/include/
lidar_feature_localization/odometry.hpp:43-73``: register each scan's
extracted features against the merged recent-7 window, insert at the
estimated pose — the reference rebuilds KD-trees of the merged window
every scan, ``recent_scans.hpp:74``; this engine rebuilds dense voxel
grids on device, ``pipeline/odometry.py``).

Frames are feature clouds (the odometry consumes already-extracted
scans, as in the reference) sampled from a worldsim pole+ground world
along a scripted drive; the whole 100-frame chain runs in ONE device
dispatch (lax.scan over ``odometry_step``) with the same timing rules
as bench.py (chained inputs, best-of-5).

Run:                      python bench_odometry.py
Validate on CPU quickly:  JAX_PLATFORMS=cpu BENCH_ODOM_FRAMES=10 \
                              python bench_odometry.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def make_frames(cfg, rng, n_frames):
    """Per-frame sensor-frame feature clouds along the drive + gt."""
    from lidar_feature_extraction_tpu.utils import worldsim

    world = worldsim.make_world(rng, n_poles=50, extent=60.0)
    world_edges, world_surfs = worldsim.world_maps(
        world, rng, points_per_pole=40, n_ground=20000)

    e_cap = cfg.extraction.max_edges
    s_cap = cfg.extraction.max_surfaces
    E = min(e_cap, 1024)
    S = min(s_cap, 4096)

    edges = np.zeros((n_frames, e_cap, 3), np.float32)
    e_val = np.zeros((n_frames, e_cap), bool)
    surfs = np.zeros((n_frames, s_cap, 3), np.float32)
    s_val = np.zeros((n_frames, s_cap), bool)
    gt = np.zeros((n_frames, 3), np.float32)
    import jax.numpy as jnp

    for i in range(n_frames):
        pose = worldsim.straight_drive(i)
        gt[i] = np.asarray(pose.t)
        inv = pose.inverse()
        # Visible world points (within 60 m), sensor frame, with noise.
        for (wpts, buf, val, cap) in ((world_edges, edges, e_val, E),
                                      (world_surfs, surfs, s_val, S)):
            d = np.linalg.norm(wpts[:, :2] - np.asarray(pose.t)[:2],
                               axis=-1)
            vis = np.flatnonzero(d < 60.0)
            pick = rng.choice(vis, size=min(cap, len(vis)),
                              replace=False)
            pts = np.array(inv.apply(jnp.asarray(
                wpts[pick], jnp.float32)))
            pts += rng.normal(scale=0.01, size=pts.shape)
            buf[i, :len(pts)] = pts
            val[i, :len(pts)] = True
    return (edges, e_val, surfs, s_val), gt


def make_frames_extracted(cfg, rng, n_frames):
    """Per-frame feature clouds from the REAL front half: ray-cast
    sweeps of the world driven through feature extraction (the
    eval_ate.py pipeline), instead of resampled map points. This is
    the honest drift workload — resampled map points give near-perfect
    correspondences by construction, so their drift column
    is a best-case bound; extracted features carry the extraction
    noise, occlusions and silhouette effects the reference's odometry
    would actually see."""
    import jax
    import jax.numpy as jnp

    from lidar_feature_extraction_tpu.core.scan import build_range_image
    from lidar_feature_extraction_tpu.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu.utils import worldsim

    world = worldsim.make_world(rng, n_poles=50, extent=60.0)
    ex = cfg.extraction
    n = ex.n_rings * ex.max_points_per_ring
    extract = jax.jit(lambda im: extract_features(im, ex))

    e_cap, s_cap = ex.max_edges, ex.max_surfaces
    edges = np.zeros((n_frames, e_cap, 3), np.float32)
    e_val = np.zeros((n_frames, e_cap), bool)
    surfs = np.zeros((n_frames, s_cap, 3), np.float32)
    s_val = np.zeros((n_frames, s_cap), bool)
    gt = np.zeros((n_frames, 3), np.float32)
    for i in range(n_frames):
        pose = worldsim.straight_drive(i)
        gt[i] = np.asarray(pose.t)
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
        image = build_range_image(
            jnp.asarray(buf), jnp.asarray(rid), jnp.asarray(val),
            ex.n_rings, ex.max_points_per_ring,
            min_points_per_ring=ex.padding + 1)
        f = extract(image)
        edges[i] = np.asarray(f.edge_xyz)
        e_val[i] = np.asarray(f.edge_valid)
        surfs[i] = np.asarray(f.surface_xyz)
        s_val[i] = np.asarray(f.surface_valid)
    return (edges, e_val, surfs, s_val), gt


def bench_mode(cfg, frames_np, gt, init_fn, step_fn, n_frames):
    import jax
    import jax.numpy as jnp

    from lidar_feature_extraction_tpu.core.pose import Pose

    frames = tuple(jnp.asarray(a) for a in frames_np)

    def chain(frames, wobble):
        """Run the whole odometry chain in one dispatch, with the
        production constant-velocity GN seed carried in-graph
        (pipeline/odometry.py Odometry.update; the host-side fallback
        ladder is not representable inside lax.scan and is not needed
        on a smooth drive). ``wobble`` (a tiny carried perturbation)
        keeps repeated timing samples from being identical dispatches."""
        e, ev, s, sv = frames
        state0 = init_fn(cfg)

        def body(carry, frame):
            state, prev_q, prev_t = carry
            fe, fev, fs, fsv = frame
            cur = Pose(state.pose_q, state.pose_t)
            prev = Pose(prev_q, prev_t)
            prior = cur.compose(prev.inverse().compose(cur))
            state2, result = step_fn(
                state, fe + wobble[None, :], fev, fs + wobble[None, :],
                fsv, cfg, prior_q=prior.q, prior_t=prior.t)
            return ((state2, cur.q, cur.t),
                    (result.pose.t, result.iterations))

        carry0 = (state0, state0.pose_q, state0.pose_t)
        _, (ts, iters) = jax.lax.scan(body, carry0, (e, ev, s, sv))
        return ts, iters

    run = jax.jit(chain)
    ts, iters = run(frames, jnp.zeros(3, jnp.float32))
    jax.block_until_ready(ts)
    dt_best = float("inf")
    wob = jnp.zeros(3, jnp.float32)
    for _ in range(5):
        t0 = time.perf_counter()
        ts, iters = run(frames, wob)
        jax.block_until_ready(ts)
        dt_best = min(dt_best, time.perf_counter() - t0)
        wob = 1e-6 * ts[-1] / jnp.maximum(jnp.linalg.norm(ts[-1]), 1.0)

    est = np.asarray(ts)
    # Frame 0 initializes the window at the origin; drift over the rest.
    step_err = np.linalg.norm(np.diff(est, axis=0)
                              - np.diff(gt, axis=0), axis=-1)
    return {
        "scans_per_sec": round(n_frames / dt_best, 2),
        "ms_per_scan": round(1000 * dt_best / n_frames, 3),
        "gn_iterations_per_scan": round(float(np.mean(
            np.asarray(iters)[1:])), 2),
        "final_drift_m": round(float(np.linalg.norm(est[-1] - gt[-1])), 4),
        "mean_step_drift_m": round(float(step_err.mean()), 4),
        "n_frames": n_frames,
    }


def main():
    from lidar_feature_extraction_tpu.config import kitti_hdl64
    from lidar_feature_extraction_tpu.pipeline.odometry import (
        geometry_odometry_step, init_geometry_odometry, init_odometry,
        odometry_step)
    from lidar_feature_extraction_tpu.utils.compile_cache import (
        enable_compile_cache)
    from lidar_feature_extraction_tpu.utils.device_info import (
        device_record)

    enable_compile_cache()

    # Default: the incremental moment-grid map (geometry_odometry_step);
    # BENCH_ODOM_MODE=points benches the point-grid kNN path (the direct
    # analogue of the reference's per-scan KD-tree rebuilds).
    if os.environ.get("BENCH_ODOM_MODE") == "points":
        init_fn, step_fn = init_odometry, odometry_step
    else:
        init_fn, step_fn = init_geometry_odometry, geometry_odometry_step

    cfg = kitti_hdl64()
    n_frames = int(os.environ.get("BENCH_ODOM_FRAMES", "100"))
    out = {}
    for mode, maker in (("extracted_features", make_frames_extracted),
                        ("resampled_map_points", make_frames)):
        rng = np.random.default_rng(0)
        frames_np, gt = maker(cfg, rng, n_frames)
        out[mode] = bench_mode(cfg, frames_np, gt, init_fn, step_fn,
                               n_frames)
        print(mode, json.dumps(out[mode]), flush=True)

    summary = {
        "metric": "odometry_scans_per_sec_single_chip",
        "value": out["extracted_features"]["scans_per_sec"],
        "unit": "scans/s",
        "device": device_record(),
        **out,
    }
    print(json.dumps(summary))
    with open("ODOMETRY_BENCH.json", "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
