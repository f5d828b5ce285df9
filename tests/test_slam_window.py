"""Sliding-window freeze + frozen-region loop closure drive.
Own module: the drive's compile volume needs the
full per-module executable budget (see conftest fixture docstring —
test_slam.py's other drives plus this one in a single process cross
the XLA:CPU live-executable segfault threshold)."""

import numpy as np
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.pipeline.slam import MappingPipeline
from test_pipeline import make_world, pad_to, sample_scan_features, small_cfg


def test_window_freeze_with_frozen_region_loop_closure():
    """A drive long enough that ``mapping.max_keyframes`` actually
    evicts (two laps of a circle, window 24 of ~50 keyframes), with
    lap-2 loop closures landing on lap-1 keyframes that are FROZEN by
    then — the bridge re-anchoring path (pipeline/slam.py optimize:
    constraints with a frozen endpoint re-anchor on the window's
    gauge-fixed first pose) that r4 only ever exercised on a toy
    6-keyframe chain. The trajectory must stay
    metric end to end; a wrong bridge transform would bend the live
    window against the frozen map."""
    import dataclasses

    from lidar_feature_extraction_tpu.core import quaternion as quat

    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(
        small_cfg(),
        mapping=dataclasses.replace(small_cfg().mapping,
                                    max_keyframes=16))
    world_edges, world_surfs = make_world(rng)

    radius, n_per_lap, laps = 6.0, 20, 2
    n_scans = n_per_lap * laps
    pipeline = MappingPipeline(cfg, loop_radius=3.0, loop_min_gap=12,
                               optimize_every=8)
    gt = []
    r = np.random.default_rng(8)
    for i in range(n_scans):
        th = 2 * np.pi * (i % n_per_lap) / n_per_lap
        pose = Pose(
            q=quat.exp_so3(jnp.asarray([0, 0, th], jnp.float32)),
            t=jnp.asarray([radius * np.sin(th),
                           radius * (1 - np.cos(th)), 0.0], jnp.float32))
        e, s = sample_scan_features(world_edges, world_surfs, pose, r,
                                    n_e=200, n_s=500)
        # Per-scan measurement noise so the odometry chain actually
        # drifts and the closures have work to do.
        e = e + jnp.asarray(r.normal(scale=0.02, size=e.shape),
                            jnp.float32)
        s = s + jnp.asarray(r.normal(scale=0.02, size=s.shape),
                            jnp.float32)
        e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
        s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
        pipeline.process_scan(e_pts, e_valid, s_pts, s_valid,
                              stamp=0.1 * i)
        gt.append(np.asarray(pose.t))
    pipeline.optimize()

    k = len(pipeline.keyframes)
    offset = k - cfg.mapping.max_keyframes
    # The window really evicted ...
    assert offset > 10, k
    # ... there are accepted loop closures, and at least one reaches
    # a keyframe in the final frozen region (the bridge path).
    loops = [c for c in pipeline.constraints if c[1] - c[0] > 1]
    assert loops, "no loop closures accepted"
    assert any(c[0] < offset for c in loops), (
        offset, [(c[0], c[1]) for c in loops])

    # Metric end to end: every keyframe near its ground-truth circle
    # position (keyframe stamps map back to drive indices).
    gt = np.stack(gt)
    errs = []
    for kf in pipeline.keyframes:
        idx = int(round(kf.stamp / 0.1))
        errs.append(np.linalg.norm(
            np.asarray(kf.pose.t) - gt[idx]))
    errs = np.asarray(errs)
    assert errs.max() < 0.5, (errs.max(), errs.argmax())
    assert np.sqrt((errs ** 2).mean()) < 0.25, errs
