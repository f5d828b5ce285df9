"""Reduced-shape closed-loop IMU mapping regression: the with-IMU twin
of ``tests/test_slam_drive.py``.

Same code path as ``eval_ate.py``'s ``slam_loop_imu`` acceptance drive
(``worldsim.run_mapping_drive(with_imu=True)``: raycast -> extraction
-> IMU-predicted odometry prior -> keyframes + preintegrated factors
-> loop closure -> joint (pose, velocity, gyro-bias) back-end), at
32x1024 / 40 scans. This is the exact path that regressed twice in r4
(the ``7765efd`` NaN drive and the ``1b59594`` bias-clamp break) with
no CI guard; a run of this test would have caught both. The back-end
capability it pins is the one the reference stubbed
(``imu_integration/include/imu_integration/integration.hpp:30-33``).
"""

import dataclasses

import numpy as np

from lidar_feature_extraction_tpu.config import kitti_hdl64
from lidar_feature_extraction_tpu.utils import worldsim
from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse


def test_circular_drive_with_imu_closes_loop_and_stays_metric():
    prod = kitti_hdl64()
    cfg = dataclasses.replace(
        prod,
        extraction=dataclasses.replace(
            prod.extraction, n_rings=32, max_points_per_ring=1024,
            max_edges=1024, max_surfaces=16384))

    rng = np.random.default_rng(0)
    world = worldsim.make_world(rng, n_poles=50, extent=35.0)
    pipeline, gt = worldsim.run_mapping_drive(
        world, cfg, rng, n_scans=40, radius=8.0, with_imu=True,
        pipeline_kwargs=dict(loop_radius=6.0, loop_min_gap=10,
                             optimize_every=8),
        n_rings=32, n_az=1024, elev_deg=(2.0, -24.8))

    est = pipeline.trajectory
    n_kf = len(pipeline.keyframes)
    n_loop = len(pipeline.constraints) - (n_kf - 1)
    ate = ate_rmse(est, gt, align=False)
    per_kf = np.linalg.norm(est - gt, axis=-1)

    # Tracking must survive the whole loop with the IMU prior ...
    assert n_kf >= 30, n_kf
    # ... with at least one accepted loop closure ...
    assert n_loop >= 1, (n_kf, len(pipeline.constraints))
    # ... a metric trajectory (no NaN: ate_rmse of a NaN drive is NaN,
    # which fails both comparisons below) ...
    assert np.isfinite(ate), ate
    assert ate < 0.3, ate
    assert per_kf.max() < 0.5, per_kf.max()
    # ... and a finite, physically-sized joint gyro-bias estimate from
    # the LM + re-linearization back-end (parallel/imu_graph.py).
    assert pipeline.imu_bias is not None
    bg = np.asarray(pipeline.imu_bias[0])
    assert np.all(np.isfinite(bg)), bg
    assert np.abs(bg).max() < 0.05, bg
