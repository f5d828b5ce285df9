"""Host-side replay drivers: the analogue of the reference's ROS
process graph (SURVEY.md §1 dataflow + §3.1/§3.2 closed loop).

The ROS topic pipeline (converter -> extraction -> localization -> EKF
-> feedback prior) collapses into: one jitted device step per scan plus
a small host driver that owns the EKF clock and the prior feedback —
the mutex/queue machinery (StampSortedObjects, AgedMessageQueue)
disappears because replay is single-threaded and the device step is
synchronous per scan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import PipelineConfig
from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.core.scan import build_range_image
from lidar_feature_extraction_tpu.fusion import ekf as ekf_mod
from lidar_feature_extraction_tpu.pipeline.localization import (FeatureMaps,
                                                                localize_scan)


class ScanResult(NamedTuple):
    fused_pose: Pose          # EKF-fused SE(3) pose
    measured_pose: Pose       # raw scan-matcher pose
    gn_status: int
    gn_iterations: int


def _pose_to_xyyaw(pose: Pose):
    return (float(pose.t[0]), float(pose.t[1]),
            float(quat.quat_yaw(pose.q)))


class FusedLocalizationPipeline:
    """Scan-to-map localization + time-delay EKF, closed loop.

    Mirrors the reference's subscriber + ekf_localizer pair:
    - the EKF prior seeds the Gauss-Newton registration
      (``LocalizationSubscriber::PoseUpdateCallback`` pulling
      prior_poses_, subscriber.hpp:128-176);
    - the registered pose feeds back as an EKF pose measurement with the
      hardcoded output covariance diag(1, 1, 1, .1, .1, .1)
      (subscriber.hpp:158-165);
    - z / roll / pitch ride the three scalar filters
      (ekf_localizer.cpp:209-232).
    """

    def __init__(self, maps: FeatureMaps, cfg: PipelineConfig,
                 initial_pose: Optional[Pose] = None,
                 dtype=jnp.float32):
        self.maps = maps
        self.cfg = cfg
        self.dtype = dtype
        self.ekf_dt = 1.0 / cfg.ekf.predict_frequency
        x0 = jnp.zeros(6, dtype)
        if initial_pose is not None:
            x, y, yaw = _pose_to_xyyaw(initial_pose)
            x0 = x0.at[0].set(x).at[1].set(y).at[2].set(yaw)
        self.ekf = ekf_mod.init_ekf(cfg.ekf, x0=x0, dtype=dtype)
        self.z_filter = ekf_mod.Filter1D.create(dtype=dtype)
        self.roll_filter = ekf_mod.Filter1D.create(dtype=dtype)
        self.pitch_filter = ekf_mod.Filter1D.create(dtype=dtype)
        self.clock: Optional[float] = None
        self._step = jax.jit(
            lambda m, im, p: localize_scan(m, im, p, cfg))
        # Measurement covariance: reference hardcodes the localization
        # output covariance (subscriber.hpp:158-165) -> pose R rows
        # (x, y, yaw) scaled by smoothing steps (pose_measurement.cpp:
        # 47-55).
        self.pose_r = jnp.diag(jnp.asarray([1.0, 1.0, 0.1], dtype)) \
            * cfg.ekf.pose_smoothing_steps
        # Twist measurement covariance (vx, wz): vehicle-odometry-grade
        # noise, scaled by smoothing steps like the pose R
        # (twist_measurement.cpp:70-110). Without twist input the EKF
        # must infer velocity through the huge hardcoded pose R above
        # and its prior lags a fast platform — the reference's launch
        # graph always wires /twist (localization.launch.py:108-185).
        self.twist_r = jnp.diag(jnp.asarray([0.04, 0.01], dtype)) \
            * cfg.ekf.twist_smoothing_steps

    def _ekf_prior(self) -> Pose:
        pose2d, _, _ = ekf_mod.current_pose_twist(self.ekf)
        x, y, yaw = (float(pose2d[0]), float(pose2d[1]), float(pose2d[2]))
        roll = float(self.roll_filter.x)
        pitch = float(self.pitch_filter.x)
        z = float(self.z_filter.x)
        q = quat.rpy_to_quat(jnp.asarray(roll, self.dtype),
                             jnp.asarray(pitch, self.dtype),
                             jnp.asarray(yaw, self.dtype))
        return Pose(q=q.astype(self.dtype),
                    t=jnp.asarray([x, y, z], self.dtype))

    def process_scan(self, xyz: np.ndarray, ring: np.ndarray,
                     stamp: float,
                     twist: Optional[tuple] = None) -> ScanResult:
        """One scan through the closed loop. ``twist`` optionally feeds
        a (vx, wz) vehicle-odometry measurement for the elapsed
        interval — the reference's /twist input (SURVEY.md §1
        topology); without it the EKF learns velocity only through the
        weak hardcoded pose covariance and its prior lags."""
        ex = self.cfg.extraction
        n = ex.n_rings * ex.max_points_per_ring
        pts = np.zeros((n, 3), np.float32)
        rng_ids = np.zeros(n, np.int32)
        valid = np.zeros(n, bool)
        m = min(len(xyz), n)
        pts[:m] = xyz[:m]
        rng_ids[:m] = ring[:m]
        valid[:m] = True
        image = build_range_image(
            jnp.asarray(pts), jnp.asarray(rng_ids), jnp.asarray(valid),
            ex.n_rings, ex.max_points_per_ring,
            min_points_per_ring=ex.padding + 1)

        # EKF clock: run predict ticks up to the scan stamp (the
        # reference's 50 Hz timerCallback).
        if self.clock is None:
            self.clock = stamp
        while self.clock < stamp:
            self.ekf = ekf_mod.predict(self.ekf, self.ekf_dt, self.cfg.ekf)
            self.clock += self.ekf_dt

        # Drain the twist queue (timerCallback order: predict, then
        # measurements, ekf_localizer.cpp:176-233).
        if twist is not None:
            y = jnp.asarray(twist, self.dtype)
            self.ekf = ekf_mod.update_twist(self.ekf, y, self.twist_r,
                                            jnp.asarray(0), self.cfg.ekf)

        prior = self._ekf_prior()
        result, _feats = self._step(self.maps, image, prior)

        # Feed the measurement back (delay ~ 0 in synchronous replay).
        mq, mt = result.pose.q, result.pose.t
        yaw = quat.quat_yaw(mq)
        y = jnp.stack([mt[0], mt[1], yaw]).astype(self.dtype)
        self.ekf = ekf_mod.update_pose(self.ekf, y, self.pose_r,
                                       jnp.asarray(0), self.cfg.ekf)
        # z / roll / pitch scalar filters (obs stddev 1.0 like the
        # reference's z/roll/pitch covariance .1 -> stddev sqrt(.1)).
        rpy_roll = jnp.arctan2(
            2 * (mq[0] * mq[1] + mq[2] * mq[3]),
            1 - 2 * (mq[1] ** 2 + mq[2] ** 2))
        rpy_pitch = jnp.arcsin(
            jnp.clip(2 * (mq[0] * mq[2] - mq[3] * mq[1]), -1, 1))
        dt = jnp.asarray(self.ekf_dt, self.dtype)
        std = jnp.asarray(np.sqrt(0.1), self.dtype)
        self.z_filter = ekf_mod.filter1d_update(self.z_filter, mt[2], std, dt)
        self.roll_filter = ekf_mod.filter1d_update(
            self.roll_filter, rpy_roll, std, dt)
        self.pitch_filter = ekf_mod.filter1d_update(
            self.pitch_filter, rpy_pitch, std, dt)

        fused = self._ekf_prior()
        return ScanResult(fused_pose=fused,
                          measured_pose=Pose(mq, mt),
                          gn_status=int(result.status),
                          gn_iterations=int(result.iterations))


def run_kitti_localization(sequence_dir: str, maps: FeatureMaps,
                           cfg: PipelineConfig, limit: int | None = None,
                           scan_period: float = 0.1):
    """Replay a KITTI velodyne sequence against pre-built maps.

    Returns [N, 3] fused positions (BASELINE config 3)."""
    from lidar_feature_extraction_tpu.io import kitti

    pipeline = FusedLocalizationPipeline(maps, cfg)
    out = []
    for i, scan in enumerate(kitti.iter_scans(sequence_dir, limit)):
        ring = kitti.estimate_rings(scan[:, :3], cfg.extraction.n_rings)
        res = pipeline.process_scan(scan[:, :3], ring, i * scan_period)
        out.append(np.asarray(res.fused_pose.t))
    return np.stack(out)
