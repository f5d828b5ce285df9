"""Full mapping pipeline: odometry front-end, keyframe store, radius
loop closure, pose-graph back-end, map assembly.

The reference stops at open-loop mapping (transform scans by
externally-supplied poses and concatenate, ``mapping/include/
lidar_feature_mapping/map.hpp:98-134``) — no loop closure, no global
optimization. This engine treats globally-consistent mapping as a
first-class workload (BASELINE.json configs 4-5): odometry poses seed a
keyframe graph, re-registration against revisited keyframes adds loop
constraints, and the distributed-capable pose-graph Gauss-Newton
(parallel/pose_graph.py) reconciles the trajectory before the map is
assembled.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import PipelineConfig
from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose, pose_delta_magnitudes
from lidar_feature_extraction_tpu.ops import gauss_newton as gn
from lidar_feature_extraction_tpu.ops import voxel_grid as vg
from lidar_feature_extraction_tpu.ops.downsample import voxel_downsample
from lidar_feature_extraction_tpu.ops.residuals import (
    edge_residuals, surface_residuals)
from lidar_feature_extraction_tpu.parallel.pose_graph import (
    Constraints, PoseGraph, optimize_pose_graph, optimize_pose_graph_cg)
from lidar_feature_extraction_tpu.pipeline.odometry import Odometry


class Keyframe(NamedTuple):
    pose: Pose
    edge_pts: jnp.ndarray    # sensor-frame features
    edge_valid: jnp.ndarray
    surf_pts: jnp.ndarray
    surf_valid: jnp.ndarray
    stamp: float


def relative_pose(a: Pose, b: Pose) -> Pose:
    return a.inverse().compose(b)


def constraint_info_from_hessian(hessian, q,
                                 eig_floor: float = 0.01,
                                 eig_cap: float = 100.0
                                 ) -> Optional[np.ndarray]:
    """Registration Hessian M^T A M -> normalized [6, 6] constraint
    information in the pose-graph residual tangent.

    The registration's tangent is (dtheta_right, dt_parent-frame)
    (ops/gauss_newton.py run_gauss_newton); the graph residual's
    translation tangent is local to the measured pose (pose_graph.py
    _perturb), so the translation block is conjugated by R(q) with q
    the registration result's rotation.

    Normalization: divide by the TRANSLATION block's max eigenvalue —
    the well-constrained translation axes then carry weight ~1, the
    (0, 1] semantics of the scalar constraint ``weight``. Normalizing
    by the FULL spectrum would be wrong: the rotation block scales
    with squared correspondence lever arms (~1e2-1e3 m^2 at LiDAR
    ranges), so max-eig normalization collapses translation stiffness
    to ~1e-3 and the graph's translation is left to whoever else has
    an opinion (r4 regression: the IMU factors then dragged z off by
    decimeters). The spectrum is clipped to [eig_floor, eig_cap]:
    the floor keeps fully-degenerate axes from making the graph
    singular, the cap keeps one rotation-stiff constraint from
    dominating the f32 normal equations. Returns None when the Hessian
    is unusable (empty registration)."""
    if hessian is None:
        return None
    h = np.asarray(hessian, np.float64)
    if not np.all(np.isfinite(h)) or np.trace(h) <= 0:
        return None
    r = np.asarray(quat.quat_to_matrix(q), np.float64)
    j = np.eye(6)
    j[3:, 3:] = r
    lam = j.T @ h @ j
    lam = 0.5 * (lam + lam.T)
    t_max = float(np.linalg.eigvalsh(lam[3:, 3:]).max())
    if not np.isfinite(t_max) or t_max <= 0:
        return None
    lam = lam / t_max
    w, v = np.linalg.eigh(lam)
    w = np.clip(w, eig_floor, eig_cap)
    lam = (v * w) @ v.T
    return lam.astype(np.float32)


class MappingPipeline:
    """Feed per-scan features; get an optimized keyframe trajectory and
    a globally-consistent feature map."""

    def __init__(self, cfg: PipelineConfig,
                 loop_radius: float = 5.0,
                 loop_min_gap: int = 20,
                 optimize_every: int = 10,
                 loop_inlier_threshold: float = 0.3,
                 loop_min_inlier_frac: float = 0.6,
                 loop_min_matches: int = 50,
                 loop_min_edge_matches: int = 20,
                 dense_solver_max_keyframes: int = 128,
                 estimate_imu_bias: bool = True,
                 imu_gyro_noise: float = 1.7e-4,
                 imu_accel_noise: float = 2.0e-3):
        self.cfg = cfg
        self.odometry = Odometry(cfg)
        self.keyframes: list[Keyframe] = []
        # (i, j, rel Pose, weight, info [6, 6] or None) per constraint.
        self.constraints: list[tuple] = []
        self.loop_radius = loop_radius
        self.loop_min_gap = loop_min_gap
        self.optimize_every = optimize_every
        # Loop-closure acceptance gate: a candidate registration must
        # CONVERGE (MAX_ITERATIONS is a failed registration here — the
        # reference's localization treats it as usable only because an
        # EKF gate sits behind it, subscriber.hpp:128-176; a pose graph
        # has no such second line of defense), keep >= min_matches
        # valid correspondences at the final pose, and have >=
        # min_inlier_frac of them within inlier_threshold meters.
        self.loop_inlier_threshold = loop_inlier_threshold
        self.loop_min_inlier_frac = loop_min_inlier_frac
        self.loop_min_matches = loop_min_matches
        self.loop_min_edge_matches = loop_min_edge_matches
        # Back-end bounds: above dense_solver_max_keyframes active
        # poses the matrix-free CG solver replaces the dense [6K, 6K]
        # one (O(M + K) per step instead of O((6K)^3)); above
        # cfg.mapping.max_keyframes the optimization runs over a
        # sliding window — older keyframes freeze at their optimized
        # poses (they still contribute to the assembled map), and
        # constraints bridging into the frozen region re-anchor on the
        # window's gauge-fixed first pose.
        self.dense_solver_max_keyframes = dense_solver_max_keyframes
        # Joint shared gyro-bias estimation in the IMU-aware back-end
        # (parallel/imu_graph.py); the recovered biases land in
        # self.imu_bias after each optimize. Keep this ON whenever IMU
        # factors are fed: their metric information (1/sigma^2, up to
        # 1e5) dominates the dimensionless chain constraints, so any
        # systematic IMU inconsistency — real sensor bias OR model
        # error — bends the graph unless the bias state absorbs it
        # (measured r4: 0.04 m vs 3.2 m ATE on the full IMU drive).
        self.estimate_imu_bias = estimate_imu_bias
        # Continuous-time IMU noise densities for the keyframe factors.
        # These are the TRUST MODEL of the back-end: the preintegration
        # covariance they produce becomes the factor information
        # (weights_from_covariance), which competes against the
        # weight-1 odometry chain. They must cover everything the
        # preintegration model does NOT capture — discretization /
        # zeroth-order-hold error on a dynamic platform, scale error,
        # mounting misalignment — not just datasheet sensor noise.
        # Under-stating them makes the joint bias estimator absorb
        # model error into a spurious bias and bend the trajectory
        # (measured r5: 0.017 rad/s phantom z-gyro bias, 0.36 m vs
        # 0.03 m ATE on a zero-bias drive at 20 m/s^2 platform
        # dynamics). LIO-SAM ships the same knobs (imuAccNoise /
        # imuGyrNoise) with deliberately conservative defaults.
        self.imu_gyro_noise = imu_gyro_noise
        self.imu_accel_noise = imu_accel_noise
        self.imu_bias: Optional[tuple] = None
        self._optimized: Optional[PoseGraph] = None
        self._kf_since_opt = 0
        # Frame bookkeeping: the odometry front-end runs in its own
        # (drifting) frame and is never rewound by the back-end. Raw
        # odometry poses per keyframe feed the chain constraints
        # (relative deltas are frame-invariant, so they stay valid after
        # the back-end rewrites keyframe poses — mixing an optimized
        # keyframe pose with a raw odometry pose would corrupt the
        # constraint, the LIO-SAM structure the reference's stubbed
        # imu_integration cites); ``_corr`` maps odometry frame -> map
        # frame so new keyframes and the loop radius search live in the
        # optimized frame.
        self._odom_poses: list[Pose] = []
        self._corr: Pose = Pose.identity()
        # IMU: raw samples buffered between keyframes; preintegrated
        # factor per keyframe interval (fusion/imu.py — the reference's
        # imu_integration package is an empty stub, SURVEY.md §2.6).
        self._imu_buffer: list = []
        self.imu_factors: list = []   # (i, j, ImuPreintegration)
        self._vels: Optional[np.ndarray] = None

    # ---- front end -------------------------------------------------

    def process_scan(self, edge_pts, edge_valid, surf_pts, surf_valid,
                     stamp: float = 0.0, imu_gyro=None, imu_accel=None,
                     imu_dts=None) -> Pose:
        """Odometry update + keyframe/loop bookkeeping. Returns the
        current (odometry-frame) pose estimate.

        ``imu_*``: raw IMU samples covering the window since the
        previous scan ([N, 3] gyro, [N, 3] accel, [N] intervals). When
        given they (a) seed the scan matcher with the IMU-predicted
        pose and (b) accumulate into a preintegrated factor between
        keyframes for the graph back-end."""
        if imu_gyro is not None:
            reg = self.odometry.update_with_imu(
                edge_pts, edge_valid, surf_pts, surf_valid,
                imu_gyro, imu_accel, imu_dts)
            self._imu_buffer.append((np.asarray(imu_gyro),
                                     np.asarray(imu_accel),
                                     np.asarray(imu_dts)))
        else:
            reg = self.odometry.update(edge_pts, edge_valid, surf_pts,
                                       surf_valid)
        return self.ingest_odometry_result(
            edge_pts, edge_valid, surf_pts, surf_valid,
            self.odometry.pose,
            hessian=None if reg is None else reg.hessian, stamp=stamp)

    def ingest_odometry_result(self, edge_pts, edge_valid, surf_pts,
                               surf_valid, odom_pose: Pose,
                               hessian=None, stamp: float = 0.0) -> Pose:
        """Keyframe/loop/back-end bookkeeping for an odometry result
        produced elsewhere — the seam the chunked front-end
        (pipeline/mapping_chunk.py) feeds after registering a whole
        scan block in one device dispatch."""
        map_pose = self._corr.compose(odom_pose)
        if self._should_add_keyframe(odom_pose):
            kf = Keyframe(pose=map_pose, edge_pts=edge_pts,
                          edge_valid=edge_valid, surf_pts=surf_pts,
                          surf_valid=surf_valid, stamp=stamp)
            self._add_keyframe(kf, odom_pose, hessian)
        return map_pose

    def _should_add_keyframe(self, odom_pose: Pose) -> bool:
        if not self.keyframes:
            return True
        m = self.cfg.mapping
        dt, dq = pose_delta_magnitudes(self._odom_poses[-1], odom_pose)
        return bool((dt >= m.keyframe_translation_threshold)
                    | (dq >= m.keyframe_rotation_threshold))

    def _add_keyframe(self, kf: Keyframe, odom_pose: Pose,
                      hessian=None) -> None:
        idx = len(self.keyframes)
        self.keyframes.append(kf)
        self._odom_poses.append(odom_pose)
        if idx > 0:
            rel = relative_pose(self._odom_poses[idx - 1], odom_pose)
            # Chain information: the triggering scan registration's
            # weighted Hessian (an anisotropy proxy for the inter-
            # keyframe odometry segment — a corridor-degenerate
            # stretch reports low stiffness along its blind axis).
            info = constraint_info_from_hessian(hessian, odom_pose.q)
            self.constraints.append((idx - 1, idx, rel, 1.0, info))
            if self._imu_buffer:
                from lidar_feature_extraction_tpu.fusion.imu import (
                    preintegrate)

                g = np.concatenate([b[0] for b in self._imu_buffer])
                a = np.concatenate([b[1] for b in self._imu_buffer])
                d = np.concatenate([b[2] for b in self._imu_buffer])
                pre = preintegrate(
                    jnp.asarray(g, jnp.float32),
                    jnp.asarray(a, jnp.float32),
                    jnp.asarray(d, jnp.float32),
                    jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                    gyro_noise=self.imu_gyro_noise,
                    accel_noise=self.imu_accel_noise)
                self.imu_factors.append((idx - 1, idx, pre))
        self._imu_buffer = []
        closure = self._try_loop_closure(idx)
        self._kf_since_opt += 1
        if closure or self._kf_since_opt >= self.optimize_every:
            self.optimize()
            self._kf_since_opt = 0

    # ---- loop closure ----------------------------------------------

    def _try_loop_closure(self, idx: int) -> bool:
        """Radius search over past keyframe positions; re-register the
        new keyframe's features against the matched keyframe's local
        map; accept on convergence."""
        if idx < self.loop_min_gap:
            return False
        kf = self.keyframes[idx]
        pos = np.asarray(kf.pose.t)
        candidates = [
            j for j in range(idx - self.loop_min_gap)
            if np.linalg.norm(np.asarray(self.keyframes[j].pose.t) - pos)
            < self.loop_radius
        ]
        if not candidates:
            return False
        j = min(candidates,
                key=lambda j: np.linalg.norm(
                    np.asarray(self.keyframes[j].pose.t) - pos))
        match = self._register_to_keyframe(kf, self.keyframes[j])
        if match is None:
            return False
        rel, quality, info = match
        self.constraints.append((j, idx, rel, quality, info))
        return True

    def _register_to_keyframe(
            self, kf: Keyframe,
            target: Keyframe) -> Optional[tuple[Pose, float]]:
        """GN-register kf's features against target's features (both in
        their sensor frames); returns (measured relative pose
        target->kf, quality weight in (0, 1]) or None on failure —
        non-convergence, correspondence starvation, or a low inlier
        fraction at the final pose all reject the candidate."""
        reg = self.cfg.registration
        em, sm = reg.edge_map, reg.surface_map
        dims = reg.odometry_grid_dims

        half_e = jnp.asarray(dims, jnp.float32) * em.voxel_size / 2.0
        half_s = jnp.asarray(dims, jnp.float32) * sm.voxel_size / 2.0
        edge_map = vg.build_voxel_grid(
            target.edge_pts, target.edge_valid, em.voxel_size,
            -half_e, dims, em.points_per_voxel)
        surf_map = vg.build_voxel_grid(
            target.surf_pts, target.surf_valid, sm.voxel_size,
            -half_s, dims, sm.points_per_voxel)

        surf_ds, surf_ds_valid = voxel_downsample(
            kf.surf_pts, kf.surf_valid, reg.surface_downsample_leaf,
            reg.max_surface_points)

        prior = relative_pose(target.pose, kf.pose)

        # Coarse-to-fine pyramid: the prior between a loop pair carries
        # the WHOLE accumulated odometry drift (meters after a long
        # loop), which exceeds the fine grids' 3x3x3-voxel candidate
        # reach — without these stages real closures are rejected
        # exactly when they matter most. Each stage registers against
        # scaled-voxel grids (4x then 2x: candidate reach ±6/±3 edge
        # voxels) to pull the pose into the next basin; the final fine
        # registration below still gates acceptance.
        for scale in (4.0, 2.0):
            coarse_e = vg.build_voxel_grid(
                target.edge_pts, target.edge_valid,
                scale * em.voxel_size, -scale * half_e, dims,
                em.points_per_voxel)
            coarse_s = vg.build_voxel_grid(
                target.surf_pts, target.surf_valid,
                scale * sm.voxel_size, -scale * half_s, dims,
                sm.points_per_voxel)

            def coarse_problem_fn(p: Pose, ce=coarse_e,
                                  cs=coarse_s) -> gn.Problem:
                eb = edge_residuals(ce, kf.edge_pts, kf.edge_valid, p,
                                    reg.n_neighbors)
                sb = surface_residuals(cs, surf_ds, surf_ds_valid, p,
                                       reg.n_neighbors)
                return gn.make_problem([eb, sb])

            coarse = gn.run_gauss_newton(
                coarse_problem_fn, prior,
                max_iterations=reg.max_iterations,
                convergence_tol=reg.convergence_tol, huber_k=reg.huber_k,
                degeneracy_threshold=reg.degeneracy_threshold,
                abort_on_increase=False)
            if int(coarse.status) in (gn.CONVERGED, gn.MAX_ITERATIONS):
                prior = coarse.pose

        def problem_fn(p: Pose) -> gn.Problem:
            eb = edge_residuals(edge_map, kf.edge_pts, kf.edge_valid, p,
                                reg.n_neighbors)
            sb = surface_residuals(surf_map, surf_ds, surf_ds_valid, p,
                                   reg.n_neighbors)
            return gn.make_problem([eb, sb])

        # Error-increase aborts off here too: the inlier-fraction gate
        # below (not the online tracker's abort heuristics) is the
        # acceptance authority for loop candidates.
        result = gn.run_gauss_newton(
            problem_fn, prior, max_iterations=reg.max_iterations,
            convergence_tol=reg.convergence_tol, huber_k=reg.huber_k,
            degeneracy_threshold=reg.degeneracy_threshold,
            abort_on_increase=False)
        if int(result.status) != gn.CONVERGED:
            return None

        # Post-fit fitness gate at the FINAL pose: how many
        # correspondences survive, and what fraction of them lie within
        # the inlier radius. A wrong-but-converged registration (aliased
        # geometry) fails here; a right one on these feature densities
        # has inlier fractions near 1. The gate is evaluated PER
        # FEATURE CLASS: a single dominant ground plane aligns with any
        # other ground plane (surfaces only constrain z/roll/pitch), so
        # surface inliers alone cannot certify a closure — the EDGE
        # correspondences, which pin x/y/yaw, must independently agree.
        eb = edge_residuals(edge_map, kf.edge_pts, kf.edge_valid,
                            result.pose, reg.n_neighbors)
        sb = surface_residuals(surf_map, surf_ds, surf_ds_valid,
                               result.pose, reg.n_neighbors)
        stats = []
        for block, dist_scale in ((eb, 2.0), (sb, 1.0)):
            # Edge residual = (p-p1)x(p-p2) with |p2-p1| = 2 -> its
            # norm is 2x the point-line distance; surface residual is
            # the point-plane distance itself.
            valid = np.asarray(block.valid)
            err = np.linalg.norm(np.asarray(block.residual),
                                 axis=-1) / dist_scale
            nv = int(valid.sum())
            inl = float((valid & (err < self.loop_inlier_threshold)
                         ).sum()) / max(nv, 1)
            stats.append((nv, inl))
        (n_edge, inl_edge), (n_surf, inl_surf) = stats
        n_valid = n_edge + n_surf
        if n_valid < self.loop_min_matches:
            return None
        if n_edge < self.loop_min_edge_matches \
                or inl_edge < self.loop_min_inlier_frac:
            return None
        inlier_frac = (n_edge * inl_edge + n_surf * inl_surf) / n_valid
        if inlier_frac < self.loop_min_inlier_frac:
            return None
        # Constraint weight = inlier fraction: a marginal closure never
        # outweighs the odometry chain (weight 1.0); the pose-graph
        # robust kernel (parallel/pose_graph.py) handles anything that
        # still slips through. The 6x6 information carries the
        # registration's anisotropy (e.g. a corridor closure that pins
        # the cross-track axis but not the along-track one).
        info = constraint_info_from_hessian(result.hessian,
                                            result.pose.q)
        return result.pose, inlier_frac, info

    # ---- back end --------------------------------------------------

    @staticmethod
    def _bucket(n: int, minimum: int = 8) -> int:
        """Next power-of-two shape bucket >= n. The back-end pads the
        active pose count and both factor arrays to buckets so the
        jitted graph programs are reused as the map grows — without
        this every optimize() call at a new keyframe count compiles a
        fresh XLA program, which dominated full-mapping wall time."""
        b = minimum
        while b < n:
            b *= 2
        return b

    @staticmethod
    def _pad_constraints(cons: Constraints, m_to: int) -> Constraints:
        """Grow a Constraints batch to ``m_to`` lanes with weight-0
        padding (i=0, j=1, identity measurements: inert by the masked-
        lane contract, pinned by
        tests/test_parallel.py::test_zero_weight_lanes_are_inert)."""
        m = cons.i.shape[0]
        pad = m_to - m
        if pad <= 0:
            return cons
        ident = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
        return Constraints(
            i=jnp.concatenate([cons.i, jnp.zeros(pad, jnp.int32)]),
            j=jnp.concatenate([cons.j, jnp.ones(pad, jnp.int32)]),
            z_q=jnp.concatenate([cons.z_q,
                                 jnp.tile(ident[None], (pad, 1))]),
            z_t=jnp.concatenate([cons.z_t,
                                 jnp.zeros((pad, 3), jnp.float32)]),
            weight=jnp.concatenate([cons.weight,
                                    jnp.zeros(pad, jnp.float32)]),
            info=None if cons.info is None else jnp.concatenate(
                [cons.info, jnp.tile(jnp.eye(6, dtype=jnp.float32)[None],
                                     (pad, 1, 1))]))

    @staticmethod
    def _gnc_schedule(robust_delta, n_iterations):
        """[(delta, n_iterations), ...] for graduated non-convexity."""
        if robust_delta is None:
            return [(None, n_iterations)]
        n = max(n_iterations // 3, 1)
        return [(16.0 * robust_delta, n), (4.0 * robust_delta, n),
                (robust_delta, max(n_iterations - 2 * n, 1))]

    def optimize(self, n_iterations: int = 10,
                 robust_delta: float | None = 0.5) -> None:
        """Pose-graph Gauss-Newton over the active keyframe window
        (chain + loop constraints), with a Geman-McClure kernel
        (``robust_delta``) so any outlier constraint that survived the
        acceptance gate is down-weighted rather than trusted. The
        kernel is applied with a graduated-non-convexity schedule
        (delta 16x -> 4x -> 1x): a GENUINE loop closure's residual at
        the unoptimized poses is the whole accumulated drift, and
        starting at the final delta would redescend its weight to ~0
        before the graph ever moves — the classic robust-IRLS local
        minimum.

        Bounds (see __init__): only the last ``mapping.max_keyframes``
        poses optimize (older ones freeze; bridging constraints
        re-anchor on the window's first, gauge-fixed pose); the
        matrix-free CG solver takes over past
        ``dense_solver_max_keyframes``. Single-device here; the sharded
        variant is
        parallel/pose_graph.make_distributed_pose_graph_optimizer."""
        k = len(self.keyframes)
        if k < 2 or not self.constraints:
            return
        offset = max(0, k - self.cfg.mapping.max_keyframes)
        ka = k - offset
        if ka < 2:
            return
        active = self.keyframes[offset:]
        poses_q = jnp.stack([kf.pose.q for kf in active])
        poses_t = jnp.stack([kf.pose.t for kf in active])
        # Shape buckets: pad poses (identity, untouched by any factor;
        # only the Levenberg damping sees them, so their update is
        # exactly zero) and both factor batches (weight-0 lanes) to
        # powers of two, so the jitted graph programs are REUSED as the
        # map grows instead of recompiling at every new keyframe count
        # (see _bucket).
        kpad = self._bucket(ka)
        if kpad > ka:
            poses_q = jnp.concatenate([poses_q, jnp.tile(
                jnp.asarray([[1.0, 0, 0, 0]], jnp.float32),
                (kpad - ka, 1))])
            poses_t = jnp.concatenate(
                [poses_t, jnp.zeros((kpad - ka, 3), jnp.float32)])

        eye = np.eye(6, dtype=np.float32)
        ci, cj, czq, czt, cw, cinfo = [], [], [], [], [], []
        anchor_inv = active[0].pose.inverse()
        for (i, j, rel, w, info) in self.constraints:
            if j < offset:
                continue          # entirely frozen
            if i < offset:
                # Bridge into the frozen region: the frozen endpoint's
                # pose is a constant, so the constraint becomes a
                # measurement of pose j relative to the (gauge-fixed)
                # window anchor: z' = T_anchor^-1 T_i z.
                z = anchor_inv.compose(
                    self.keyframes[i].pose.compose(rel))
                i2, j2 = 0, j - offset
            else:
                z, i2, j2 = rel, i - offset, j - offset
            if i2 == j2:
                continue
            ci.append(i2)
            cj.append(j2)
            czq.append(z.q)
            czt.append(z.t)
            cw.append(w)
            cinfo.append(eye if info is None else info)
        if not ci:
            return
        cons = self._pad_constraints(
            Constraints(
                i=jnp.asarray(ci, jnp.int32),
                j=jnp.asarray(cj, jnp.int32),
                z_q=jnp.stack(czq), z_t=jnp.stack(czt),
                weight=jnp.asarray(cw, jnp.float32),
                info=jnp.asarray(np.stack(cinfo))),
            self._bucket(len(ci)))

        imu_window = [(a - offset, b - offset, pre)
                      for a, b, pre in self.imu_factors if a >= offset]
        if imu_window:
            from lidar_feature_extraction_tpu.parallel.imu_graph import (
                ImuFactors, ImuGraph, optimize_imu_graph,
                weights_from_covariance)

            pres = [f[2] for f in imu_window]
            cov = jnp.stack([p.cov for p in pres])
            w_rot, w_vel, w_pos = weights_from_covariance(cov)
            mi = len(pres)
            ipad = self._bucket(mi) - mi

            def _pad(x, fill=0.0):
                x = jnp.asarray(x)
                if ipad == 0:
                    return x
                return jnp.concatenate([x, jnp.full(
                    (ipad,) + x.shape[1:], fill, x.dtype)])

            imu = ImuFactors(
                i=_pad(jnp.asarray([f[0] for f in imu_window],
                                   jnp.int32)),
                j=_pad(jnp.asarray([f[1] for f in imu_window],
                                   jnp.int32), 1),
                dq=jnp.concatenate([
                    jnp.stack([p.dq for p in pres]),
                    jnp.tile(jnp.asarray([[1.0, 0, 0, 0]], jnp.float32),
                             (ipad, 1))]),
                dv=_pad(jnp.stack([p.dv for p in pres])),
                dp=_pad(jnp.stack([p.dp for p in pres])),
                dt=_pad(jnp.stack([p.dt for p in pres])),
                w_rot=_pad(w_rot), w_vel=_pad(w_vel), w_pos=_pad(w_pos),
                weight=_pad(jnp.ones(mi, jnp.float32)),
                dq_dbg=_pad(jnp.stack([p.dq_dbg for p in pres])),
                dv_dbg=_pad(jnp.stack([p.dv_dbg for p in pres])),
                dv_dba=_pad(jnp.stack([p.dv_dba for p in pres])),
                dp_dbg=_pad(jnp.stack([p.dp_dbg for p in pres])),
                dp_dba=_pad(jnp.stack([p.dp_dba for p in pres])))
            # Initial velocities: CENTRAL differences of keyframe
            # positions over their stamps. Central, not forward: the
            # forward difference is the chord velocity, which lacks
            # the trajectory's curvature term — on a turning platform
            # that makes every IMU position factor inconsistent by
            # ~0.5*a_lateral*dt^2 (measured 0.12 m/factor at 8 m/s on
            # the r4 eval circle), and with metric IMU weights the
            # graph diverges from that seed instead of correcting it.
            # Central differences are tangent velocities (2nd order).
            t_np = np.asarray(poses_t, np.float64)[:ka]
            stamps = np.asarray([kf.stamp for kf in active], np.float64)
            stamps = np.maximum.accumulate(stamps + 1e-9 * np.arange(
                len(stamps)))   # strictly increasing for np.gradient
            v = np.gradient(t_np, stamps, axis=0)
            vels = jnp.asarray(np.concatenate(
                [v, np.zeros((kpad - ka, 3))]), jnp.float32)
            zero3 = jnp.zeros(3, jnp.float32)
            # Gyro bias only: accel bias stays at the zero
            # linearization point (weakly observable on short planar
            # segments — see parallel/imu_graph.py ImuGraph).
            graph9 = ImuGraph(
                poses_q=poses_q, poses_t=poses_t, vels=vels,
                bg=zero3 if self.estimate_imu_bias else None,
                ba=None)
            for delta, n_it in self._gnc_schedule(robust_delta,
                                                  n_iterations):
                graph9 = optimize_imu_graph(graph9, cons, imu,
                                            n_iterations=n_it,
                                            robust_delta=delta)
            out = PoseGraph(poses_q=graph9.poses_q[:ka],
                            poses_t=graph9.poses_t[:ka])
            self._vels = np.asarray(graph9.vels)[:ka]
            if graph9.bg is not None:
                self.imu_bias = (
                    np.asarray(graph9.bg),
                    None if graph9.ba is None else np.asarray(graph9.ba))
        else:
            solver = (optimize_pose_graph_cg
                      if ka > self.dense_solver_max_keyframes
                      else optimize_pose_graph)
            graph = PoseGraph(poses_q=poses_q, poses_t=poses_t)
            for delta, n_it in self._gnc_schedule(robust_delta,
                                                  n_iterations):
                graph = solver(graph, cons, n_iterations=n_it,
                               robust_delta=delta)
            out = PoseGraph(poses_q=graph.poses_q[:ka],
                            poses_t=graph.poses_t[:ka])
        self._optimized = out
        # Write back optimized poses (active window only; frozen
        # keyframes keep the poses of the optimization they last
        # participated in).
        self.keyframes = self.keyframes[:offset] + [
            kf._replace(pose=Pose(out.poses_q[n], out.poses_t[n]))
            for n, kf in enumerate(active)]
        # Re-anchor the odometry->map correction on the newest keyframe
        # so subsequent scans (still tracked in the odometry frame)
        # enter the map in the optimized frame.
        self._corr = self.keyframes[-1].pose.compose(
            self._odom_poses[-1].inverse())

    # ---- checkpoint / resume ----------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Serialize the FULL pipeline state — odometry map + window,
        keyframes, constraints (with 6x6 info), IMU factors, frame
        correction — so a mapping run can resume mid-sequence
        (SURVEY.md §5: the reference persists only the final map PCD,
        map.hpp:135-148; pose/filter state is lost there)."""
        from lidar_feature_extraction_tpu.utils import checkpoint as ckpt

        kf = self.keyframes
        states = dict(
            odometry_state=self.odometry.state,
            odometry_velocity=self.odometry.velocity,
            corr=(self._corr.q, self._corr.t),
        )
        meta = dict(
            n_keyframes=len(kf),
            n_constraints=len(self.constraints),
            n_imu_factors=len(self.imu_factors),
            n_imu_buffer=len(self._imu_buffer),
            has_last_pose=self.odometry._last_pose is not None,
            kf_since_opt=self._kf_since_opt,
            # Stamps ride the JSON manifest: they are Python floats and
            # must not be squeezed through the f32 array path.
            stamps=[float(f.stamp) for f in kf],
        )
        if self.odometry._last_pose is not None:
            states["last_pose"] = (self.odometry._last_pose.q,
                                   self.odometry._last_pose.t)
        if kf:
            states["keyframes"] = dict(
                q=np.stack([np.asarray(f.pose.q) for f in kf]),
                t=np.stack([np.asarray(f.pose.t) for f in kf]),
                edge_pts=np.stack([np.asarray(f.edge_pts) for f in kf]),
                edge_valid=np.stack(
                    [np.asarray(f.edge_valid) for f in kf]),
                surf_pts=np.stack([np.asarray(f.surf_pts) for f in kf]),
                surf_valid=np.stack(
                    [np.asarray(f.surf_valid) for f in kf]),
                odom_q=np.stack(
                    [np.asarray(p.q) for p in self._odom_poses]),
                odom_t=np.stack(
                    [np.asarray(p.t) for p in self._odom_poses]))
        if self.constraints:
            eye = np.eye(6, dtype=np.float32)
            states["constraints"] = dict(
                i=np.asarray([c[0] for c in self.constraints], np.int32),
                j=np.asarray([c[1] for c in self.constraints], np.int32),
                z_q=np.stack([np.asarray(c[2].q)
                              for c in self.constraints]),
                z_t=np.stack([np.asarray(c[2].t)
                              for c in self.constraints]),
                w=np.asarray([c[3] for c in self.constraints],
                             np.float32),
                info=np.stack([eye if c[4] is None else c[4]
                               for c in self.constraints]),
                has_info=np.asarray(
                    [c[4] is not None for c in self.constraints]))
        if self.imu_factors:
            import jax

            pres = [f[2] for f in self.imu_factors]
            states["imu_factors"] = dict(
                i=np.asarray([f[0] for f in self.imu_factors], np.int32),
                j=np.asarray([f[1] for f in self.imu_factors], np.int32),
                pre=jax.tree_util.tree_map(
                    lambda *xs: np.stack([np.asarray(x) for x in xs]),
                    *pres))
        if self._imu_buffer:
            states["imu_buffer"] = dict(
                gyro=np.concatenate([b[0] for b in self._imu_buffer]),
                accel=np.concatenate([b[1] for b in self._imu_buffer]),
                dts=np.concatenate([b[2] for b in self._imu_buffer]))
        ckpt.save_checkpoint(path, _meta=meta, **states)

    @classmethod
    def restore(cls, path: str, cfg: PipelineConfig,
                **pipeline_kwargs) -> "MappingPipeline":
        """Rebuild a pipeline from ``save_checkpoint`` output; feeding
        the remaining scans reproduces the unbroken run's trajectory
        (tests/test_slam.py::test_mapping_checkpoint_resume)."""
        import jax

        from lidar_feature_extraction_tpu.fusion.imu import (
            ImuPreintegration)
        from lidar_feature_extraction_tpu.utils import checkpoint as ckpt

        meta = ckpt.load_meta(path)
        p = cls(cfg, **pipeline_kwargs)
        k = int(meta["n_keyframes"])
        m = int(meta["n_constraints"])
        mi = int(meta["n_imu_factors"])
        nb = int(meta["n_imu_buffer"])
        ex = cfg.extraction

        templates = dict(
            odometry_state=p.odometry.state,
            odometry_velocity=p.odometry.velocity,
            corr=(jnp.zeros(4), jnp.zeros(3)),
        )
        if meta["has_last_pose"]:
            templates["last_pose"] = (jnp.zeros(4), jnp.zeros(3))
        if k:
            templates["keyframes"] = dict(
                q=jnp.zeros((k, 4)), t=jnp.zeros((k, 3)),
                edge_pts=jnp.zeros((k, ex.max_edges, 3)),
                edge_valid=jnp.zeros((k, ex.max_edges), bool),
                surf_pts=jnp.zeros((k, ex.max_surfaces, 3)),
                surf_valid=jnp.zeros((k, ex.max_surfaces), bool),
                odom_q=jnp.zeros((k, 4)), odom_t=jnp.zeros((k, 3)))
        if m:
            templates["constraints"] = dict(
                i=jnp.zeros((m,), jnp.int32), j=jnp.zeros((m,), jnp.int32),
                z_q=jnp.zeros((m, 4)), z_t=jnp.zeros((m, 3)),
                w=jnp.zeros((m,)), info=jnp.zeros((m, 6, 6)),
                has_info=jnp.zeros((m,), bool))
        if mi:
            zero_pre = ImuPreintegration(
                dq=jnp.zeros((mi, 4)), dv=jnp.zeros((mi, 3)),
                dp=jnp.zeros((mi, 3)), dt=jnp.zeros((mi,)),
                dq_dbg=jnp.zeros((mi, 3, 3)), dv_dbg=jnp.zeros((mi, 3, 3)),
                dv_dba=jnp.zeros((mi, 3, 3)), dp_dbg=jnp.zeros((mi, 3, 3)),
                dp_dba=jnp.zeros((mi, 3, 3)), cov=jnp.zeros((mi, 9, 9)))
            templates["imu_factors"] = dict(
                i=jnp.zeros((mi,), jnp.int32),
                j=jnp.zeros((mi,), jnp.int32), pre=zero_pre)
        if nb:
            # Buffered raw samples are stored concatenated; the count
            # of source windows is immaterial (they are concatenated
            # again at the next keyframe) but the row count is not
            # known here — load lazily below.
            pass

        data = ckpt.load_checkpoint(path, **{
            n: t for n, t in templates.items()})
        p.odometry.state = data["odometry_state"]
        p.odometry.velocity = data["odometry_velocity"]
        p._corr = Pose(jnp.asarray(data["corr"][0], jnp.float32),
                       jnp.asarray(data["corr"][1], jnp.float32))
        if meta["has_last_pose"]:
            p.odometry._last_pose = Pose(
                jnp.asarray(data["last_pose"][0], jnp.float32),
                jnp.asarray(data["last_pose"][1], jnp.float32))
        p._kf_since_opt = int(meta["kf_since_opt"])
        if k:
            kfd = data["keyframes"]
            stamps = meta["stamps"]
            p.keyframes = [
                Keyframe(pose=Pose(kfd["q"][n], kfd["t"][n]),
                         edge_pts=kfd["edge_pts"][n],
                         edge_valid=kfd["edge_valid"][n],
                         surf_pts=kfd["surf_pts"][n],
                         surf_valid=kfd["surf_valid"][n],
                         stamp=float(stamps[n]))
                for n in range(k)]
            p._odom_poses = [Pose(kfd["odom_q"][n], kfd["odom_t"][n])
                             for n in range(k)]
        if m:
            cd = data["constraints"]
            p.constraints = [
                (int(cd["i"][n]), int(cd["j"][n]),
                 Pose(cd["z_q"][n], cd["z_t"][n]), float(cd["w"][n]),
                 np.asarray(cd["info"][n], np.float32)
                 if bool(cd["has_info"][n]) else None)
                for n in range(m)]
        if mi:
            im = data["imu_factors"]
            p.imu_factors = [
                (int(im["i"][n]), int(im["j"][n]),
                 jax.tree_util.tree_map(lambda x, n=n: x[n], im["pre"]))
                for n in range(mi)]
        if nb:
            raw = np.load(path)
            p._imu_buffer = [(raw["imu_buffer/0"], raw["imu_buffer/1"],
                              raw["imu_buffer/2"])]
        return p

    # ---- outputs ---------------------------------------------------

    @property
    def trajectory(self) -> np.ndarray:
        return np.stack([np.asarray(kf.pose.t) for kf in self.keyframes]) \
            if self.keyframes else np.zeros((0, 3))

    def assemble_map(self):
        """(edge_points, surf_points) in the map frame from optimized
        keyframe poses (the analogue of Map::TransformAdd over the
        whole run, now globally consistent)."""
        edges, surfs = [], []
        for kf in self.keyframes:
            e = np.asarray(kf.pose.apply(kf.edge_pts))
            edges.append(e[np.asarray(kf.edge_valid)])
            s = np.asarray(kf.pose.apply(kf.surf_pts))
            surfs.append(s[np.asarray(kf.surf_valid)])
        if not edges:
            return np.zeros((0, 3)), np.zeros((0, 3))
        return np.concatenate(edges), np.concatenate(surfs)

    def save_maps(self, edge_path: str, surf_path: str) -> None:
        from lidar_feature_extraction_tpu.io import pcd

        e, s = self.assemble_map()
        pcd.save_pcd(edge_path, e)
        pcd.save_pcd(surf_path, s)
