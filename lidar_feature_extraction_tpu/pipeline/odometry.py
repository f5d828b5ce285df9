"""Scan-to-scan odometry: the equivalent of the reference's
library-only odometry path (``localization/include/
lidar_feature_localization/odometry.hpp:43-73``, ``pose_updater.hpp:
44-71``, ``recent_scans.hpp:56-87``; the binary is never built there,
SURVEY.md §2.2).

Design: a rolling window of the last N transformed feature scans lives
in one fixed-shape device ring buffer [N, max_pts, 3] + masks. Each new
scan registers against the merged window (voxel-hash maps rebuilt on
device per step — the reference likewise rebuilds KD-trees of the merged
recent scans every update, recent_scans.hpp:74) and is then inserted at
its estimated pose.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import PipelineConfig
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.fusion import imu as imu_mod
from lidar_feature_extraction_tpu.ops import gauss_newton as gn
from lidar_feature_extraction_tpu.ops.downsample import voxel_downsample
from lidar_feature_extraction_tpu.ops.residuals import (edge_residuals,
                                                        surface_residuals)
from lidar_feature_extraction_tpu.ops import voxel_grid as vg


class OdometryState(NamedTuple):
    """Rolling window of transformed feature scans + current pose."""

    edge_window: jnp.ndarray    # [W, E, 3] map-frame edge points
    edge_mask: jnp.ndarray      # [W, E]
    surf_window: jnp.ndarray    # [W, S, 3]
    surf_mask: jnp.ndarray      # [W, S]
    slot: jnp.ndarray           # scalar int32 next write slot (ring)
    n_scans: jnp.ndarray        # scalar int32 total scans inserted
    pose_q: jnp.ndarray
    pose_t: jnp.ndarray


def init_odometry(cfg: PipelineConfig, dtype=jnp.float32) -> OdometryState:
    w = cfg.mapping.recent_scans_window
    e = cfg.extraction.max_edges
    s = cfg.extraction.max_surfaces
    return OdometryState(
        edge_window=jnp.zeros((w, e, 3), dtype),
        edge_mask=jnp.zeros((w, e), bool),
        surf_window=jnp.zeros((w, s, 3), dtype),
        surf_mask=jnp.zeros((w, s), bool),
        slot=jnp.zeros((), jnp.int32),
        n_scans=jnp.zeros((), jnp.int32),
        pose_q=jnp.array([1.0, 0, 0, 0], dtype),
        pose_t=jnp.zeros(3, dtype))


@partial(jax.jit, static_argnames=("cfg",))
def odometry_step(state: OdometryState, edge_pts, edge_valid, surf_pts,
                  surf_valid, cfg: PipelineConfig, prior_q=None,
                  prior_t=None):
    """One odometry update (Odometry::Update, odometry.hpp:52-64):
    register the scan's features against the merged recent window,
    then insert the transformed scan at the new pose. The first scan
    initializes the window without registration.

    ``prior_q``/``prior_t`` override the Gauss-Newton starting pose
    (default: the previous pose, the reference's constant-position
    prior). The IMU-aided path passes the preintegrated prediction
    (fusion/imu.py predict_state) here."""
    reg = cfg.registration
    pose = Pose(state.pose_q if prior_q is None else prior_q,
                state.pose_t if prior_t is None else prior_t)
    is_first = state.n_scans == 0

    merged_edges = state.edge_window.reshape(-1, 3)
    merged_edge_mask = state.edge_mask.reshape(-1)
    merged_surfs = state.surf_window.reshape(-1, 3)
    merged_surf_mask = state.surf_mask.reshape(-1)

    # Dense grids re-centered on the current pose every step (dims are
    # static; the origin is a traced array, so no recompilation). The
    # reference likewise rebuilds its KD-trees of the merged recent
    # scans every update (recent_scans.hpp:74).
    em, sm = reg.edge_map, reg.surface_map
    dims = reg.odometry_grid_dims
    half_e = jnp.asarray(dims, state.pose_t.dtype) * em.voxel_size / 2.0
    half_s = jnp.asarray(dims, state.pose_t.dtype) * sm.voxel_size / 2.0
    edge_map = vg.build_voxel_grid(
        merged_edges, merged_edge_mask, em.voxel_size,
        state.pose_t - half_e, dims, em.points_per_voxel)
    surf_map = vg.build_voxel_grid(
        merged_surfs, merged_surf_mask, sm.voxel_size,
        state.pose_t - half_s, dims, sm.points_per_voxel)

    surf_ds, surf_ds_valid = voxel_downsample(
        surf_pts, surf_valid, reg.surface_downsample_leaf,
        reg.max_surface_points)

    def problem_fn(p: Pose) -> gn.Problem:
        eb = edge_residuals(edge_map, edge_pts, edge_valid, p,
                            reg.n_neighbors)
        sb = surface_residuals(surf_map, surf_ds, surf_ds_valid, p,
                               reg.n_neighbors)
        return gn.make_problem([eb, sb])

    result = gn.run_gauss_newton(
        problem_fn, pose, max_iterations=reg.max_iterations,
        convergence_tol=reg.convergence_tol, huber_k=reg.huber_k,
        degeneracy_threshold=reg.degeneracy_threshold)

    new_q = jnp.where(is_first, state.pose_q, result.pose.q)
    new_t = jnp.where(is_first, state.pose_t, result.pose.t)
    new_pose = Pose(new_q, new_t)

    # Insert the transformed scan into the ring buffer slot.
    w = state.edge_window.shape[0]
    te = new_pose.apply(edge_pts)
    ts = new_pose.apply(surf_pts)
    ew = jax.lax.dynamic_update_index_in_dim(
        state.edge_window, te, state.slot, 0)
    emk = jax.lax.dynamic_update_index_in_dim(
        state.edge_mask, edge_valid, state.slot, 0)
    sw = jax.lax.dynamic_update_index_in_dim(
        state.surf_window, ts, state.slot, 0)
    smk = jax.lax.dynamic_update_index_in_dim(
        state.surf_mask, surf_valid, state.slot, 0)

    new_state = OdometryState(
        edge_window=ew, edge_mask=emk, surf_window=sw, surf_mask=smk,
        slot=(state.slot + 1) % w, n_scans=state.n_scans + 1,
        pose_q=new_q, pose_t=new_t)
    return new_state, result


class GeometryOdometryState(NamedTuple):
    """Incremental moment-grid odometry map + rolling eviction window.

    Instead of rebuilding correspondence structures from the merged
    recent-scans window every update (the reference rebuilds KD-trees
    per scan, ``recent_scans.hpp:74``; the point-grid path above
    rebuilds dense voxel grids), the map IS a persistent pair of
    per-voxel moment grids (ops/geometry_grid.py): moments are
    additive, so inserting the new scan is one scatter-ADD and
    evicting the scan leaving the recent-N window is the same scatter
    with weight -1. The vehicle-following grid re-centers by integer
    voxel rolls (``recenter_moments``). Per update only the
    neighborhood box-filter + closed-form fits run over the dense
    grid — pure VPU passes — and registration re-searches per GN
    iteration with one 8-float record gather per point, exactly the
    production localization fast path."""

    edge_m: jnp.ndarray       # [Ce, 10] raw per-voxel moments
    surf_m: jnp.ndarray       # [Cs, 10]
    edge_origin: jnp.ndarray  # [3]
    surf_origin: jnp.ndarray  # [3]
    edge_window: jnp.ndarray  # [W, E, 3] world-frame inserted points
    edge_mask: jnp.ndarray    # [W, E]
    surf_window: jnp.ndarray  # [W, S, 3]
    surf_mask: jnp.ndarray    # [W, S]
    slot: jnp.ndarray
    n_scans: jnp.ndarray
    pose_q: jnp.ndarray
    pose_t: jnp.ndarray


def init_geometry_odometry(cfg: PipelineConfig,
                           dtype=jnp.float32) -> GeometryOdometryState:
    w = cfg.mapping.recent_scans_window
    e = cfg.extraction.max_edges
    s = cfg.extraction.max_surfaces
    reg = cfg.registration
    dims = reg.odometry_grid_dims
    cap = dims[0] * dims[1] * dims[2]
    half_e = np.asarray(dims) * reg.edge_map.voxel_size / 2.0
    half_s = np.asarray(dims) * reg.surface_map.voxel_size / 2.0
    return GeometryOdometryState(
        edge_m=jnp.zeros((cap, 10), dtype),
        surf_m=jnp.zeros((cap, 10), dtype),
        edge_origin=jnp.asarray(-half_e, dtype),
        surf_origin=jnp.asarray(-half_s, dtype),
        edge_window=jnp.zeros((w, e, 3), dtype),
        edge_mask=jnp.zeros((w, e), bool),
        surf_window=jnp.zeros((w, s, 3), dtype),
        surf_mask=jnp.zeros((w, s), bool),
        slot=jnp.zeros((), jnp.int32),
        n_scans=jnp.zeros((), jnp.int32),
        pose_q=jnp.array([1.0, 0, 0, 0], dtype),
        pose_t=jnp.zeros(3, dtype))


@partial(jax.jit, static_argnames=("cfg",))
def geometry_odometry_step(state: GeometryOdometryState, edge_pts,
                           edge_valid, surf_pts, surf_valid,
                           cfg: PipelineConfig, prior_q=None,
                           prior_t=None):
    """One incremental odometry update: re-center, fit, register,
    evict + insert. Same ``Odometry::Update`` semantics as
    ``odometry_step`` (odometry.hpp:52-64) at the production
    fast path's per-iteration cost."""
    from lidar_feature_extraction_tpu.ops import geometry_grid as gg

    reg = cfg.registration
    em, sm = reg.edge_map, reg.surface_map
    dims = reg.odometry_grid_dims
    pose = Pose(state.pose_q if prior_q is None else prior_q,
                state.pose_t if prior_t is None else prior_t)
    is_first = state.n_scans == 0

    # 1. Grids follow the vehicle (integer-voxel rolls, no rebuild).
    edge_m, edge_origin = gg.recenter_moments(
        state.edge_m, dims, em.voxel_size, state.edge_origin, pose.t)
    surf_m, surf_origin = gg.recenter_moments(
        state.surf_m, dims, sm.voxel_size, state.surf_origin, pose.t)

    # Window points whose voxels rolled off the grid had their moments
    # zeroed by recenter_moments; clear their mask bits so a later
    # eviction cannot subtract moments that are no longer present
    # (which would leave negative counts if the grid rolls back over
    # the voxel first). The AND is one-way: once dropped, a point stays
    # dropped even if the grid returns.
    def _in_bounds(pts, origin, voxel):
        idx = jnp.floor((pts - origin) / voxel)
        return jnp.all((idx >= 0)
                       & (idx < jnp.asarray(dims, idx.dtype)), axis=-1)

    edge_wmask = state.edge_mask & _in_bounds(
        state.edge_window, edge_origin, em.voxel_size)
    surf_wmask = state.surf_mask & _in_bounds(
        state.surf_window, surf_origin, sm.voxel_size)

    # 2. Finalize per-voxel line/plane fits (box-filter + eig3).
    edge_grid = gg.GeometryGrid(
        rec=gg.edge_records_from_moments(edge_m, dims, em.voxel_size,
                                         edge_origin),
        voxel_size=jnp.asarray(em.voxel_size, edge_m.dtype),
        origin=edge_origin, dims=dims)
    surf_grid = gg.GeometryGrid(
        rec=gg.surface_records_from_moments(surf_m, dims, sm.voxel_size,
                                            surf_origin),
        voxel_size=jnp.asarray(sm.voxel_size, surf_m.dtype),
        origin=surf_origin, dims=dims)

    surf_ds, surf_ds_valid = voxel_downsample(
        surf_pts, surf_valid, reg.surface_downsample_leaf,
        reg.max_surface_points)

    def problem_fn(p: Pose) -> gn.Problem:
        eb = gg.edge_rows_from_grid(edge_grid, edge_pts, edge_valid, p,
                                    reg.min_fit_points)
        sb = gg.surface_rows_from_grid(surf_grid, surf_ds, surf_ds_valid,
                                       p, reg.min_fit_points)
        return gn.make_problem([eb, sb])

    result = gn.run_gauss_newton(
        problem_fn, pose, max_iterations=reg.max_iterations,
        convergence_tol=reg.convergence_tol, huber_k=reg.huber_k,
        degeneracy_threshold=reg.degeneracy_threshold)

    new_q = jnp.where(is_first, state.pose_q, result.pose.q)
    new_t = jnp.where(is_first, state.pose_t, result.pose.t)
    new_pose = Pose(new_q, new_t)

    # 3. Evict the slot leaving the window and insert the new scan —
    # ONE signed moment scatter per grid.
    te = new_pose.apply(edge_pts)
    ts = new_pose.apply(surf_pts)
    old_e = jax.lax.dynamic_index_in_dim(state.edge_window, state.slot,
                                         0, keepdims=False)
    old_em = jax.lax.dynamic_index_in_dim(edge_wmask, state.slot,
                                          0, keepdims=False)
    old_s = jax.lax.dynamic_index_in_dim(state.surf_window, state.slot,
                                         0, keepdims=False)
    old_sm = jax.lax.dynamic_index_in_dim(surf_wmask, state.slot,
                                          0, keepdims=False)
    # Inserted-slot masks record what the scatter actually ADDS: an
    # out-of-bounds point is dropped by voxel_moments' dump row, so it
    # must never be evicted either.
    ins_em = edge_valid & _in_bounds(te, edge_origin, em.voxel_size)
    ins_sm = surf_valid & _in_bounds(ts, surf_origin, sm.voxel_size)
    sign_e = jnp.concatenate([jnp.ones(te.shape[0], te.dtype),
                              jnp.full(old_e.shape[0], -1.0, te.dtype)])
    sign_s = jnp.concatenate([jnp.ones(ts.shape[0], ts.dtype),
                              jnp.full(old_s.shape[0], -1.0, ts.dtype)])
    edge_m = edge_m + gg.voxel_moments(
        jnp.concatenate([te, old_e]), jnp.concatenate([ins_em, old_em]),
        em.voxel_size, edge_origin, dims, weight=sign_e)
    surf_m = surf_m + gg.voxel_moments(
        jnp.concatenate([ts, old_s]), jnp.concatenate([ins_sm, old_sm]),
        sm.voxel_size, surf_origin, dims, weight=sign_s)

    w = state.edge_window.shape[0]
    new_state = GeometryOdometryState(
        edge_m=edge_m, surf_m=surf_m,
        edge_origin=edge_origin, surf_origin=surf_origin,
        edge_window=jax.lax.dynamic_update_index_in_dim(
            state.edge_window, te, state.slot, 0),
        edge_mask=jax.lax.dynamic_update_index_in_dim(
            edge_wmask, ins_em, state.slot, 0),
        surf_window=jax.lax.dynamic_update_index_in_dim(
            state.surf_window, ts, state.slot, 0),
        surf_mask=jax.lax.dynamic_update_index_in_dim(
            surf_wmask, ins_sm, state.slot, 0),
        slot=(state.slot + 1) % w, n_scans=state.n_scans + 1,
        pose_q=new_q, pose_t=new_t)
    return new_state, result


@partial(jax.jit, static_argnames=("cfg", "scale"))
def register_to_window(edge_window, edge_mask, surf_window, surf_mask,
                       edge_pts, edge_valid, surf_pts, surf_valid,
                       prior_q, prior_t, cfg: PipelineConfig,
                       scale: int):
    """Coarse registration of a scan against the merged recent-scans
    window at ``scale``-times the map voxel size (grid cell count is
    divided by the same factor, so the extent is unchanged and the
    3x3x3 candidate reach grows to ±1.5 * scale voxels).

    The wide-basin stage of the odometry re-seed path: a cold start or
    a motion break leaves the prior farther from the optimum than the
    fine grids can see; scaled grids pull the pose
    into the fine basin exactly like the loop-closure pyramid
    (pipeline/slam.py _register_to_keyframe)."""
    reg = cfg.registration
    em, sm = reg.edge_map, reg.surface_map
    dims = tuple(max(d // scale, 8) for d in reg.odometry_grid_dims)
    prior = Pose(prior_q, prior_t)

    merged_e = edge_window.reshape(-1, 3)
    mem = edge_mask.reshape(-1)
    merged_s = surf_window.reshape(-1, 3)
    msm = surf_mask.reshape(-1)

    ve = scale * em.voxel_size
    vs = scale * sm.voxel_size
    half_e = jnp.asarray(dims, prior_t.dtype) * ve / 2.0
    half_s = jnp.asarray(dims, prior_t.dtype) * vs / 2.0
    edge_map = vg.build_voxel_grid(merged_e, mem, ve, prior_t - half_e,
                                   dims, em.points_per_voxel)
    surf_map = vg.build_voxel_grid(merged_s, msm, vs, prior_t - half_s,
                                   dims, sm.points_per_voxel)
    surf_ds, surf_ds_valid = voxel_downsample(
        surf_pts, surf_valid, reg.surface_downsample_leaf,
        reg.max_surface_points)

    def problem_fn(p: Pose) -> gn.Problem:
        eb = edge_residuals(edge_map, edge_pts, edge_valid, p,
                            reg.n_neighbors)
        sb = surface_residuals(surf_map, surf_ds, surf_ds_valid, p,
                               reg.n_neighbors)
        return gn.make_problem([eb, sb])

    return gn.run_gauss_newton(
        problem_fn, prior, max_iterations=reg.max_iterations,
        convergence_tol=reg.convergence_tol, huber_k=reg.huber_k,
        degeneracy_threshold=reg.degeneracy_threshold,
        abort_on_increase=False)


class Odometry:
    """Host facade mirroring the C++ ``Odometry`` template, plus the
    IMU-aided prior path the reference's stubbed ``imu_integration``
    package intended (LIO-SAM lineage, SURVEY.md §2.6).

    ``use_geometry=True`` (default) runs the incremental moment-grid
    map (``geometry_odometry_step``) — the production fast path's
    registration cost per iteration; ``False`` keeps the point-grid
    kNN path (``odometry_step``), the direct analogue of the
    reference's merged-window KD-trees."""

    def __init__(self, cfg: PipelineConfig, dtype=jnp.float32,
                 use_geometry: bool = True,
                 constant_velocity_prior: bool = True,
                 edge_gate_distance: float = 0.3):
        self.cfg = cfg
        self.use_geometry = use_geometry
        self.constant_velocity_prior = constant_velocity_prior
        # Re-seed gate: median point-to-line distance of the EDGE
        # correspondences at the registered pose above which the
        # constant-velocity attempt is deemed to have converged onto
        # aliased geometry (total error cannot tell — a dominant ground
        # plane fits any ground plane). See GNResult.block_errors.
        self.edge_gate_distance = edge_gate_distance
        self._step = (geometry_odometry_step if use_geometry
                      else odometry_step)
        self.state = (init_geometry_odometry(cfg, dtype) if use_geometry
                      else init_odometry(cfg, dtype))
        self.velocity = jnp.zeros(3, dtype)
        self._last_pose: Pose | None = None
        self._preintegrate = jax.jit(
            lambda g, a, d: imu_mod.preintegrate(
                g, a, d, jnp.zeros(3, dtype), jnp.zeros(3, dtype)))

    def update(self, edge_pts, edge_valid, surf_pts, surf_valid,
               prior: Pose | None = None):
        prev = self.pose
        cv_prior = None
        if prior is None and self.constant_velocity_prior \
                and self._last_pose is not None:
            # Constant-velocity extrapolation: compose the previous
            # inter-scan delta onto the current pose. The reference's
            # GN is never run cold — it is always seeded by the EKF
            # feedback loop (subscriber.hpp:128-176); with no external
            # prior this motion model is the minimum that keeps the
            # 3x3x3-voxel correspondence reach ahead of platform motion
            # (a constant-position seed loses track at ~1 m + ~5 deg
            # per scan).
            delta = self._last_pose.inverse().compose(prev)
            cv_prior = prev.compose(delta)
            prior = cv_prior
        state0 = self.state
        if prior is not None:
            # Callers may seed with host-built poses (EKF / IMU
            # prediction); under jax_enable_x64 those arrive as float64
            # and would re-trace _step and poison the f32 state carry.
            dtype = state0.pose_t.dtype
            prior = Pose(jnp.asarray(prior.q, dtype),
                         jnp.asarray(prior.t, dtype))
        if prior is None:
            self.state, result = self._step(
                state0, edge_pts, edge_valid, surf_pts, surf_valid,
                self.cfg)
        else:
            self.state, result = self._step(
                state0, edge_pts, edge_valid, surf_pts, surf_valid,
                self.cfg, prior_q=prior.q, prior_t=prior.t)
        if self._registration_suspect(result) \
                and int(self.state.n_scans) > 1:
            # The seed overran the correspondence reach or snapped onto
            # aliased geometry (cold start / abrupt reversal / motion
            # break): each fallback reruns on the ORIGINAL state — the
            # failed attempt inserted the scan at a bad pose and must
            # be discarded wholesale. Fallback ladder: constant-
            # position seed, then a wide-basin coarse-to-fine re-seed
            # (scaled-grid registration against the window, the
            # odometry analogue of the loop-closure pyramid). Keep the
            # attempt with the best edge fit.
            candidates = [(self._edge_median_distance(result),
                           self.state, result)]
            if cv_prior is not None:
                self.state, result = self._step(
                    state0, edge_pts, edge_valid, surf_pts, surf_valid,
                    self.cfg, prior_q=prev.q, prior_t=prev.t)
                candidates.append((self._edge_median_distance(result),
                                   self.state, result))
            if self._registration_suspect(result):
                seed = prev
                for scale in (4, 2):
                    coarse = register_to_window(
                        state0.edge_window, state0.edge_mask,
                        state0.surf_window, state0.surf_mask,
                        edge_pts, edge_valid, surf_pts, surf_valid,
                        seed.q, seed.t, self.cfg, scale)
                    if int(coarse.status) in (gn.CONVERGED,
                                              gn.MAX_ITERATIONS):
                        seed = coarse.pose
                self.state, result = self._step(
                    state0, edge_pts, edge_valid, surf_pts, surf_valid,
                    self.cfg, prior_q=seed.q, prior_t=seed.t)
                candidates.append((self._edge_median_distance(result),
                                   self.state, result))
            if self._registration_suspect(result):
                # Every attempt failed the gate: keep the best edge
                # fit (nan sorts last).
                def key(c):
                    return c[0] if c[0] == c[0] else float("inf")
                _, self.state, result = min(candidates, key=key)
        self._last_pose = prev
        return result

    @staticmethod
    def _edge_median_distance(result) -> float:
        """Median point-to-line distance of the edge block at the
        registered pose. Edge residual (p-p1)x(p-p2) has |p2-p1| = 2,
        so |r| = 2 * distance and block_errors[0] = 4 * distance^2."""
        if result.block_errors is None:
            return float("nan")
        return float(result.block_errors[0]) ** 0.5 / 2.0

    def _registration_suspect(self, result) -> bool:
        if int(result.status) in (gn.EMPTY_INPUT, gn.MAX_ITERATIONS):
            return True
        if self.edge_gate_distance is None:
            return False
        d = self._edge_median_distance(result)
        return d == d and d > self.edge_gate_distance

    def update_with_imu(self, edge_pts, edge_valid, surf_pts, surf_valid,
                        gyro, accel, dts):
        """Odometry update with the scan-matcher seeded by the IMU
        prediction over the inter-scan window (gyro/accel/dts: [N, 3] /
        [N, 3] / [N] samples since the previous scan). Velocity state
        is corrected from the registered poses after each update."""
        dtype = self.state.pose_t.dtype
        pre = self._preintegrate(jnp.asarray(gyro, dtype),
                                 jnp.asarray(accel, dtype),
                                 jnp.asarray(dts, dtype))
        q, t, _v = imu_mod.predict_state(
            self.state.pose_q, self.state.pose_t, self.velocity, pre)
        prev_t = self.state.pose_t
        result = self.update(edge_pts, edge_valid, surf_pts, surf_valid,
                             prior=Pose(q, t))
        # Velocity from registered motion (more stable than trusting
        # the IMU-propagated velocity once the matcher has corrected
        # the pose).
        window_dt = jnp.maximum(pre.dt, 1e-6)
        self.velocity = (self.state.pose_t - prev_t) / window_dt
        return result

    @property
    def pose(self) -> Pose:
        return Pose(self.state.pose_q, self.state.pose_t)
