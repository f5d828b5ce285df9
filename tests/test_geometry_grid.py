"""Tests for the precomputed per-voxel geometry maps
(ops/geometry_grid.py) and the geometry-mode registration path.

Strategy mirrors SURVEY.md §4: numpy oracles for the moment/fit math,
then convergence tests on synthetic rigid transforms (the pattern of
``localization/test/test_optimizer.cpp:53-127``).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lidar_feature_extraction_tpu.config import (
    PipelineConfig, RegistrationConfig, VoxelMapConfig)
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.ops import geometry_grid as gg
from lidar_feature_extraction_tpu.ops import gauss_newton as gn
from lidar_feature_extraction_tpu.ops.voxel_grid import grid_for_bounds
from lidar_feature_extraction_tpu.pipeline.localization import (
    GeometryMaps, build_geometry_maps, register_scan_geometry)


def _np_neighborhood_moments(pts, voxel_size, origin, dims):
    """Brute-force oracle: for every voxel, the count/mean/cov of all
    points in its 3x3x3 neighborhood (world frame)."""
    cells = np.floor((pts - origin) / voxel_size).astype(int)
    nx, ny, nz = dims
    out = {}
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                sel = (np.abs(cells[:, 0] - ix) <= 1) \
                    & (np.abs(cells[:, 1] - iy) <= 1) \
                    & (np.abs(cells[:, 2] - iz) <= 1)
                p = pts[sel]
                if len(p):
                    mu = p.mean(axis=0)
                    d = p - mu
                    cov = d.T @ d / len(p)
                else:
                    mu = np.zeros(3)
                    cov = np.zeros((3, 3))
                out[(ix, iy, iz)] = (len(p), mu, cov)
    return out


def test_neighborhood_moments_match_numpy_oracle():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.0, 4.0, size=(300, 3)).astype(np.float32)
    # Far-from-origin offset exercises the local-frame accumulation.
    offset = np.array([1000.0, -2000.0, 500.0], np.float32)
    pts = pts + offset
    voxel = 1.0
    origin, dims = grid_for_bounds(pts.min(0), pts.max(0), voxel)

    m = gg.voxel_moments(jnp.asarray(pts), jnp.ones(len(pts), bool),
                         voxel, origin, dims)
    nb = np.asarray(gg.neighborhood_moments(m, dims, voxel))
    n, mu, cov = map(np.asarray, gg._mean_cov(jnp.asarray(nb)))
    centers = np.asarray(gg._voxel_centers(dims, voxel, origin,
                                           jnp.float32))

    oracle = _np_neighborhood_moments(pts.astype(np.float64), voxel,
                                      origin.astype(np.float64), dims)
    nx, ny, nz = dims
    checked = 0
    for (ix, iy, iz), (cnt, mu_o, cov_o) in oracle.items():
        i = (ix * ny + iy) * nz + iz
        assert n[i] == cnt
        if cnt >= 5:
            np.testing.assert_allclose(centers[i] + mu[i], mu_o,
                                       atol=1e-3)
            np.testing.assert_allclose(cov[i], cov_o, atol=1e-3)
            checked += 1
    assert checked > 20


def test_edge_grid_recovers_line_direction():
    rng = np.random.default_rng(0)
    t = np.linspace(-2, 2, 200)[:, None]
    d = np.array([[0.267, 0.535, 0.802]])
    pts = (t * d + rng.normal(scale=0.01, size=(200, 3))).astype(np.float32)
    origin, dims = grid_for_bounds(pts.min(0), pts.max(0), 1.0)
    grid = gg.build_edge_geometry_grid(jnp.asarray(pts),
                                       jnp.ones(len(pts), bool),
                                       1.0, origin, dims)
    rec, in_grid = gg.gather_records(grid, jnp.asarray([[0.0, 0.0, 0.0]]))
    rec = np.asarray(rec)[0]
    assert bool(np.asarray(in_grid)[0])
    m, v, cnt = rec[0:3], rec[3:6], rec[6]
    assert cnt >= 5
    np.testing.assert_allclose(np.abs(v @ d[0]), 1.0, atol=1e-3)
    # Line point sits on the line.
    np.testing.assert_allclose(np.cross(m, d[0]), 0.0, atol=0.05)


def test_surface_grid_recovers_plane():
    rng = np.random.default_rng(1)
    xy = rng.uniform(-3, 3, size=(500, 2))
    u_true = np.array([0.0, 0.0, 1.0])
    b_true = 1.5
    pts = np.concatenate([xy, np.full((500, 1), b_true)], axis=-1)
    pts = (pts + rng.normal(scale=0.005, size=pts.shape)).astype(np.float32)
    origin, dims = grid_for_bounds(pts.min(0), pts.max(0), 2.0)
    grid = gg.build_surface_geometry_grid(jnp.asarray(pts),
                                          jnp.ones(len(pts), bool),
                                          2.0, origin, dims)
    rec, in_grid = gg.gather_records(grid, jnp.asarray([[0.0, 0.0, 1.4]]))
    rec = np.asarray(rec)[0]
    assert bool(np.asarray(in_grid)[0])
    u, b, cnt = rec[0:3], rec[3], rec[4]
    assert cnt >= 5
    sgn = np.sign(u @ u_true)
    np.testing.assert_allclose(sgn * u, u_true, atol=1e-3)
    np.testing.assert_allclose(sgn * b, b_true, atol=0.01)


def test_out_of_grid_queries_are_invalid():
    pts = np.zeros((10, 3), np.float32)
    origin, dims = grid_for_bounds(pts.min(0), pts.max(0), 1.0)
    grid = gg.build_edge_geometry_grid(jnp.asarray(pts),
                                       jnp.ones(10, bool), 1.0,
                                       origin, dims)
    rec, in_grid = gg.gather_records(grid, jnp.asarray([[99.0, 0.0, 0.0]]))
    assert not bool(np.asarray(in_grid)[0])
    np.testing.assert_array_equal(np.asarray(rec)[0], 0.0)


def _synthetic_world(rng):
    """Poles (edges) + ground/wall planes (surfaces), plus a scan."""
    n_lines = 12
    line_xy = rng.uniform(-12, 12, size=(n_lines, 2))
    zs = np.linspace(-1, 4, 24)
    edge_map = np.concatenate([
        np.repeat(line_xy, len(zs), axis=0),
        np.tile(zs, n_lines)[:, None]], axis=-1)
    edge_map += rng.normal(scale=0.01, size=edge_map.shape)

    g = rng.uniform(-16, 16, size=(4000, 2))
    ground = np.concatenate([g, rng.normal(scale=0.01,
                                           size=(4000, 1))], axis=-1)
    wy = rng.uniform(-16, 16, size=(1500,))
    wz = rng.uniform(0, 5, size=(1500,))
    wall = np.stack([np.full_like(wy, 8.0), wy, wz], axis=-1)
    surf_map = np.concatenate([ground, wall]).astype(np.float32)
    return edge_map.astype(np.float32), surf_map


def test_geometry_registration_converges_to_truth():
    rng = np.random.default_rng(7)
    edge_map, surf_map = _synthetic_world(rng)

    cfg = PipelineConfig(registration=RegistrationConfig(
        max_surface_points=2048,
        edge_map=VoxelMapConfig(voxel_size=1.0),
        surface_map=VoxelMapConfig(voxel_size=2.0)))

    maps = build_geometry_maps(
        jnp.asarray(edge_map), jnp.ones(len(edge_map), bool),
        jnp.asarray(surf_map), jnp.ones(len(surf_map), bool), cfg)
    assert isinstance(maps, GeometryMaps)

    # The scan is a subsample of the map clouds moved by the INVERSE of
    # the true pose; registering recovers the pose.
    true = Pose(q=jnp.asarray([0.9998, 0.0, 0.0, 0.02], jnp.float32),
                t=jnp.asarray([0.4, -0.25, 0.08], jnp.float32))
    true = Pose(true.q / jnp.linalg.norm(true.q), true.t)
    inv = true.inverse()

    e_sel = rng.permutation(len(edge_map))[:160]
    s_sel = rng.permutation(len(surf_map))[:1200]
    e_scan = inv.apply(jnp.asarray(edge_map[e_sel]))
    s_scan = inv.apply(jnp.asarray(surf_map[s_sel]))

    result = register_scan_geometry(
        maps, e_scan, jnp.ones(len(e_sel), bool),
        s_scan, jnp.ones(len(s_sel), bool),
        Pose.identity(), cfg)

    t_err = float(jnp.linalg.norm(result.pose.t - true.t))
    q_err = float(jnp.linalg.norm(result.pose.q - true.q))
    assert t_err < 0.03, (t_err, int(result.status))
    assert q_err < 0.01, (q_err, int(result.status))


def test_geometry_registration_at_truth_stays():
    rng = np.random.default_rng(9)
    edge_map, surf_map = _synthetic_world(rng)
    cfg = PipelineConfig(registration=RegistrationConfig(
        max_surface_points=2048))
    maps = build_geometry_maps(
        jnp.asarray(edge_map), jnp.ones(len(edge_map), bool),
        jnp.asarray(surf_map), jnp.ones(len(surf_map), bool), cfg)

    e_scan = jnp.asarray(edge_map[:160])
    s_scan = jnp.asarray(surf_map[:1200])
    result = register_scan_geometry(
        maps, e_scan, jnp.ones(160, bool), s_scan, jnp.ones(1200, bool),
        Pose.identity(), cfg)
    assert float(jnp.linalg.norm(result.pose.t)) < 5e-3
    assert float(jnp.linalg.norm(result.pose.q[1:])) < 5e-3


def test_geometry_registration_empty_scan():
    rng = np.random.default_rng(11)
    edge_map, surf_map = _synthetic_world(rng)
    cfg = PipelineConfig(registration=RegistrationConfig(
        max_surface_points=256))
    maps = build_geometry_maps(
        jnp.asarray(edge_map), jnp.ones(len(edge_map), bool),
        jnp.asarray(surf_map), jnp.ones(len(surf_map), bool), cfg)
    e = jnp.zeros((16, 3), jnp.float32)
    s = jnp.zeros((64, 3), jnp.float32)
    result = register_scan_geometry(
        maps, e, jnp.zeros(16, bool), s, jnp.zeros(64, bool),
        Pose.identity(), cfg)
    assert int(result.status) == gn.EMPTY_INPUT
    np.testing.assert_array_equal(np.asarray(result.pose.t), 0.0)


def test_moment_grid_eviction_never_goes_negative_across_rolls():
    """A windowed point whose voxels are cleared by
    a grid roll must NOT be subtracted later when the grid rolls back —
    that left negative counts leaking into neighborhood fits. Drive the
    incremental odometry with a tiny grid so points roll off and the
    vehicle loiters back and forth across the boundary; every voxel
    count must stay >= 0 (up to float noise) after every step."""
    import dataclasses

    from lidar_feature_extraction_tpu.config import (
        ExtractionConfig, MappingConfig, PipelineConfig,
        RegistrationConfig, VoxelMapConfig)
    from lidar_feature_extraction_tpu.pipeline.odometry import (
        geometry_odometry_step, init_geometry_odometry)

    vm = VoxelMapConfig(voxel_size=1.0)
    cfg = PipelineConfig(
        extraction=ExtractionConfig(n_rings=4, max_points_per_ring=64,
                                    max_edges=64, max_surfaces=64),
        registration=RegistrationConfig(
            max_iterations=2, edge_map=vm, surface_map=vm,
            odometry_grid_dims=(8, 8, 4),   # 8 m x 8 m x 4 m: tiny
            max_edge_points=64, max_surface_points=64),
        mapping=MappingConfig(recent_scans_window=3))

    rng = np.random.default_rng(0)
    state = init_geometry_odometry(cfg)
    # Loiter across a voxel boundary with a wide point cloud: +-6 m
    # spread guarantees points fall off the 8 m grid every roll.
    xs = [0.0, 3.0, -3.0, 4.0, -4.0, 2.5, -2.5, 5.0, 0.0]
    for x in xs:
        pts = rng.uniform(-6, 6, size=(64, 3)).astype(np.float32)
        pts[:, 2] *= 0.3
        e = jnp.asarray(pts)
        ev = jnp.ones(64, bool)
        prior_t = jnp.asarray([x, 0.0, 0.0], jnp.float32)
        state, _ = geometry_odometry_step(
            state, e, ev, e, ev, cfg,
            prior_q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
            prior_t=prior_t)
        for m in (state.edge_m, state.surf_m):
            counts = np.asarray(m[:, 0])
            assert counts.min() > -1e-3, counts.min()
