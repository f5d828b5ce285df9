"""Every matmul of the main-path programs runs at Precision.HIGHEST.

On a GPU a float32 ``dot_general`` of default precision may run in TF32
(10 mantissa bits: ~5 mm at 10 m range). Each case runs one program at
small shapes with JAX's caches cleared, records the precision of every
``dot_general`` that is traced, and requires (HIGHEST, HIGHEST) for all
of them. Tracing is backend-independent, so the CPU suite pins what the
card compiles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lidar_feature_extraction_tpu.config import kitti_hdl64
from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.core.scan import RangeImage
from test_pipeline import make_world, pad_to, sample_scan_features, small_cfg

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _traced_dot_precisions(fn):
    """Run ``fn`` with fresh caches; precision of every dot traced."""
    seen = []
    prim = jax.lax.dot_general_p
    orig = prim.bind

    def bind(*args, **params):
        seen.append(params.get("precision"))
        return orig(*args, **params)

    jax.clear_caches()
    prim.bind = bind
    try:
        jax.block_until_ready(fn())
    finally:
        del prim.bind
        jax.clear_caches()
    return seen


def _ring_image(cfg, seed=0):
    ex = cfg.extraction
    rng = np.random.default_rng(seed)
    R, P = ex.n_rings, ex.max_points_per_ring
    az = np.sort(rng.uniform(-np.pi, np.pi, size=(R, P)), axis=-1)
    rr = 8.0 + 2.0 * np.sin(5 * az) + (az > 0.5) * 3.0 \
        + rng.normal(scale=0.01, size=(R, P))
    z = np.linspace(-1.5, 1.0, R)[:, None] + 0.0 * az
    xyz = np.stack([rr * np.cos(az), rr * np.sin(az), z], axis=-1)
    return RangeImage(xyz=jnp.asarray(xyz, jnp.float32),
                      mask=jnp.ones((R, P), bool),
                      count=jnp.full((R,), P, jnp.int32))


def _maps(cfg, geometry):
    from lidar_feature_extraction_tpu.pipeline.localization import (
        build_feature_maps, build_geometry_maps)

    edges, surfs = make_world(np.random.default_rng(0))
    build = build_geometry_maps if geometry else build_feature_maps
    return build(jnp.asarray(edges, jnp.float32),
                 jnp.ones(len(edges), bool),
                 jnp.asarray(surfs, jnp.float32),
                 jnp.ones(len(surfs), bool), cfg)


def _compact_cfg():
    return dataclasses.replace(small_cfg(), compact_extraction=True)


PRIOR = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
             t=jnp.asarray([0.2, -0.1, 0.0], jnp.float32))


def _localize(geometry, cfg):
    from lidar_feature_extraction_tpu.pipeline.localization import (
        localize_scan)

    maps = _maps(cfg, geometry)
    return lambda: localize_scan(maps, _ring_image(cfg), PRIOR, cfg)[0]


def _host_localizer(geometry, cfg):
    from lidar_feature_extraction_tpu.pipeline.localization import (
        HostLocalizer)

    maps = _maps(cfg, geometry)
    return lambda: HostLocalizer(maps, cfg).localize(_ring_image(cfg),
                                                     PRIOR)[0]


def _odometry():
    from lidar_feature_extraction_tpu.pipeline.odometry import Odometry

    cfg = small_cfg()
    edges, surfs = make_world(np.random.default_rng(1))
    rng = np.random.default_rng(2)

    def run():
        odo = Odometry(cfg)
        for k in range(2):
            pose = Pose(q=quat.exp_so3(jnp.asarray([0.0, 0.0, 0.02 * k])),
                        t=jnp.asarray([0.3 * k, 0.0, 0.0]))
            e, s = sample_scan_features(edges, surfs, pose, rng)
            e, ev = pad_to(e, cfg.extraction.max_edges)
            s, sv = pad_to(s, cfg.extraction.max_surfaces)
            odo.update(e, ev, s, sv)
        return odo.state.pose_t

    return run


def _pose_graph(solver):
    from lidar_feature_extraction_tpu.parallel.pose_graph import (
        Constraints, PoseGraph, optimize_pose_graph, optimize_pose_graph_cg)

    k, m = 6, 5
    rng = np.random.default_rng(3)
    ident = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    graph = PoseGraph(
        poses_q=jnp.broadcast_to(ident, (k, 4)),
        poses_t=jnp.asarray(rng.normal(size=(k, 3)), jnp.float32))
    i = jnp.arange(m, dtype=jnp.int32)
    cons = Constraints(
        i=i, j=i + 1,
        z_q=jnp.broadcast_to(ident, (m, 4)),
        z_t=jnp.asarray(rng.normal(size=(m, 3)), jnp.float32),
        weight=jnp.ones(m, jnp.float32),
        info=jnp.broadcast_to(jnp.eye(6, dtype=jnp.float32), (m, 6, 6)))
    fn = optimize_pose_graph_cg if solver == "cg" else optimize_pose_graph
    return lambda: fn(graph, cons, n_iterations=2, robust_delta=1.0).poses_t


def _imu_graph():
    import __graft_entry__ as graft
    from lidar_feature_extraction_tpu.parallel.imu_graph import (
        optimize_imu_graph)

    graph, imu, cons = graft.imu_graph_problem(4, np.random.default_rng(4))
    return lambda: optimize_imu_graph(graph, cons, imu,
                                      n_iterations=2).poses_t


def _ekf():
    from lidar_feature_extraction_tpu.fusion import ekf

    cfg = small_cfg().ekf

    def run():
        state = ekf.init_ekf(cfg)
        state = ekf.predict(state, 0.02, cfg)
        state = ekf.update_pose(state, jnp.asarray([0.1, 0.0, 0.01]),
                                jnp.eye(3), jnp.asarray(0), cfg)
        state = ekf.update_twist(state, jnp.asarray([1.0, 0.01]),
                                 jnp.eye(2) * 0.1, jnp.asarray(0), cfg)
        return state.td.x

    return run


def _imu_preintegration():
    from lidar_feature_extraction_tpu.fusion import imu

    rng = np.random.default_rng(5)
    gyro = jnp.asarray(rng.normal(scale=0.1, size=(10, 3)), jnp.float32)
    accel = jnp.asarray(rng.normal(size=(10, 3)) + [0, 0, 9.8],
                        jnp.float32)
    dts = jnp.full((10,), 0.01, jnp.float32)
    zero = jnp.zeros(3, jnp.float32)
    q = jnp.asarray([1.0, 0, 0, 0], jnp.float32)

    def run():
        pre = jax.jit(imu.preintegrate)(gyro, accel, dts, zero, zero)
        res = jax.jit(imu.imu_factor_residual)(
            pre, q, zero, zero, q, zero + 0.1, zero,
            delta_bg=zero + 1e-3, delta_ba=zero)
        return res.r_p

    return run


def _build_geometry_maps():
    cfg = small_cfg()
    return lambda: _maps(cfg, geometry=True).fused


def _extract_compact():
    from lidar_feature_extraction_tpu.ops.extraction import (
        extract_features_compact)

    cfg = kitti_hdl64().extraction
    cfg = dataclasses.replace(cfg, n_rings=4, max_points_per_ring=256)
    image = _ring_image(dataclasses.replace(kitti_hdl64(), extraction=cfg))
    return lambda: extract_features_compact(image, cfg).edge_xyz


PROGRAMS = {
    "localize_scan_geometry_compact": lambda: _localize(True,
                                                        _compact_cfg()),
    "localize_scan_point_maps": lambda: _localize(False, small_cfg()),
    "localize_scan_refit": lambda: _localize(False, dataclasses.replace(
        small_cfg(), registration=dataclasses.replace(
            small_cfg().registration, refit_per_iteration=True))),
    "host_localizer_geometry": lambda: _host_localizer(True,
                                                       _compact_cfg()),
    "host_localizer_point_maps": lambda: _host_localizer(False,
                                                         small_cfg()),
    "odometry_update": _odometry,
    "build_geometry_maps": _build_geometry_maps,
    "pose_graph_dense": lambda: _pose_graph("dense"),
    "pose_graph_cg": lambda: _pose_graph("cg"),
    "imu_graph": _imu_graph,
    "ekf_predict_update": _ekf,
    "imu_preintegration": _imu_preintegration,
    "extract_features_compact": _extract_compact,
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_every_dot_is_highest_precision(name):
    seen = _traced_dot_precisions(PROGRAMS[name]())
    if name != "ekf_predict_update" and name != "build_geometry_maps":
        assert seen, f"{name} traced no dot_general"
    bad = [p for p in seen if p != HIGHEST]
    assert not bad, (f"{name}: {len(bad)} of {len(seen)} dot_generals "
                     f"below HIGHEST: {bad[:3]}")
