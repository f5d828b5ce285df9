"""Two-implementation agreement: JAX pipeline vs the independent C++
golden generator.

Every JAX kernel in the suite is parity-tested against ``tests/
np_ref.py`` — a numpy oracle written by the same author from the same
reading of the reference. ``native/baseline_bench.cpp`` is a SECOND,
independently written implementation of the surveyed pipeline
(per-ring sequential extraction, KD-tree k=15 kNN, PCA/plane-fit
residuals, Huber-IRLS Gauss-Newton with the 7->6 lift); its
``--golden`` mode dumps labels, curvature, extracted features and the
GN trajectory on a scene file this test generates. Agreement between
the two implementations on a shared ray-cast scene cross-validates
both against the surveyed reference semantics
(``extraction/include/lidar_feature_extraction/label.hpp:61-139``,
``localization/src/optimizer.cpp:35-128``).
"""

import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import (ExtractionConfig,
                                                 PipelineConfig,
                                                 RegistrationConfig,
                                                 VoxelMapConfig)
from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.core.scan import build_range_image
from lidar_feature_extraction_tpu.ops import extraction as ex_ops
from lidar_feature_extraction_tpu.pipeline.localization import (
    build_feature_maps, register_scan)
from lidar_feature_extraction_tpu.utils import worldsim

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "native" / "baseline_bench"

# Matches the C++ ExtractParams defaults (the reference's production
# YAML overlay): padding=2, neighbor 3 deg, edge 50, max_range 1000.
EX = ExtractionConfig(n_rings=16, max_points_per_ring=512,
                      padding=2, neighbor_degree_threshold=3.0,
                      edge_threshold=50.0, max_range=1000.0,
                      nms_rounds=64, max_edges=1024, max_surfaces=8192)


def _bench_binary():
    if not BENCH.exists():
        r = subprocess.run(["make", "-C", str(ROOT / "native"),
                            "baseline"], capture_output=True, text=True)
        if r.returncode != 0 or not BENCH.exists():
            pytest.skip(f"cannot build native bench: {r.stderr[-400:]}")
    return str(BENCH)


def _write_pts(f, pts):
    f.write(struct.pack("<i", len(pts)))
    f.write(np.ascontiguousarray(pts, np.float64).tobytes())


def _read_pts(f):
    (n,) = struct.unpack("<i", f.read(4))
    return np.frombuffer(f.read(24 * n), np.float64).reshape(n, 3)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Generate the shared scene, run the C++ golden mode, parse it."""
    binary = _bench_binary()
    tmp = tmp_path_factory.mktemp("golden")
    rng = np.random.default_rng(3)
    world = worldsim.make_world(rng, n_poles=25, extent=20.0)
    world_edges, world_surfs = worldsim.world_maps(world, rng,
                                                   n_ground=8000)
    pose_true = Pose.identity()
    pts, ring = worldsim.raycast_scan(world, pose_true, rng,
                                      n_rings=16, n_az=512)

    n = EX.n_rings * EX.max_points_per_ring
    buf = np.zeros((n, 3), np.float32)
    rid = np.zeros(n, np.int32)
    val = np.zeros(n, bool)
    m = min(len(pts), n)
    buf[:m] = pts[:m]
    rid[:m] = ring[:m]
    val[:m] = True
    image = build_range_image(jnp.asarray(buf), jnp.asarray(rid),
                              jnp.asarray(val), EX.n_rings,
                              EX.max_points_per_ring,
                              min_points_per_ring=EX.padding + 1)

    prior = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                 t=jnp.asarray([0.2, -0.15, 0.02], jnp.float32))

    scene = tmp / "scene.bin"
    out = tmp / "golden.bin"
    counts = np.asarray(image.count)
    xyz = np.asarray(image.xyz, np.float64)
    with open(scene, "wb") as f:
        f.write(struct.pack("<ii", 0x4C475331, EX.n_rings))
        for r in range(EX.n_rings):
            _write_pts(f, xyz[r, :counts[r]])
        _write_pts(f, world_edges)
        _write_pts(f, world_surfs)
        f.write(np.asarray([1.0, 0, 0, 0, 0.2, -0.15, 0.02],
                           np.float64).tobytes())

    r = subprocess.run([binary, "--golden", str(scene), str(out)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]

    with open(out, "rb") as f:
        (R,) = struct.unpack("<i", f.read(4))
        labels, curvs = [], []
        for _ in range(R):
            (nn,) = struct.unpack("<i", f.read(4))
            labels.append(np.frombuffer(f.read(nn), np.uint8))
            curvs.append(np.frombuffer(f.read(8 * nn), np.float64))
        edges = _read_pts(f)
        surf_ds = _read_pts(f)
        (n_traj,) = struct.unpack("<i", f.read(4))
        traj = np.frombuffer(f.read(56 * n_traj),
                             np.float64).reshape(n_traj, 7)
    return {
        "image": image, "labels": labels, "curvs": curvs,
        "edges": edges, "surf_ds": surf_ds, "traj": traj,
        "world_edges": world_edges, "world_surfs": world_surfs,
        "prior": prior, "pose_true": pose_true,
    }


def test_curvature_matches_cpp(golden):
    image = golden["image"]
    _, curv = ex_ops.label_range_image(image, EX)
    curv = np.asarray(curv)
    counts = np.asarray(image.count)
    for r in range(EX.n_rings):
        nn = counts[r]
        if nn == 0:
            continue
        # float32 JAX vs double C++; curvature magnitudes reach ~1e4.
        np.testing.assert_allclose(curv[r, :nn], golden["curvs"][r],
                                   rtol=2e-4, atol=2e-3)


def test_labels_match_cpp(golden):
    image = golden["image"]
    labels, _ = ex_ops.label_range_image(image, EX)
    labels = np.asarray(labels)
    counts = np.asarray(image.count)
    total = 0
    mismatch = 0
    edge_j = edge_c = surf_j = surf_c = 0
    for r in range(EX.n_rings):
        nn = counts[r]
        if nn == 0:
            continue
        lj = labels[r, :nn]
        lc = golden["labels"][r].astype(np.int32)
        total += nn
        mismatch += int((lj != lc).sum())
        edge_j += int((lj == ex_ops.EDGE).sum())
        edge_c += int((lc == ex_ops.EDGE).sum())
        surf_j += int((lj == ex_ops.SURFACE).sum())
        surf_c += int((lc == ex_ops.SURFACE).sum())
    # Exact agreement is expected except at float32-vs-double threshold
    # ties; allow a thin margin.
    assert total > 3000
    assert mismatch / total < 0.005, (mismatch, total)
    assert abs(edge_j - edge_c) <= max(2, 0.02 * edge_c), (edge_j, edge_c)
    assert abs(surf_j - surf_c) <= max(2, 0.02 * surf_c), (surf_j, surf_c)


def test_gauss_newton_agrees_with_cpp(golden):
    """Feed the C++-extracted features into the JAX faithful
    registration (kNN candidates + per-iteration refits, k=15) against
    the same maps: both implementations must land on the same pose."""
    vm = VoxelMapConfig(voxel_size=2.0, table_capacity=1 << 12,
                        points_per_voxel=24, max_probes=8)
    cfg = PipelineConfig(
        extraction=EX,
        registration=RegistrationConfig(
            n_neighbors=15, max_iterations=40,
            refit_per_iteration=True, n_search_rounds=2,
            edge_map=vm, surface_map=vm,
            max_edge_points=1024, max_surface_points=2048))
    maps = build_feature_maps(
        jnp.asarray(golden["world_edges"], jnp.float32),
        jnp.ones(len(golden["world_edges"]), bool),
        jnp.asarray(golden["world_surfs"], jnp.float32),
        jnp.ones(len(golden["world_surfs"]), bool), cfg)

    def pad(pts, cap):
        out = np.zeros((cap, 3), np.float32)
        valid = np.zeros(cap, bool)
        k = min(len(pts), cap)
        out[:k] = pts[:k]
        valid[:k] = True
        return jnp.asarray(out), jnp.asarray(valid)

    e_pts, e_val = pad(golden["edges"], 1024)
    s_pts, s_val = pad(golden["surf_ds"], 2048)
    result = jax.jit(lambda e, ev, s, sv, p: register_scan(
        maps, e, ev, s, sv, p, cfg))(e_pts, e_val, s_pts, s_val,
                                     golden["prior"])

    t_cpp = golden["traj"][-1, 4:]
    q_cpp = golden["traj"][-1, :4]
    t_jax = np.asarray(result.pose.t, np.float64)
    q_jax = np.asarray(result.pose.q, np.float64)

    # Both should be close to the true pose (identity) ...
    assert np.linalg.norm(t_cpp) < 0.1, t_cpp
    assert np.linalg.norm(t_jax) < 0.1, t_jax
    # ... and to each other (different kNN structure: KD-tree exact vs
    # voxel candidates; acceptance is pose-level agreement).
    assert np.linalg.norm(t_jax - t_cpp) < 0.05, (t_jax, t_cpp)
    dq = quat.quat_multiply(
        quat.quat_conjugate(jnp.asarray(q_cpp, jnp.float32)),
        jnp.asarray(q_jax, jnp.float32))
    angle = float(jnp.linalg.norm(quat.log_so3(dq)))
    assert angle < np.radians(0.5), angle
