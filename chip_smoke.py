"""Smoke test of the engine on one NVIDIA GPU, end to end.

Drives the main path through the entry points a user calls, at the
``kitti_hdl64`` preset's full width (64x2304 range image, compact
extraction, geometry maps, 40-iteration Gauss-Newton cap), and checks
each phase against the same computation on the host CPU device of the
same process:

  a. device      the accelerator, JAX version, nvidia-smi line, flags;
  b. extraction  labels / validity / selected points equal to the CPU;
  c. localize    20-sweep closed-loop drive through launch_localization
                 (PCD maps + EKF feedback): ATE and per-scan pose diff;
  d. mapping     80-scan closed circular drive through launch_mapping
                 (odometry, keyframes, loop closure, pose graph): ATE;
  e. posegraph   dense solver at K=128 and CG at K=512 against the CPU.

Each phase prints one JSON line with its cold (compile included) and
steady wall time, device memory and its accuracy numbers; any failed
check exits non-zero before the last line. The last line is
``{"ok": true, "device": {...}}``.

    python chip_smoke.py               one card
    python chip_smoke.py --four-cards  multi-device paths on four cards

Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np

# Tolerances against the CPU device. Extraction is exact: the labeling
# arithmetic gives the same bits on both backends and the compaction
# matmul runs at Precision.HIGHEST. Registration, the EKF and the pose
# graph sum in another order on the GPU (atomic scatter-adds, other
# reduction trees, cuSOLVER instead of LAPACK), so they agree to float32
# round-off amplified by the solves. The localization drive amplifies it
# further: the map's voxel moments are atomic scatter-adds, so two maps
# built from the same points differ in the last bits, and the closed
# loop (registration stopping rules + EKF feedback) turns that into a
# different pose within the registration's own noise. Two drives on the
# same card differ by as much as a drive on the card and one on the CPU
# (2-4 cm on an H100). Each drive must meet the ATE limit, so the
# per-scan bound is twice that limit.
CURVATURE_RTOL = 1e-6
LOC_POSE_TOL_M = 0.1
LOC_ROT_TOL_DEG = 0.1
ATE_LIMIT_M = 0.05
GRAPH_TOL_M = 1e-3
GRAPH_ROT_TOL_RAD = 1e-3
BATCH_TOL_M = 1e-4


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def memory(devices) -> dict:
    """Bytes in use and process peak per device (None where the
    backend keeps no statistics)."""
    out = {}
    for d in devices:
        stats = d.memory_stats() or {}
        out[str(d.id)] = {"bytes_in_use": stats.get("bytes_in_use"),
                          "peak_bytes_in_use":
                              stats.get("peak_bytes_in_use")}
    return out


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def ready(tree):
    import jax

    return jax.block_until_ready(tree)


def max_abs_diff(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def quat_angle_deg(qa, qb) -> np.ndarray:
    """Angle between rotations given as wxyz quaternions [..., 4], from
    the vector part of qa^-1 qb in float64 (arccos of the dot product
    would floor at ~0.03 deg for float32 inputs)."""
    a = np.asarray(qa, np.float64)
    b = np.asarray(qb, np.float64)
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    w = aw * bw + np.sum(av * bv, axis=-1, keepdims=True)
    v = aw * bv - bw * av - np.cross(av, bv)
    return np.degrees(2.0 * np.arctan2(np.linalg.norm(v, axis=-1),
                                       np.abs(w[..., 0])))


# --------------------------------------------------------------- a. device


def phase_device(args) -> dict:
    import jax

    from lidar_feature_extraction_tpu.utils.device_info import (
        device_record)

    rec = device_record()
    emit("device", devices=[str(d) for d in jax.devices()],
         jax_version=jax.__version__,
         nvidia_smi=rec.get("nvidia_smi"),
         xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache_dir=args.cache_dir)
    # The contract's line: the card's name and power limit as
    # nvidia-smi gives them.
    print(rec.get("nvidia_smi", "nvidia-smi: not available"), flush=True)
    return rec


# ----------------------------------------------------------- b. extraction


def worldsim_sweep(cfg, seed: int = 5, n_az: int = 2048):
    """One ray-cast sweep of a worldsim world as a range image."""
    from lidar_feature_extraction_tpu.core.scan import build_range_image
    from lidar_feature_extraction_tpu.utils import worldsim

    ex = cfg.extraction
    rng = np.random.default_rng(seed)
    world = worldsim.make_world(rng, n_poles=50, extent=35.0)
    pts, ring = worldsim.raycast_scan(
        world, worldsim.straight_drive(3), rng, n_rings=ex.n_rings,
        n_az=n_az, elev_deg=(2.0, -24.8))
    return build_range_image(*_padded_scan(pts, ring, cfg),
                             ex.n_rings, ex.max_points_per_ring,
                             min_points_per_ring=ex.padding + 1)


def _padded_scan(pts, ring, cfg):
    import jax.numpy as jnp

    ex = cfg.extraction
    n = ex.n_rings * ex.max_points_per_ring
    m = min(len(pts), n)
    buf = np.zeros((n, 3), np.float32)
    rid = np.zeros(n, np.int32)
    val = np.zeros(n, bool)
    buf[:m], rid[:m], val[:m] = pts[:m], ring[:m], True
    return jnp.asarray(buf), jnp.asarray(rid), jnp.asarray(val)


def compare_extraction(image, cfg, dev, ref_dev, n_steady: int = 10):
    """Run compact extraction + labeling on ``dev`` and ``ref_dev``;
    returns (timings, diffs) and raises CheckFailed on a mismatch."""
    import jax

    from lidar_feature_extraction_tpu.ops.extraction import (
        extract_features_compact, label_range_image)

    ex = cfg.extraction

    @jax.jit
    def run(im):
        feats = extract_features_compact(
            im, ex, surface_leaf=cfg.registration.surface_downsample_leaf,
            edges_per_ring=ex.edges_per_ring,
            surface_runs_per_ring=ex.surface_runs_per_ring,
            surface_centroid=ex.compact_surface_centroid)
        labels, curv = label_range_image(im, ex)
        return feats, labels, curv

    img = jax.device_put(image, dev)
    out, cold = timed(lambda: ready(run(img)))
    t0 = time.perf_counter()
    for _ in range(n_steady):
        out = run(img)
    ready(out)
    steady = (time.perf_counter() - t0) / n_steady
    ref = ready(run(jax.device_put(image, ref_dev)))

    feats, labels, curv = out
    rfeats, rlabels, rcurv = ref
    diffs = {"n_label_diff": int(np.sum(np.asarray(feats.labels)
                                        != np.asarray(rfeats.labels))),
             "n_label_range_image_diff": int(np.sum(
                 np.asarray(labels) != np.asarray(rlabels)))}
    for name in ("edge_valid", "surface_valid", "edge_xyz", "surface_xyz"):
        a, b = np.asarray(getattr(feats, name)), np.asarray(
            getattr(rfeats, name))
        diffs[f"n_{name}_diff"] = int(np.sum(a != b))
        diffs[f"max_abs_{name}"] = max_abs_diff(a, b)
    c, rc = np.asarray(curv, np.float64), np.asarray(rcurv, np.float64)
    rel = np.abs(c - rc) / np.maximum(np.abs(rc), 1e-30)
    diffs["curvature_max_rel"] = float(np.max(rel))
    diffs["curvature_bit_equal"] = bool(np.array_equal(c, rc))
    diffs["n_edges"] = int(np.sum(np.asarray(feats.edge_valid)))
    diffs["n_surfaces"] = int(np.sum(np.asarray(feats.surface_valid)))
    for key, val in diffs.items():
        if key.startswith("n_") and key.endswith("_diff"):
            check(val == 0, f"extraction {key}={val}: GPU differs from "
                            f"CPU (max diffs {diffs})")
    check(diffs["curvature_max_rel"] <= CURVATURE_RTOL,
          f"curvature rel diff {diffs['curvature_max_rel']}")
    return {"cold_s": cold, "steady_s": steady}, diffs


def phase_extraction(cfg, dev, ref_dev, scans) -> None:
    for name, image in scans:
        times, diffs = compare_extraction(image, cfg, dev, ref_dev)
        emit("extraction", scan=name, shape=list(image.mask.shape),
             cold_wall_s=times["cold_s"], steady_wall_s=times["steady_s"],
             memory=memory([dev]), **diffs)


# ------------------------------------------------------- c. localization


def localization_world(cfg, rng, n_scans: int, n_az: int = 2048,
                       n_poles: int = 50, n_ground: int = 30000):
    """The eval_ate.py world, maps and sweeps, drawn from ``rng``."""
    from lidar_feature_extraction_tpu.utils import worldsim

    world = worldsim.make_world(rng, n_poles=n_poles, extent=35.0)
    edges, surfs = worldsim.world_maps(world, rng, n_ground=n_ground)
    scans, gt = worldsim.make_scan_sequence(
        world, rng, n_scans=n_scans, n_rings=cfg.extraction.n_rings,
        n_az=n_az, elev_deg=(2.0, -24.8))
    twists = worldsim.synth_twists(len(scans), rng=rng)
    return world, edges, surfs, scans, gt, twists


def localization_drive(edge_pcd, surf_pcd, cfg, scans, twists):
    """launch_localization + one process_scan per sweep; returns the
    measured poses (q [N, 4], t [N, 3])."""
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.pipeline.launch import (
        launch_localization)

    pipeline = launch_localization(edge_pcd, surf_pcd, cfg=cfg,
                                   initial_pose=Pose.identity())
    qs, ts = [], []
    for i, (pts, ring) in enumerate(scans):
        res = pipeline.process_scan(pts, ring, stamp=0.1 * i,
                                    twist=twists[i])
        qs.append(np.asarray(res.measured_pose.q))
        ts.append(np.asarray(res.measured_pose.t))
    return np.stack(qs), np.stack(ts)


def phase_localization(cfg, dev, ref_dev, edges, surfs, scans, gt,
                       twists, tmpdir, ate_limit=ATE_LIMIT_M) -> dict:
    import jax

    from lidar_feature_extraction_tpu.io.pcd import save_pcd
    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    edge_pcd = os.path.join(tmpdir, "edge.pcd")
    surf_pcd = os.path.join(tmpdir, "surface.pcd")
    save_pcd(edge_pcd, edges)
    save_pcd(surf_pcd, surfs)

    def drive():
        return localization_drive(edge_pcd, surf_pcd, cfg, scans, twists)

    with jax.default_device(dev):
        (q, t), cold = timed(drive)
        (q2, t2), steady = timed(drive)
    with jax.default_device(ref_dev):
        (rq, rt), ref_wall = timed(drive)

    ate = float(ate_rmse(t, gt, align=False))
    ate_ref = float(ate_rmse(rt, gt, align=False))
    dt = np.linalg.norm(t.astype(np.float64) - rt, axis=-1)
    drot = quat_angle_deg(q, rq)
    out = {"n_scans": len(scans), "cold_wall_s": cold,
           "steady_wall_s": steady, "steady_ms_per_scan":
               1e3 * steady / len(scans),
           "ref_cpu_wall_s": ref_wall, "ate_rmse_m": ate,
           "ate_rmse_m_cpu": ate_ref,
           "max_pose_diff_m": float(dt.max()),
           "max_rot_diff_deg": float(drot.max()),
           "repeat_max_diff_m": max_abs_diff(t, t2),
           "memory": memory([dev])}
    emit("localization", **out)
    check(np.isfinite(ate) and ate <= ate_limit,
          f"localization ATE {ate} > {ate_limit}")
    check(out["max_pose_diff_m"] <= LOC_POSE_TOL_M,
          f"GPU-CPU pose diff {out['max_pose_diff_m']} m")
    check(out["max_rot_diff_deg"] <= LOC_ROT_TOL_DEG,
          f"GPU-CPU rotation diff {out['max_rot_diff_deg']} deg")
    return out


# ------------------------------------------------------------ d. mapping


def mapping_drive(world, cfg, rng, n_scans: int, n_az: int = 2048):
    """worldsim.run_mapping_drive (launch_mapping inside) with the
    eval_ate.py settings; returns (pipeline, gt)."""
    from lidar_feature_extraction_tpu.utils import worldsim

    return worldsim.run_mapping_drive(
        world, cfg, rng, n_scans=n_scans, radius=10.0,
        pipeline_kwargs=dict(loop_radius=6.0, loop_min_gap=10,
                             optimize_every=8),
        n_rings=cfg.extraction.n_rings, n_az=n_az, elev_deg=(2.0, -24.8))


def phase_mapping(cfg, dev, world, rng, n_scans: int, n_az: int = 2048,
                  ate_limit=ATE_LIMIT_M, min_loops: int = 1) -> dict:
    import jax

    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    rng2 = copy.deepcopy(rng)
    with jax.default_device(dev):
        (pipe, gt), cold = timed(mapping_drive, world, cfg, rng, n_scans,
                                 n_az)
        (pipe2, gt2), steady = timed(mapping_drive, world, cfg, rng2,
                                     n_scans, n_az)
    ate = float(ate_rmse(pipe.trajectory, gt, align=False))
    n_loops = len(pipe.constraints) - (len(pipe.keyframes) - 1)
    out = {"n_scans": n_scans, "cold_wall_s": cold, "steady_wall_s": steady,
           "steady_scans_per_s": n_scans / steady,
           "ate_rmse_m": ate,
           "ate_rmse_m_repeat": float(ate_rmse(pipe2.trajectory, gt2,
                                               align=False)),
           "n_keyframes": len(pipe.keyframes),
           "n_loop_constraints": n_loops,
           "memory": memory([dev])}
    emit("mapping", **out)
    check(np.isfinite(ate) and ate <= ate_limit,
          f"mapping ATE {ate} > {ate_limit}")
    check(n_loops >= min_loops, f"{n_loops} loop constraints")
    return out


# ---------------------------------------------------------- e. pose graph


def pose_graph_problem(k: int, seed: int = 0, loop_every: int = 8,
                       noise: float = 0.05):
    """A random-walk keyframe chain with loop constraints to the pose
    ``loop_every * 2`` back, noisy measurements and a noisy start;
    numpy arrays (graph, constraints) ready for any device."""
    import jax.numpy as jnp

    from lidar_feature_extraction_tpu.core import quaternion as quat

    rng = np.random.default_rng(seed)
    rot = np.concatenate([np.zeros((1, 3)),
                          rng.normal(scale=0.05, size=(k - 1, 3))])
    rot[:, 2] += 2 * np.pi / k            # drive roughly one circle
    q = np.asarray(quat.exp_so3(jnp.asarray(np.cumsum(rot, axis=0),
                                            jnp.float32)))
    step = rng.normal(scale=0.2, size=(k, 3)) + np.array([1.0, 0, 0])
    world_step = np.asarray(quat.quat_rotate(jnp.asarray(q),
                                             jnp.asarray(step, jnp.float32)))
    t = np.concatenate([np.zeros((1, 3)), np.cumsum(world_step[:-1],
                                                    axis=0)])
    i = np.arange(k - 1)
    loops = np.arange(2 * loop_every, k, loop_every)
    ii = np.concatenate([i, loops - 2 * loop_every]).astype(np.int32)
    jj = np.concatenate([i + 1, loops]).astype(np.int32)
    qi, qj = jnp.asarray(q[ii]), jnp.asarray(q[jj])
    zq = np.asarray(quat.quat_multiply(quat.quat_conjugate(qi), qj))
    zt = np.asarray(quat.quat_rotate(quat.quat_conjugate(qi),
                                     jnp.asarray(t[jj] - t[ii])))
    zt = zt + rng.normal(scale=0.01, size=zt.shape)
    q0 = np.array(quat.quat_normalize(quat.quat_multiply(
        jnp.asarray(q), quat.exp_so3(jnp.asarray(
            rng.normal(scale=noise, size=(k, 3)), jnp.float32)))))
    q0[0] = q[0]
    t0 = t + np.concatenate([np.zeros((1, 3)),
                             rng.normal(scale=noise, size=(k - 1, 3))])
    graph = (q0.astype(np.float32), t0.astype(np.float32))
    cons = (ii, jj, zq.astype(np.float32), zt.astype(np.float32),
            np.ones(len(ii), np.float32))
    return graph, cons


def _graph_arrays(graph, cons, dev):
    import jax

    from lidar_feature_extraction_tpu.parallel.pose_graph import (
        Constraints, PoseGraph)

    g = jax.device_put(PoseGraph(*graph), dev)
    c = jax.device_put(Constraints(*cons), dev)
    return g, c


def solve_pose_graph(solver: str, graph, cons, dev):
    """One jitted solve (10 GN iterations) on ``dev``: (result, cold,
    steady)."""
    import jax

    from lidar_feature_extraction_tpu.parallel.pose_graph import (
        optimize_pose_graph, optimize_pose_graph_cg)

    fn = jax.jit(optimize_pose_graph_cg if solver == "cg"
                 else optimize_pose_graph)
    g, c = _graph_arrays(graph, cons, dev)
    out, cold = timed(lambda: ready(fn(g, c)))
    out, steady = timed(lambda: ready(fn(g, c)))
    return out, cold, steady


def graph_diff(a, b) -> tuple[float, float]:
    """(max translation diff [m], max rotation diff [rad])."""
    return (max_abs_diff(a.poses_t, b.poses_t),
            float(np.radians(quat_angle_deg(a.poses_q, b.poses_q)).max()))


def phase_pose_graph(dev, ref_dev, sizes=(("dense", 128), ("cg", 512))):
    for solver, k in sizes:
        graph, cons = pose_graph_problem(k)
        out, cold, steady = solve_pose_graph(solver, graph, cons, dev)
        ref, _, _ = solve_pose_graph(solver, graph, cons, ref_dev)
        dt, dr = graph_diff(out, ref)
        emit("posegraph", solver=solver, n_keyframes=k,
             n_constraints=int(len(cons[0])), cold_wall_s=cold,
             steady_wall_s=steady, max_pose_diff_m=dt,
             max_rot_diff_rad=dr, memory=memory([dev]))
        check(dt <= GRAPH_TOL_M and dr <= GRAPH_ROT_TOL_RAD,
              f"{solver} K={k}: GPU-CPU diff {dt} m, {dr} rad")


# ------------------------------------------------------------ four cards


def batched_scans(cfg, n: int, seed: int = 0, n_az: int = 2048):
    """``n`` range images and perturbed priors from the localization
    world, plus its geometry maps."""
    import jax.numpy as jnp

    from lidar_feature_extraction_tpu.core import quaternion as quat
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.core.scan import build_range_image
    from lidar_feature_extraction_tpu.pipeline.localization import (
        build_geometry_maps)
    from lidar_feature_extraction_tpu.utils import worldsim

    ex = cfg.extraction
    rng = np.random.default_rng(seed)
    _, edges, surfs, scans, gt, _ = localization_world(cfg, rng, n,
                                                      n_az=n_az)
    maps = build_geometry_maps(
        jnp.asarray(edges, jnp.float32), jnp.ones(len(edges), bool),
        jnp.asarray(surfs, jnp.float32), jnp.ones(len(surfs), bool), cfg)
    images = [build_range_image(*_padded_scan(p, r, cfg), ex.n_rings,
                                ex.max_points_per_ring,
                                min_points_per_ring=ex.padding + 1)
              for p, r in scans]
    truth = [worldsim.straight_drive(i) for i in range(n)]
    priors = Pose(
        q=jnp.stack([quat.quat_multiply(p.q, quat.exp_so3(jnp.asarray(
            [0.0, 0.0, 0.01], jnp.float32))) for p in truth]),
        t=jnp.stack([p.t + jnp.asarray([0.1, -0.05, 0.0]) for p in truth]))
    return maps, images, priors, gt


def phase_four_cards(cfg, n_az: int = 2048,
                     graph_sizes=(("dense", 128), ("cg", 512))) -> None:
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.parallel.imu_graph import (
        optimize_imu_graph)
    from lidar_feature_extraction_tpu.parallel.mesh import make_mesh
    from lidar_feature_extraction_tpu.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu.parallel.pose_graph import (
        Constraints, PoseGraph, make_distributed_pose_graph_optimizer)
    from lidar_feature_extraction_tpu.pipeline.localization import (
        localize_scan)

    devices = jax.devices()[:4]
    mesh = make_mesh(4)
    dev0 = devices[0]

    # Batched localization: 8 scans, 2 per card, against localize_scan.
    maps, images, priors, _ = batched_scans(cfg, 8, n_az=n_az)
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *images)
    localizer = make_batched_localizer(mesh, cfg)
    (res, _), cold = timed(lambda: ready(localizer(maps, batch, priors)))
    (res, _), steady = timed(lambda: ready(localizer(maps, batch, priors)))
    on_cards = sorted({d.id for d in res.pose.t.devices()})
    mem = memory(devices)
    single = [localize_scan(jax.device_put(maps, dev0),
                            jax.device_put(im, dev0),
                            Pose(priors.q[b], priors.t[b]), cfg)[0]
              for b, im in enumerate(images)]
    single_t = np.stack([np.asarray(r.pose.t) for r in single])
    single_q = np.stack([np.asarray(r.pose.q) for r in single])
    dt = max_abs_diff(res.pose.t, single_t)
    dr = float(quat_angle_deg(np.asarray(res.pose.q), single_q).max())
    emit("four_cards_batched_localizer", batch=8, cold_wall_s=cold,
         steady_wall_s=steady, output_on_devices=on_cards,
         max_pose_diff_m=dt, max_rot_diff_deg=dr, memory=mem)
    check(dt <= BATCH_TOL_M, f"batched localizer diff {dt} m")
    check(len(on_cards) == 4, f"batch landed on devices {on_cards}")

    # Distributed pose graph, dense at K=128 and CG at K=512.
    for solver, k in graph_sizes:
        graph, cons = pose_graph_problem(k)
        m = len(cons[0])
        pad = (-m) % 4
        padded = tuple(np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                   a.dtype)])
                       for a in cons)
        # Padding lanes: zero weight, identity measurement on (0, 0).
        padded[2][m:, 0] = 1.0
        opt = make_distributed_pose_graph_optimizer(mesh, k, solver=solver)
        g = PoseGraph(*(jnp.asarray(a) for a in graph))
        c = Constraints(*(jnp.asarray(a) for a in padded))
        out, cold = timed(lambda: ready(opt(g, c)))
        out, steady = timed(lambda: ready(opt(g, c)))
        ref, _, _ = solve_pose_graph(solver, graph, cons, dev0)
        dt, dr = graph_diff(out, ref)
        emit("four_cards_pose_graph", solver=solver, n_keyframes=k,
             cold_wall_s=cold, steady_wall_s=steady, max_pose_diff_m=dt,
             max_rot_diff_rad=dr, memory=memory(devices))
        check(dt <= GRAPH_TOL_M and dr <= GRAPH_ROT_TOL_RAD,
              f"distributed {solver} K={k}: diff {dt} m, {dr} rad")

    # Sharded IMU-bias keyframe graph (the __graft_entry__ step).
    graph9, imu, cons9 = graft.imu_graph_problem(
        16, np.random.default_rng(0))
    step = graft.sharded_imu_graph_step(mesh)
    out9, cold = timed(lambda: ready(step(graph9, imu, cons9)))
    out9, steady = timed(lambda: ready(step(graph9, imu, cons9)))
    ref9 = ready(jax.jit(lambda g, c, f: optimize_imu_graph(
        g, c, f, n_iterations=2))(*jax.device_put((graph9, cons9, imu),
                                                  dev0)))
    dt = max_abs_diff(out9.poses_t, ref9.poses_t)
    dv = max_abs_diff(out9.vels, ref9.vels)
    dbg = max_abs_diff(out9.bg, ref9.bg)
    emit("four_cards_imu_graph", n_factors=16, cold_wall_s=cold,
         steady_wall_s=steady, max_pose_diff_m=dt, max_vel_diff=dv,
         max_gyro_bias_diff=dbg, memory=memory(devices))
    check(max(dt, dv) <= GRAPH_TOL_M and dbg <= 1e-5,
          f"sharded IMU graph diff {dt} m, {dv} m/s, {dbg} rad/s")


# ------------------------------------------------------------------ main


def require_gpu(n: int = 1) -> None:
    """Exit non-zero unless JAX's default backend is a GPU with ``n``
    devices."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's backend is {backend!r}",
              file=sys.stderr)
        raise SystemExit(2)
    if len(jax.devices()) < n:
        print(f"chip_smoke: needs {n} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        raise SystemExit(2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths on four cards")
    args = ap.parse_args(argv)

    require_gpu(4 if args.four_cards else 1)

    import jax

    from lidar_feature_extraction_tpu.config import kitti_hdl64
    from lidar_feature_extraction_tpu.utils.compile_cache import (
        enable_compile_cache)

    args.cache_dir = enable_compile_cache()
    t_start = time.perf_counter()
    rec = phase_device(args)
    cfg = kitti_hdl64()
    dev = jax.devices()[0]
    ref_dev = jax.devices("cpu")[0]

    try:
        if args.four_cards:
            phase_four_cards(cfg)
        else:
            from bench import build_scan

            rng = np.random.default_rng(0)
            world, edges, surfs, scans, gt, twists = localization_world(
                cfg, rng, n_scans=20)
            phase_extraction(cfg, dev, ref_dev, [
                ("bench_scene", build_scan(cfg, np.random.default_rng(0))),
                ("worldsim_sweep", worldsim_sweep(cfg))])
            with tempfile.TemporaryDirectory() as tmp:
                phase_localization(cfg, dev, ref_dev, edges, surfs, scans,
                                   gt, twists, tmp)
            phase_mapping(cfg, dev, world, rng, n_scans=80)
            phase_pose_graph(dev, ref_dev)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    emit("total", wall_s=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": rec["platform"], "kind": rec["kind"],
        "count": rec["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
