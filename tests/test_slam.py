"""Full mapping pipeline test: a square drive with a loop closure must
produce a consistent trajectory; plus prior queue and visualization
export tests."""

import numpy as np
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.pipeline.prior_queue import PriorPoseQueue
from lidar_feature_extraction_tpu.pipeline.slam import MappingPipeline
from test_pipeline import make_world, pad_to, sample_scan_features, small_cfg


def test_prior_pose_queue():
    q = PriorPoseQueue()
    assert q.get_closest(1.0) is None
    for s in [1.0, 3.0, 2.0, 5.0]:
        q.insert(s, f"p{s}")
    assert len(q) == 4
    assert q.get_closest(2.9)[1] == "p3.0"
    assert q.get_closest(0.0)[1] == "p1.0"
    assert q.get_closest(99.0)[1] == "p5.0"
    assert q.get_closest(1.5)[1] == "p1.0"  # tie goes to earlier
    q.remove_older_than(2.5)
    assert len(q) == 2
    assert q.get_closest(0.0)[1] == "p3.0"
    q.insert(3.0, "replaced")
    assert q.get_closest(3.0)[1] == "replaced"
    assert len(q) == 2


def test_mapping_pipeline_square_drive():
    rng = np.random.default_rng(0)
    cfg = small_cfg()
    world_edges, world_surfs = make_world(rng)

    pipeline = MappingPipeline(cfg, loop_radius=3.0, loop_min_gap=3,
                               optimize_every=100)

    # Drive a small square with 1 m steps, returning near the start.
    # Translation-only square (instant 90-degree yaw jumps at corners
    # would leave the GN convergence basin; heading changes are not what
    # this integration test exercises).
    side = [(i, 0.0) for i in range(5)]
    side += [(4.0, i) for i in range(1, 5)]
    side += [(4.0 - i, 4.0) for i in range(1, 5)]
    side += [(0.0, 4.0 - i) for i in range(1, 4)]
    side += [(0.0, 0.3)]
    waypoints = [(x, y, 0.0) for (x, y) in side]
    gt = []
    for x, y, yaw in waypoints:
        pose = Pose(q=quat.exp_so3(jnp.asarray([0, 0, yaw], jnp.float32)),
                    t=jnp.asarray([x, y, 0.0], jnp.float32))
        gt.append([x, y, 0.0])
        e, s = sample_scan_features(world_edges, world_surfs, pose, rng,
                                    n_e=200, n_s=500)
        e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
        s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
        pipeline.process_scan(e_pts, e_valid, s_pts, s_valid)

    assert len(pipeline.keyframes) >= 5
    # At least the odometry chain constraints exist.
    assert len(pipeline.constraints) >= len(pipeline.keyframes) - 1
    pipeline.optimize()
    traj = pipeline.trajectory
    gt = np.asarray(gt, float)
    # Keyframe gating skips some waypoints; compare each keyframe to its
    # nearest ground-truth waypoint.
    for p in traj:
        d = np.linalg.norm(gt - p, axis=-1).min()
        assert d < 0.5, (p, d)

    e_map, s_map = pipeline.assemble_map()
    assert len(e_map) > 100 and len(s_map) > 100


def test_mapping_pipeline_loop_closure_constraint_added():
    """Force a revisit: the pipeline must add a loop constraint."""
    rng = np.random.default_rng(1)
    cfg = small_cfg()
    world_edges, world_surfs = make_world(rng)
    pipeline = MappingPipeline(cfg, loop_radius=2.5, loop_min_gap=2,
                               optimize_every=100)

    xs = [0, 2, 4, 6, 4, 2, 0.2]  # out and back along x
    for x in xs:
        pose = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                    t=jnp.asarray([x, 0.0, 0.0], jnp.float32))
        e, s = sample_scan_features(world_edges, world_surfs, pose, rng,
                                    n_e=200, n_s=500)
        e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
        s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
        pipeline.process_scan(e_pts, e_valid, s_pts, s_valid)

    n_kf = len(pipeline.keyframes)
    n_chain = n_kf - 1
    assert len(pipeline.constraints) > n_chain, (
        "no loop constraint added", n_kf, len(pipeline.constraints))


def test_ply_export(tmp_path):
    from lidar_feature_extraction_tpu.utils.visualize import (
        export_trajectory, save_ply)

    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    p1 = str(tmp_path / "a.ply")
    save_ply(p1, pts)
    head = open(p1, "rb").read(200).decode("ascii", errors="replace")
    assert "element vertex 50" in head
    rgb = np.full((50, 3), 128, np.uint8)
    p2 = str(tmp_path / "b.ply")
    save_ply(p2, pts, rgb)
    assert "property uchar red" in open(p2, "rb").read(300).decode(
        "ascii", errors="replace")
    export_trajectory(str(tmp_path / "t.ply"), pts)


def test_false_loop_closure_rejected():
    """A loop candidate whose features come from UNRELATED geometry must
    be rejected by the acceptance gate (convergence + inlier fraction,
    slam.py _register_to_keyframe), leaving constraints and the
    optimized trajectory untouched."""
    rng = np.random.default_rng(2)
    cfg = small_cfg()
    world_edges, world_surfs = make_world(rng)
    pipeline = MappingPipeline(cfg, loop_radius=2.5, loop_min_gap=2,
                               optimize_every=100)

    for x in [0, 1.5, 3.0, 4.5, 6.0]:
        pose = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                    t=jnp.asarray([x, 0.0, 0.0], jnp.float32))
        e, s = sample_scan_features(world_edges, world_surfs, pose, rng,
                                    n_e=200, n_s=500)
        e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
        s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
        pipeline.process_scan(e_pts, e_valid, s_pts, s_valid)

    pipeline.optimize()
    traj_before = pipeline.trajectory.copy()
    n_cons = len(pipeline.constraints)

    # Forge a revisit: a keyframe claiming to sit next to keyframe 0,
    # but carrying features sampled from a DIFFERENT world — the
    # registration either fails to converge or converges onto aliased
    # geometry with a poor inlier fraction.
    other_edges, other_surfs = make_world(np.random.default_rng(77))
    fake_pose = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                     t=jnp.asarray([0.5, 0.5, 0.0], jnp.float32))
    e, s = sample_scan_features(other_edges, other_surfs, fake_pose, rng,
                                n_e=200, n_s=500)
    e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
    s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
    from lidar_feature_extraction_tpu.pipeline.slam import Keyframe
    fake_kf = Keyframe(pose=fake_pose, edge_pts=e_pts, edge_valid=e_valid,
                       surf_pts=s_pts, surf_valid=s_valid, stamp=99.0)
    pipeline.keyframes.append(fake_kf)
    accepted = pipeline._try_loop_closure(len(pipeline.keyframes) - 1)
    pipeline.keyframes.pop()

    assert not accepted
    assert len(pipeline.constraints) == n_cons
    pipeline.optimize()
    np.testing.assert_allclose(pipeline.trajectory, traj_before,
                               atol=1e-5)


def test_pose_graph_robust_kernel_resists_outlier_constraint():
    """One wrong relative-pose constraint injected into a clean chain:
    with the Huber kernel the optimized trajectory stays near ground
    truth; without it the outlier visibly drags the graph."""
    from lidar_feature_extraction_tpu.parallel.pose_graph import (
        Constraints, PoseGraph, optimize_pose_graph)

    k = 8
    gt_t = np.stack([np.arange(k, dtype=np.float32),
                     np.zeros(k, np.float32),
                     np.zeros(k, np.float32)], axis=-1)
    ident = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (k, 1))
    graph = PoseGraph(poses_q=jnp.asarray(ident),
                      poses_t=jnp.asarray(gt_t))

    # Chain constraints: exact unit steps. Outlier: claims keyframe 6
    # sits at keyframe 1's position + 3 m lateral (a false closure that
    # passed no gate).
    i = list(range(k - 1)) + [1]
    j = list(range(1, k)) + [6]
    z_t = [[1.0, 0.0, 0.0]] * (k - 1) + [[0.0, 3.0, 0.0]]
    z_q = [[1.0, 0.0, 0.0, 0.0]] * k
    cons = Constraints(i=jnp.asarray(i, jnp.int32),
                       j=jnp.asarray(j, jnp.int32),
                       z_q=jnp.asarray(z_q, jnp.float32),
                       z_t=jnp.asarray(z_t, jnp.float32),
                       weight=jnp.ones(k, jnp.float32))

    robust = optimize_pose_graph(graph, cons, n_iterations=15,
                                 robust_delta=0.5)
    naive = optimize_pose_graph(graph, cons, n_iterations=15)

    err_robust = np.abs(np.asarray(robust.poses_t) - gt_t).max()
    err_naive = np.abs(np.asarray(naive.poses_t) - gt_t).max()
    assert err_robust < 0.15, err_robust
    assert err_naive > 2 * err_robust, (err_naive, err_robust)


def test_bounded_backend_window_and_cg_match_dense():
    """mapping.max_keyframes bounds the optimized window and the CG
    solver auto-selects past dense_solver_max_keyframes; on a clean
    drive the bounded pipeline's trajectory matches the unbounded
    dense one."""
    import dataclasses

    rng = np.random.default_rng(4)
    cfg = small_cfg()
    cfg_bounded = dataclasses.replace(
        cfg, mapping=dataclasses.replace(cfg.mapping, max_keyframes=6))
    world_edges, world_surfs = make_world(rng)

    def drive(pipeline, seed):
        r = np.random.default_rng(seed)
        for x in range(14):
            pose = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                        t=jnp.asarray([float(x), 0.0, 0.0], jnp.float32))
            e, s = sample_scan_features(world_edges, world_surfs, pose,
                                        r, n_e=200, n_s=500)
            e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
            s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
            pipeline.process_scan(e_pts, e_valid, s_pts, s_valid)
        pipeline.optimize()
        return pipeline.trajectory

    dense = MappingPipeline(cfg, loop_min_gap=99, optimize_every=5)
    bounded = MappingPipeline(cfg_bounded, loop_min_gap=99,
                              optimize_every=5,
                              dense_solver_max_keyframes=0)  # force CG
    t_dense = drive(dense, 11)
    t_bounded = drive(bounded, 11)

    assert len(dense.keyframes) == len(bounded.keyframes) >= 8
    # Both track the straight drive (keyframes on the y=z=0 line at
    # integer-ish x), and the window bound costs nothing on a clean
    # chain: the two trajectories agree.
    gt = np.stack([np.asarray([float(x), 0, 0]) for x in range(14)])
    for traj in (t_dense, t_bounded):
        for p in traj:
            assert np.linalg.norm(gt - p, axis=-1).min() < 0.2, p
    np.testing.assert_allclose(t_bounded, t_dense, atol=0.1)


def test_mapping_checkpoint_resume(tmp_path):
    """Run 8 scans, checkpoint, resume, run 8 more: the resumed
    pipeline's trajectory (and graph bookkeeping) must equal the
    unbroken 16-scan run's (SURVEY.md §5 resume-mid-sequence plan)."""
    from lidar_feature_extraction_tpu.pipeline.slam import Keyframe  # noqa

    rng_world = np.random.default_rng(5)
    cfg = small_cfg()
    world_edges, world_surfs = make_world(rng_world)

    def scans(seed, n):
        r = np.random.default_rng(seed)
        out = []
        for x in range(n):
            pose = Pose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                        t=jnp.asarray([float(x), 0.0, 0.0], jnp.float32))
            e, s = sample_scan_features(world_edges, world_surfs, pose,
                                        r, n_e=200, n_s=500)
            e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
            s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
            out.append((e_pts, e_valid, s_pts, s_valid, float(x) * 0.1))
        return out

    all_scans = scans(21, 16)
    kwargs = dict(loop_min_gap=99, optimize_every=6)

    unbroken = MappingPipeline(cfg, **kwargs)
    for e_pts, e_valid, s_pts, s_valid, stamp in all_scans:
        unbroken.process_scan(e_pts, e_valid, s_pts, s_valid, stamp=stamp)

    first = MappingPipeline(cfg, **kwargs)
    for e_pts, e_valid, s_pts, s_valid, stamp in all_scans[:8]:
        first.process_scan(e_pts, e_valid, s_pts, s_valid, stamp=stamp)
    path = str(tmp_path / "slam_ckpt.npz")
    first.save_checkpoint(path)

    resumed = MappingPipeline.restore(path, cfg, **kwargs)
    for e_pts, e_valid, s_pts, s_valid, stamp in all_scans[8:]:
        resumed.process_scan(e_pts, e_valid, s_pts, s_valid, stamp=stamp)

    assert len(resumed.keyframes) == len(unbroken.keyframes)
    assert len(resumed.constraints) == len(unbroken.constraints)
    np.testing.assert_allclose(resumed.trajectory, unbroken.trajectory,
                               atol=1e-4)
