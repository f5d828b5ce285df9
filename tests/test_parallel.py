"""Multi-device tests on the 8-device virtual CPU mesh: data-parallel
batched localization and the distributed pose-graph optimizer (psum over
the mesh) must match single-device results."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.parallel.mesh import make_mesh
from lidar_feature_extraction_tpu.parallel.pose_graph import (
    Constraints, PoseGraph, constraint_residual,
    make_distributed_pose_graph_optimizer, optimize_pose_graph,
    optimize_pose_graph_cg)


def chain_graph(rng, k, noise=0.1):
    """Ground-truth chain of poses + noisy initial guesses + exact
    odometry constraints."""
    qs, ts = [jnp.asarray([1.0, 0, 0, 0])], [jnp.zeros(3)]
    for _ in range(k - 1):
        dq = quat.exp_so3(jnp.asarray(rng.normal(scale=0.1, size=3)))
        dt = jnp.asarray(rng.normal(scale=1.0, size=3))
        qs.append(quat.quat_normalize(quat.quat_multiply(qs[-1], dq)))
        ts.append(ts[-1] + quat.quat_rotate(qs[-1], dt))
    q_true = jnp.stack(qs).astype(jnp.float32)
    t_true = jnp.stack(ts).astype(jnp.float32)

    # constraints: consecutive relative poses (exact)
    i = jnp.arange(k - 1, dtype=jnp.int32)
    j = i + 1
    zq = quat.quat_normalize(quat.quat_multiply(
        quat.quat_conjugate(q_true[i]), q_true[j]))
    zt = quat.quat_rotate(quat.quat_conjugate(q_true[i]),
                          t_true[j] - t_true[i])
    cons = Constraints(i=i, j=j, z_q=zq, z_t=zt,
                       weight=jnp.ones(k - 1, jnp.float32))

    # noisy initialization (keep pose 0 exact: it is gauge-fixed)
    qn = np.asarray(q_true).copy()
    tn = np.asarray(t_true).copy()
    for idx in range(1, k):
        dq = np.asarray(quat.exp_so3(jnp.asarray(
            rng.normal(scale=noise, size=3))))
        qn[idx] = np.asarray(quat.quat_multiply(jnp.asarray(qn[idx]),
                                                jnp.asarray(dq)))
        tn[idx] += rng.normal(scale=noise, size=3)
    init = PoseGraph(poses_q=jnp.asarray(qn, jnp.float32),
                     poses_t=jnp.asarray(tn, jnp.float32))
    truth = PoseGraph(poses_q=q_true, poses_t=t_true)
    return init, truth, cons


def test_constraint_residual_zero_at_truth():
    rng = np.random.default_rng(0)
    _, truth, cons = chain_graph(rng, 8)
    r = jax.vmap(constraint_residual)(
        truth.poses_q[cons.i], truth.poses_t[cons.i],
        truth.poses_q[cons.j], truth.poses_t[cons.j],
        cons.z_q, cons.z_t)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-5)


def test_single_device_pose_graph_converges():
    rng = np.random.default_rng(1)
    init, truth, cons = chain_graph(rng, 12)
    out = optimize_pose_graph(init, cons, n_iterations=15)
    np.testing.assert_allclose(np.asarray(out.poses_t),
                               np.asarray(truth.poses_t), atol=2e-2)


def test_distributed_matches_single_device():
    n_dev = len(jax.devices())
    assert n_dev >= 8, "conftest must provide 8 virtual devices"
    rng = np.random.default_rng(2)
    k = 12
    init, truth, cons = chain_graph(rng, k)
    # Pad constraints to a multiple of the mesh size with zero-weight
    # lanes (sharding requires even division).
    m = len(np.asarray(cons.i))
    pad = (-m) % 8
    cons_p = Constraints(
        i=jnp.concatenate([cons.i, jnp.zeros(pad, jnp.int32)]),
        j=jnp.concatenate([cons.j, jnp.ones(pad, jnp.int32)]),
        z_q=jnp.concatenate([cons.z_q, jnp.tile(
            jnp.asarray([[1.0, 0, 0, 0]], jnp.float32), (pad, 1))]),
        z_t=jnp.concatenate([cons.z_t, jnp.zeros((pad, 3), jnp.float32)]),
        weight=jnp.concatenate([cons.weight, jnp.zeros(pad, jnp.float32)]))

    mesh = make_mesh(8)
    run = make_distributed_pose_graph_optimizer(mesh, k)
    out_dist = run(init, cons_p)
    out_single = optimize_pose_graph(init, cons_p)

    np.testing.assert_allclose(np.asarray(out_dist.poses_t),
                               np.asarray(out_single.poses_t),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(out_dist.poses_t),
                               np.asarray(truth.poses_t), atol=2e-2)


def test_cg_matches_dense_solver():
    """The matrix-free preconditioned-CG optimizer must land on the
    same solution as the dense [6K, 6K] solve (same linearization, same
    normal equations — only the inner linear solver differs)."""
    rng = np.random.default_rng(5)
    init, truth, cons = chain_graph(rng, 20)
    out_dense = optimize_pose_graph(init, cons, n_iterations=10)
    out_cg = optimize_pose_graph_cg(init, cons, n_iterations=10,
                                    n_cg=80)
    np.testing.assert_allclose(np.asarray(out_cg.poses_t),
                               np.asarray(out_dense.poses_t), atol=2e-3)
    np.testing.assert_allclose(np.asarray(out_cg.poses_t),
                               np.asarray(truth.poses_t), atol=3e-2)


def test_cg_scales_past_dense_comfort_zone():
    """A 1500-keyframe chain: the dense path would build a 9000x9000
    Hessian per iteration; CG runs it in [M,6,6] blocks. Converges to
    the ground-truth chain."""
    rng = np.random.default_rng(6)
    init, truth, cons = chain_graph(rng, 1500, noise=0.05)
    out = optimize_pose_graph_cg(init, cons, n_iterations=4, n_cg=200)
    err = np.linalg.norm(
        np.asarray(out.poses_t) - np.asarray(truth.poses_t), axis=-1)
    assert err.max() < 0.05, err.max()


def test_distributed_cg_matches_single_device():
    n_dev = len(jax.devices())
    assert n_dev >= 8
    rng = np.random.default_rng(7)
    k = 16
    init, truth, cons = chain_graph(rng, k)
    m = len(np.asarray(cons.i))
    pad = (-m) % 8
    cons_p = Constraints(
        i=jnp.concatenate([cons.i, jnp.zeros(pad, jnp.int32)]),
        j=jnp.concatenate([cons.j, jnp.ones(pad, jnp.int32)]),
        z_q=jnp.concatenate([cons.z_q, jnp.tile(
            jnp.asarray([[1.0, 0, 0, 0]], jnp.float32), (pad, 1))]),
        z_t=jnp.concatenate([cons.z_t, jnp.zeros((pad, 3), jnp.float32)]),
        weight=jnp.concatenate([cons.weight, jnp.zeros(pad, jnp.float32)]))
    mesh = make_mesh(8)
    run = make_distributed_pose_graph_optimizer(mesh, k, solver="cg")
    out_dist = run(init, cons_p)
    out_single = optimize_pose_graph_cg(init, cons_p)
    np.testing.assert_allclose(np.asarray(out_dist.poses_t),
                               np.asarray(out_single.poses_t), atol=1e-3)
    np.testing.assert_allclose(np.asarray(out_dist.poses_t),
                               np.asarray(truth.poses_t), atol=3e-2)


def test_zero_weight_lanes_are_inert():
    rng = np.random.default_rng(3)
    init, _, cons = chain_graph(rng, 8)
    out1 = optimize_pose_graph(init, cons, n_iterations=5)
    # Append garbage constraints with weight 0.
    garbage = Constraints(
        i=jnp.concatenate([cons.i, jnp.asarray([0, 3], jnp.int32)]),
        j=jnp.concatenate([cons.j, jnp.asarray([5, 6], jnp.int32)]),
        z_q=jnp.concatenate([cons.z_q, jnp.asarray(
            [[0.0, 1.0, 0, 0], [0.5, 0.5, 0.5, 0.5]], jnp.float32)]),
        z_t=jnp.concatenate([cons.z_t,
                             jnp.full((2, 3), 99.0, jnp.float32)]),
        weight=jnp.concatenate([cons.weight, jnp.zeros(2, jnp.float32)]))
    out2 = optimize_pose_graph(init, garbage, n_iterations=5)
    np.testing.assert_allclose(np.asarray(out1.poses_t),
                               np.asarray(out2.poses_t), atol=1e-6)


def test_anisotropic_constraint_info_bends_only_constrained_axes():
    """A corridor-like loop closure — well-constrained cross-track (y),
    degenerate along-track (x) — must bend the graph along y but leave
    x essentially untouched; the same closure with isotropic info drags
    x toward its (wrong) along-track claim."""
    k = 8
    ident = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (k, 1))
    gt_t = np.stack([np.arange(k, dtype=np.float32),
                     np.zeros(k, np.float32),
                     np.zeros(k, np.float32)], axis=-1)
    graph = PoseGraph(poses_q=jnp.asarray(ident),
                      poses_t=jnp.asarray(gt_t))

    # Chain: exact unit x steps. Closure 1->6: claims (3, 1, 0) —
    # wrong by -2 along x, +1 along y.
    i = list(range(k - 1)) + [1]
    j = list(range(1, k)) + [6]
    z_t = [[1.0, 0.0, 0.0]] * (k - 1) + [[3.0, 1.0, 0.0]]
    z_q = [[1.0, 0.0, 0.0, 0.0]] * k
    base = dict(i=jnp.asarray(i, jnp.int32), j=jnp.asarray(j, jnp.int32),
                z_q=jnp.asarray(z_q, jnp.float32),
                z_t=jnp.asarray(z_t, jnp.float32),
                weight=jnp.ones(k, jnp.float32))

    # Corridor info on the closure: x-translation dead, y/z + rot live.
    info = np.tile(np.eye(6, dtype=np.float32), (k, 1, 1))
    info[-1, 3, 3] = 1e-4
    aniso = optimize_pose_graph(
        graph, Constraints(info=jnp.asarray(info), **base),
        n_iterations=10)
    iso = optimize_pose_graph(graph, Constraints(**base),
                              n_iterations=10)

    t_a = np.asarray(aniso.poses_t)
    t_i = np.asarray(iso.poses_t)
    # Anisotropic: pose 6 stays put along x, moves along y.
    assert abs(t_a[6, 0] - 6.0) < 0.1, t_a[6]
    assert t_a[6, 1] > 0.2, t_a[6]
    # Isotropic: the wrong along-track claim visibly drags x.
    assert abs(t_i[6, 0] - 6.0) > 0.5, t_i[6]

    # CG solver agrees with the dense solver under anisotropic info.
    cg = optimize_pose_graph_cg(
        graph, Constraints(info=jnp.asarray(info), **base),
        n_iterations=10)
    np.testing.assert_allclose(np.asarray(cg.poses_t), t_a, atol=5e-3)


def test_distributed_imu_graph_matches_single_device():
    """optimize_imu_graph under shard_map (factors + constraints
    sharded, REAL non-zero bias Jacobians from actual preintegration,
    an injected gyro bias to recover) must match the single-device
    result bit-for-tolerance: poses, velocities, and the decoupled
    rotation-only bias estimate all reduce through psums."""
    from functools import partial

    from jax.sharding import NamedSharding, PartitionSpec as P
    from lidar_feature_extraction_tpu.core.pose import Pose
    from lidar_feature_extraction_tpu.fusion import imu as imu_mod
    from lidar_feature_extraction_tpu.parallel.imu_graph import (
        ImuFactors, ImuGraph, optimize_imu_graph,
        weights_from_covariance)

    assert len(jax.devices()) >= 8

    # Arc trajectory + synthesized IMU with an injected gyro bias.
    n, dt, kf_every = 121, 0.05, 10
    speed, radius = 2.0, 20.0
    s = speed * dt * np.arange(n)
    theta = s / radius
    t_true = np.stack([radius * np.sin(theta),
                       radius * (1 - np.cos(theta)),
                       np.zeros(n)], axis=-1).astype(np.float32)
    q_true = np.stack([np.asarray(quat.exp_so3(
        jnp.asarray([0.0, 0.0, th], jnp.float32))) for th in theta])
    q_true = jnp.asarray(q_true)
    t_true = jnp.asarray(t_true)
    gyro, accel, dts, _ = imu_mod.synthesize_imu(q_true, t_true, dt)
    bg_true = jnp.asarray([0.01, -0.008, 0.02], jnp.float32)
    gyro = gyro + bg_true

    kf = list(range(0, n, kf_every))
    k = len(kf)
    zero = jnp.zeros(3)
    rels = [Pose(q_true[a], t_true[a]).inverse().compose(
        Pose(q_true[b], t_true[b])) for a, b in zip(kf[:-1], kf[1:])]
    pres = [imu_mod.preintegrate(gyro[a:b], accel[a:b], dts[a:b],
                                 zero, zero)
            for a, b in zip(kf[:-1], kf[1:])]
    m = k - 1
    pad = (-m) % 8
    w_rot, w_vel, w_pos = weights_from_covariance(
        jnp.stack([p.cov for p in pres]))

    def padded(x, fill=0.0):
        x = jnp.asarray(x)
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])

    ident_q = jnp.asarray([1.0, 0, 0, 0], jnp.float32)
    cons = Constraints(
        i=padded(jnp.arange(m, dtype=jnp.int32)),
        j=padded(jnp.arange(1, k, dtype=jnp.int32), 1),
        z_q=jnp.concatenate([jnp.stack([r.q for r in rels]),
                             jnp.tile(ident_q[None], (pad, 1))]),
        z_t=padded(jnp.stack([r.t for r in rels])),
        weight=padded(jnp.ones(m, jnp.float32)),
        info=padded(jnp.tile(jnp.eye(6, dtype=jnp.float32)[None],
                             (m, 1, 1))))
    imu = ImuFactors(
        i=cons.i, j=cons.j,
        dq=jnp.concatenate([jnp.stack([p.dq for p in pres]),
                            jnp.tile(ident_q[None], (pad, 1))]),
        dv=padded(jnp.stack([p.dv for p in pres])),
        dp=padded(jnp.stack([p.dp for p in pres])),
        dt=padded(jnp.stack([p.dt for p in pres])),
        w_rot=padded(w_rot), w_vel=padded(w_vel), w_pos=padded(w_pos),
        weight=padded(jnp.ones(m, jnp.float32)),
        dq_dbg=padded(jnp.stack([p.dq_dbg for p in pres])),
        dv_dbg=padded(jnp.stack([p.dv_dbg for p in pres])),
        dv_dba=padded(jnp.stack([p.dv_dba for p in pres])),
        dp_dbg=padded(jnp.stack([p.dp_dbg for p in pres])),
        dp_dba=padded(jnp.stack([p.dp_dba for p in pres])))

    idx = jnp.asarray(kf)
    v_init = jnp.asarray(np.gradient(np.asarray(t_true)[kf], axis=0)
                         / (kf_every * dt), jnp.float32)
    graph = ImuGraph(poses_q=q_true[idx], poses_t=t_true[idx],
                     vels=v_init, bg=jnp.zeros(3), ba=None)

    single = optimize_imu_graph(graph, cons, imu, n_iterations=10)

    mesh = make_mesh(8)
    shard_f = jax.tree.map(lambda _: P("data"), imu)
    shard_c = jax.tree.map(lambda _: P("data"), cons)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), shard_f, shard_c), out_specs=P(),
             check_vma=False)
    def _opt(g, f, c):
        return optimize_imu_graph(g, c, f, n_iterations=10,
                                  axis_name="data")

    g_rep = jax.device_put(graph, NamedSharding(mesh, P()))
    f_sh = jax.device_put(imu, NamedSharding(mesh, P("data")))
    c_sh = jax.device_put(cons, NamedSharding(mesh, P("data")))
    dist = jax.jit(_opt)(g_rep, f_sh, c_sh)

    # The recovered bias is real (close to the injected one) ...
    np.testing.assert_allclose(np.asarray(single.bg),
                               np.asarray(bg_true), atol=0.004)
    # ... and the sharded reduction reproduces the single-device
    # optimization on every state component.
    np.testing.assert_allclose(np.asarray(dist.bg),
                               np.asarray(single.bg), atol=1e-5)
    # f32 psum accumulation order differs from the single-device sum;
    # same tolerance as test_distributed_matches_single_device.
    np.testing.assert_allclose(np.asarray(dist.poses_t),
                               np.asarray(single.poses_t), atol=1e-3)
    np.testing.assert_allclose(np.asarray(dist.vels),
                               np.asarray(single.vels), atol=3e-3)
