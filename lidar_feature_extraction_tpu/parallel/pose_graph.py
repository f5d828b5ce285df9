"""Distributed keyframe pose-graph optimization.

No reference counterpart — the reference's mapping simply concatenates
scans at externally-supplied poses (``mapping/include/
lidar_feature_mapping/map.hpp:98-134``). This engine treats global
consistency as a first-class distributed workload (BASELINE.json north
star): relative-pose constraints between keyframes are sharded across
the device mesh, each device linearizes its shard, and the global
Gauss-Newton normal equations are formed with one ``psum`` over the mesh —
the Schur-complement-style reduction of landmark-free pose graphs.

State: poses [K, 7] (wxyz quaternion + translation), replicated.
Constraints: (i, j, Z_ij) with Z_ij the measured relative pose i->j,
sharded on the leading axis. Residual per constraint:
    r = log( Z_ij^{-1} * (T_i^{-1} T_j) )  in R^6 (rot, trans tangent)
Jacobians are taken w.r.t. 6-dim tangent perturbations of T_i and T_j
via jacfwd at zero — closed-form-free but exact, and fully batched.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.core.precision import highest_precision


class PoseGraph(NamedTuple):
    poses_q: jnp.ndarray   # [K, 4]
    poses_t: jnp.ndarray   # [K, 3]


class Constraints(NamedTuple):
    i: jnp.ndarray         # [M] source keyframe index
    j: jnp.ndarray         # [M] target keyframe index
    z_q: jnp.ndarray       # [M, 4] measured relative rotation
    z_t: jnp.ndarray       # [M, 3] measured relative translation
    weight: jnp.ndarray    # [M] information scale (0 masks a lane)
    # Optional [M, 6, 6] information matrices in the residual tangent
    # (rot, trans_local). Sourced from the registration's weighted
    # Gauss-Newton Hessian M^T A M (ops/gauss_newton.py; reference
    # localization/src/optimizer.cpp:40-72) so a closure that is well-
    # constrained along one axis and degenerate along another bends the
    # graph only where it has authority; the reference likewise plumbs
    # full measurement covariance into its fusion
    # (ekf_localizer/src/pose_measurement.cpp:38-55). None = isotropic
    # (scalar ``weight`` only).
    info: jnp.ndarray | None = None


def _perturb(q, t, xi):
    """Right-perturbation T * Exp(xi): xi = (dtheta, dt_local)."""
    dq = quat.exp_so3(xi[:3])
    q2 = quat.quat_multiply(q, dq)
    t2 = t + quat.quat_rotate(q, xi[3:])
    return q2, t2


def constraint_residual(qi, ti, qj, tj, z_q, z_t):
    """r = log(Z^{-1} (T_i^{-1} T_j)) in R^6."""
    rel_q = quat.quat_multiply(quat.quat_conjugate(qi), qj)
    rel_t = quat.quat_rotate(quat.quat_conjugate(qi), tj - ti)
    err_q = quat.quat_multiply(quat.quat_conjugate(z_q), rel_q)
    err_t = quat.quat_rotate(quat.quat_conjugate(z_q), rel_t - z_t)
    return jnp.concatenate([quat.log_so3(err_q), err_t])


def _linearize_one(qi, ti, qj, tj, z_q, z_t):
    """Residual + Jacobians w.r.t. tangent perturbations of T_i, T_j."""
    r = constraint_residual(qi, ti, qj, tj, z_q, z_t)

    def fi(xi):
        q2, t2 = _perturb(qi, ti, xi)
        return constraint_residual(q2, t2, qj, tj, z_q, z_t)

    def fj(xi):
        q2, t2 = _perturb(qj, tj, xi)
        return constraint_residual(qi, ti, q2, t2, z_q, z_t)

    zero = jnp.zeros(6, qi.dtype)
    ji = jax.jacfwd(fi)(zero)   # [6, 6]
    jj = jax.jacfwd(fj)(zero)   # [6, 6]
    return r, ji, jj


_linearize = jax.vmap(_linearize_one)


@highest_precision
def _local_normal_equations(graph: PoseGraph, cons: Constraints,
                            n_poses: int,
                            robust_delta: float | None = None):
    """Assemble this shard's contribution to H [6K, 6K] and g [6K].

    ``robust_delta`` applies a redescending Geman-McClure kernel on the
    6-dim residual norm (IRLS weight (d^2 / (d^2 + |r|^2))^2): a
    constraint whose residual is far beyond delta — e.g. a false loop
    closure fighting a consistent odometry chain — contributes
    essentially nothing, while consistent constraints (|r| << d) keep
    weight ~1. A bounded (Huber-style) kernel is NOT enough here: its
    weight only decays as d/|r|, so a gross outlier retains enough pull
    to visibly bend a gauge-anchored chain (lever-arm stiffness between
    two keyframes k links apart is only ~1/k)."""
    qi = graph.poses_q[cons.i]
    ti = graph.poses_t[cons.i]
    qj = graph.poses_q[cons.j]
    tj = graph.poses_t[cons.j]
    r, ji, jj = _linearize(qi, ti, qj, tj, cons.z_q, cons.z_t)
    w = cons.weight
    if robust_delta is not None:
        d2 = robust_delta * robust_delta
        r2 = jnp.sum(r * r, axis=-1)
        w = w * jnp.square(d2 / (d2 + r2))

    k6 = 6 * n_poses
    h = jnp.zeros((k6, k6), graph.poses_t.dtype)
    g = jnp.zeros((k6,), graph.poses_t.dtype)

    if cons.info is not None:
        # Anisotropic information: H_ii = Ji^T (w Lambda) Ji etc.
        # (Lambda symmetric; robust IRLS weight stays on the plain
        # residual norm so scalar-weight tuning carries over).
        lam = w[:, None, None] * cons.info
        wji = jnp.einsum("mab,mbc->mac", lam, ji)   # Lambda Ji
        wjj = jnp.einsum("mab,mbc->mac", lam, jj)
    else:
        wji = w[:, None, None] * ji
        wjj = w[:, None, None] * jj
    hii = jnp.einsum("mki,mkj->mij", wji, ji)
    hij = jnp.einsum("mki,mkj->mij", wji, jj)
    hjj = jnp.einsum("mki,mkj->mij", wjj, jj)
    gi = jnp.einsum("mki,mk->mi", wji, r)
    gj = jnp.einsum("mki,mk->mi", wjj, r)

    # Scatter 6x6 blocks: expand to row/col index grids.
    def scatter_block(h, bi, bj, blocks):
        rows = (bi[:, None] * 6 + jnp.arange(6)[None, :])  # [M, 6]
        cols = (bj[:, None] * 6 + jnp.arange(6)[None, :])
        rr = jnp.repeat(rows[:, :, None], 6, axis=2)
        cc = jnp.repeat(cols[:, None, :], 6, axis=1)
        return h.at[rr, cc].add(blocks)

    h = scatter_block(h, cons.i, cons.i, hii)
    h = scatter_block(h, cons.i, cons.j, hij)
    h = scatter_block(h, cons.j, cons.i, jnp.swapaxes(hij, 1, 2))
    h = scatter_block(h, cons.j, cons.j, hjj)
    g = g.at[(cons.i[:, None] * 6 + jnp.arange(6)[None, :])].add(gi)
    g = g.at[(cons.j[:, None] * 6 + jnp.arange(6)[None, :])].add(gj)
    return h, g


def _apply_update(graph: PoseGraph, dx: jnp.ndarray) -> PoseGraph:
    k = graph.poses_q.shape[0]
    xi = dx.reshape(k, 6)
    dq = quat.exp_so3(xi[:, :3])
    q2 = quat.quat_normalize(quat.quat_multiply(graph.poses_q, dq))
    t2 = graph.poses_t + quat.quat_rotate(graph.poses_q, xi[:, 3:])
    return PoseGraph(poses_q=q2, poses_t=t2)


def optimize_pose_graph(graph: PoseGraph, cons: Constraints,
                        n_iterations: int = 10,
                        prior_weight: float = 1e6,
                        damping: float = 1e-6,
                        axis_name: str | None = None,
                        robust_delta: float | None = None) -> PoseGraph:
    """Gauss-Newton over the whole pose graph.

    When ``axis_name`` is given the function must run inside shard_map /
    pjit with constraints sharded on the leading axis: each device
    assembles its local normal equations and the global system is the
    ``psum`` over the mesh. Pose 0 is gauge-fixed with a strong prior. ``robust_delta``
    enables Huber-IRLS down-weighting of outlier constraints (the
    weights are recomputed every iteration at the current estimate).
    """
    k = graph.poses_q.shape[0]
    k6 = 6 * k

    def step(_, graph):
        h, g = _local_normal_equations(graph, cons, k,
                                       robust_delta=robust_delta)
        if axis_name is not None:
            h = jax.lax.psum(h, axis_name)
            g = jax.lax.psum(g, axis_name)
        # Gauge prior on pose 0 + Levenberg damping.
        prior = jnp.zeros(k6, h.dtype).at[:6].set(prior_weight)
        h = h + jnp.diag(prior + damping)
        dx = -jnp.linalg.solve(h, g)
        return _apply_update(graph, dx)

    return jax.lax.fori_loop(0, n_iterations, step, graph)


@highest_precision
def optimize_pose_graph_cg(graph: PoseGraph, cons: Constraints,
                           n_iterations: int = 10,
                           n_cg: int = 50,
                           prior_weight: float = 1e6,
                           damping: float = 1e-6,
                           axis_name: str | None = None,
                           robust_delta: float | None = None) -> PoseGraph:
    """Matrix-free Gauss-Newton: the large-K companion of
    ``optimize_pose_graph``.

    The dense solver materializes H as ``[6K, 6K]`` and pays
    O((6K)^3) per iteration — fine at the mapping default
    ``max_keyframes=512``, a wall beyond a few thousand keyframes.
    This variant never forms H: each GN step solves the normal
    equations with Jacobi-preconditioned conjugate gradients, where one
    Hessian-vector product is two block-einsums plus a scatter-add —
    O(M·36 + K·6) memory, all gather/scatter/segment-sum.

    Under ``axis_name`` (inside shard_map, constraints sharded) each CG
    step psums one ``[K, 6]`` vector instead of the dense path's one
    ``[6K, 6K]`` matrix per GN step: for K=4096 that is 24K floats per
    CG iteration instead of 600M floats per GN iteration — the
    collective traffic that makes large graphs feasible.
    """
    k = graph.poses_q.shape[0]

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    # Gauge prior on pose 0 + Levenberg damping, as a [K, 6] diagonal.
    prior_diag = jnp.zeros((k, 6), graph.poses_t.dtype) \
        .at[0].set(prior_weight) + damping

    def gn_step(_, graph):
        qi = graph.poses_q[cons.i]
        ti = graph.poses_t[cons.i]
        qj = graph.poses_q[cons.j]
        tj = graph.poses_t[cons.j]
        r, ji, jj = _linearize(qi, ti, qj, tj, cons.z_q, cons.z_t)
        w = cons.weight
        if robust_delta is not None:
            d2 = robust_delta * robust_delta
            r2 = jnp.sum(r * r, axis=-1)
            w = w * jnp.square(d2 / (d2 + r2))

        if cons.info is not None:
            lam = w[:, None, None] * cons.info
            wji = jnp.einsum("mab,mbc->mac", lam, ji)   # Lambda Ji
            wjj = jnp.einsum("mab,mbc->mac", lam, jj)
        else:
            wji = w[:, None, None] * ji     # [M, 6, 6]
            wjj = w[:, None, None] * jj

        def hvp(x):                     # x: [K, 6] -> H x
            y = jnp.einsum("mab,mb->ma", ji, x[cons.i]) \
                + jnp.einsum("mab,mb->ma", jj, x[cons.j])
            out = jnp.zeros_like(x)
            out = out.at[cons.i].add(jnp.einsum("mab,ma->mb", wji, y))
            out = out.at[cons.j].add(jnp.einsum("mab,ma->mb", wjj, y))
            return psum(out) + prior_diag * x

        g = jnp.zeros((k, 6), graph.poses_t.dtype)
        g = g.at[cons.i].add(jnp.einsum("mab,ma->mb", wji, r))
        g = g.at[cons.j].add(jnp.einsum("mab,ma->mb", wjj, r))
        g = psum(g)

        # Jacobi preconditioner: diag(H) per tangent coordinate.
        dh = jnp.zeros((k, 6), graph.poses_t.dtype)
        dh = dh.at[cons.i].add(jnp.einsum("mab,mab->mb", wji, ji))
        dh = dh.at[cons.j].add(jnp.einsum("mab,mab->mb", wjj, jj))
        dh = psum(dh) + prior_diag

        def precond(x):
            return x / dh

        # CG on H dx = -g.
        b = -g
        x0 = jnp.zeros_like(b)
        r0 = b                      # b - H x0 with x0 = 0
        z0 = precond(r0)

        def cg_step(state, _):
            x, rr, z, p = state
            hp = hvp(p)
            rz = jnp.vdot(rr, z)
            alpha = rz / jnp.maximum(jnp.vdot(p, hp), 1e-30)
            x = x + alpha * p
            r_new = rr - alpha * hp
            z_new = precond(r_new)
            beta = jnp.vdot(r_new, z_new) / jnp.maximum(rz, 1e-30)
            p_new = z_new + beta * p
            return (x, r_new, z_new, p_new), None

        (dx, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, r0, z0, z0), None, length=n_cg)
        return _apply_update(graph, dx.reshape(-1))

    return jax.lax.fori_loop(0, n_iterations, gn_step, graph)


def make_distributed_pose_graph_optimizer(mesh: Mesh, n_poses: int,
                                          axis: str = "data",
                                          solver: str = "dense"):
    """jit a mesh-sharded pose-graph GN: poses replicated, constraints
    sharded. ``solver="dense"`` psums the full normal equations
    (right at mapping scale, K<=512); ``solver="cg"`` runs the
    matrix-free preconditioned-CG variant whose per-step collective is
    one [K, 6] psum (right for K in the thousands)."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), Constraints(P(axis), P(axis), P(axis), P(axis),
                                        P(axis), P(axis))),
             out_specs=P(),
             check_vma=False)
    def _opt(graph, cons):
        if solver == "cg":
            return optimize_pose_graph_cg(graph, cons, axis_name=axis)
        return optimize_pose_graph(graph, cons, axis_name=axis)

    replicated = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(axis))

    def run(graph: PoseGraph, cons: Constraints) -> PoseGraph:
        if cons.info is None:
            # Identity information == the scalar-weight path exactly;
            # materialized so the shard specs stay one fixed pytree.
            m = cons.i.shape[0]
            cons = cons._replace(info=jnp.broadcast_to(
                jnp.eye(6, dtype=cons.z_t.dtype), (m, 6, 6)))
        graph = jax.device_put(graph, replicated)
        cons = jax.device_put(cons, sharded)
        return jax.jit(_opt)(graph, cons)

    return run
