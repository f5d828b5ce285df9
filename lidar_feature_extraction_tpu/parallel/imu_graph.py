"""IMU-aware keyframe graph: poses + velocities, relative-pose
constraints AND preintegrated-IMU factor blocks.

The reference intended IMU integration but shipped a stub
(``imu_integration/include/imu_integration/integration.hpp:30-33``,
SURVEY.md §2.6); its LIO-SAM lineage puts preintegrated IMU factors
between keyframes of a pose graph. This module is that back-end,
Array-native: the state is [K] keyframes of (q, t, v) — 9-dim tangent
each — and two batched factor families linearized with ``jacfwd`` and
reduced to dense normal equations exactly like parallel/pose_graph.py
(same sharding story: factors shard on the leading axis, the global
H/g is one ``psum`` over the mesh).

Bias estimation: setting ``ImuGraph.bg`` estimates a SHARED gyro bias
by a DECOUPLED rotation-only solve (``estimate_gyro_bias``) before the
trajectory optimization — the VINS-Mono initialization scheme: the
preintegrated rotations are matched against the chain constraints'
measured relative rotations, which observe the bias independently of
the (yet-unoptimized) poses. The estimated bias is folded into the
factor deltas through the preintegration's first-order bias Jacobians
(re-linearization; fusion/imu.py stores ``dq_dbg`` etc.), and the
trajectory then optimizes over bias-consistent factors. Two earlier
JOINT formulations failed instructively: undamped joint GN ran away
along the flat bias<->trajectory direction (0.003 -> 1e8 rad/s), and a
Levenberg-Marquardt joint solve walked the same flat direction to a
model-error-determined phantom minimum (0.06 rad/s spurious bias on a
zero-bias drive). Decoupling removes that direction outright: rotation
discrepancy between gyro and chain is the one robustly-observable bias
signal, and it does not bend the trajectory while being read.

``ImuGraph.ba`` is carried as a fixed linearization input (folded into
the deltas, never estimated): accel bias is weakly observable on short
planar segments and otherwise absorbs accel model error — holding it
at zero is the robust default. The EKF's yaw-bias state
(ekf_localizer.hpp:141-171) still covers the online localization path;
this covers the mapping back-end.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.fusion.imu import GRAVITY
from lidar_feature_extraction_tpu.parallel.pose_graph import (
    Constraints, constraint_residual)
from lidar_feature_extraction_tpu.core.precision import highest_precision


class ImuGraph(NamedTuple):
    poses_q: jnp.ndarray   # [K, 4]
    poses_t: jnp.ndarray   # [K, 3]
    vels: jnp.ndarray      # [K, 3] world-frame velocities
    # Shared IMU biases (arrays [3]; None disables). ``bg`` non-None
    # enables the decoupled gyro-bias estimation (see module
    # docstring); the value passed in is the current estimate RELATIVE
    # to the factors' linearization bias (the pipeline preintegrates at
    # zero bias, so it is the absolute bias there) and seeds the
    # estimator. ``ba`` is a fixed first-order correction input, not an
    # estimated state. Factors must carry their bias Jacobians
    # (ImuFactors.dq_dbg etc.) for either to take effect.
    bg: jnp.ndarray | None = None
    ba: jnp.ndarray | None = None


class ImuFactors(NamedTuple):
    """Batched preintegrated-IMU factors (fixed shape, maskable).

    dq/dv/dp/dt: stacked ``ImuPreintegration`` deltas between keyframes
    i and j. w_rot/w_vel/w_pos: per-block scalar information weights
    (1/sigma^2), typically from the preintegration covariance diagonal.
    weight == 0 masks a lane. The optional [M, 3, 3] blocks are the
    stacked first-order bias-correction Jacobians (Forster eqs. 69-71,
    fusion/imu.py preintegrate) — required for bias estimation."""

    i: jnp.ndarray        # [M]
    j: jnp.ndarray        # [M]
    dq: jnp.ndarray       # [M, 4]
    dv: jnp.ndarray       # [M, 3]
    dp: jnp.ndarray       # [M, 3]
    dt: jnp.ndarray       # [M]
    w_rot: jnp.ndarray    # [M]
    w_vel: jnp.ndarray    # [M]
    w_pos: jnp.ndarray    # [M]
    weight: jnp.ndarray   # [M] overall scale (0 masks)
    dq_dbg: jnp.ndarray | None = None
    dv_dbg: jnp.ndarray | None = None
    dv_dba: jnp.ndarray | None = None
    dp_dbg: jnp.ndarray | None = None
    dp_dba: jnp.ndarray | None = None


def imu_residual_9(qi, ti, vi, qj, tj, vj, dq, dv, dp, dt,
                   gravity=GRAVITY):
    """[9] residual (theta, v, p) of one preintegrated factor — the
    batched-graph form of fusion.imu.imu_factor_residual."""
    gravity = jnp.asarray(gravity, jnp.asarray(ti).dtype)
    qi_inv = quat.quat_conjugate(qi)
    rel_q = quat.quat_multiply(qi_inv, qj)
    r_theta = quat.log_so3(
        quat.quat_multiply(quat.quat_conjugate(dq), rel_q))
    r_v = quat.quat_rotate(qi_inv, vj - vi - gravity * dt) - dv
    r_p = quat.quat_rotate(
        qi_inv, tj - ti - vi * dt - 0.5 * gravity * dt * dt) - dp
    return jnp.concatenate([r_theta, r_v, r_p])


def _perturb9(q, t, v, xi):
    """Right-perturbation of a 9-dim state: (dtheta, dt_local, dv)."""
    dq = quat.exp_so3(xi[:3])
    return (quat.quat_multiply(q, dq),
            t + quat.quat_rotate(q, xi[3:6]),
            v + xi[6:9])


def _linearize_imu_one(qi, ti, vi, qj, tj, vj, dq, dv, dp, dt):
    r = imu_residual_9(qi, ti, vi, qj, tj, vj, dq, dv, dp, dt)

    def fi(xi):
        q2, t2, v2 = _perturb9(qi, ti, vi, xi)
        return imu_residual_9(q2, t2, v2, qj, tj, vj, dq, dv, dp, dt)

    def fj(xi):
        q2, t2, v2 = _perturb9(qj, tj, vj, xi)
        return imu_residual_9(qi, ti, vi, q2, t2, v2, dq, dv, dp, dt)

    zero = jnp.zeros(9, qi.dtype)
    return r, jax.jacfwd(fi)(zero), jax.jacfwd(fj)(zero)


_linearize_imu = jax.vmap(_linearize_imu_one)


def _linearize_pose_one(qi, ti, qj, tj, z_q, z_t):
    r = constraint_residual(qi, ti, qj, tj, z_q, z_t)

    def fi(xi):
        q2, t2, _ = _perturb9(qi, ti, jnp.zeros(3, qi.dtype), xi)
        return constraint_residual(q2, t2, qj, tj, z_q, z_t)

    def fj(xi):
        q2, t2, _ = _perturb9(qj, tj, jnp.zeros(3, qi.dtype), xi)
        return constraint_residual(qi, ti, q2, t2, z_q, z_t)

    zero = jnp.zeros(9, qi.dtype)
    return r, jax.jacfwd(fi)(zero), jax.jacfwd(fj)(zero)


_linearize_pose = jax.vmap(_linearize_pose_one)


@highest_precision
def _scatter(h, g, bi, bj, r, ji, jj, wji, wjj):
    """Accumulate one factor family's weighted blocks into H [9K, 9K],
    g [9K]. ji/jj: [M, D, 9] raw Jacobians; wji/wjj: the same blocks
    pre-multiplied by the factor's (possibly non-diagonal) information
    Lambda: wji = Lambda @ ji — so H_ii = ji^T Lambda ji etc."""
    hii = jnp.einsum("mki,mkj->mij", wji, ji)
    hij = jnp.einsum("mki,mkj->mij", wji, jj)
    hjj = jnp.einsum("mki,mkj->mij", wjj, jj)
    gi = jnp.einsum("mki,mk->mi", wji, r)
    gj = jnp.einsum("mki,mk->mi", wjj, r)

    def block(h, bi, bj, blocks):
        rows = bi[:, None] * 9 + jnp.arange(9)[None, :]
        cols = bj[:, None] * 9 + jnp.arange(9)[None, :]
        rr = jnp.repeat(rows[:, :, None], 9, axis=2)
        cc = jnp.repeat(cols[:, None, :], 9, axis=1)
        return h.at[rr, cc].add(blocks)

    h = block(h, bi, bi, hii)
    h = block(h, bi, bj, hij)
    h = block(h, bj, bi, jnp.swapaxes(hij, 1, 2))
    h = block(h, bj, bj, hjj)
    g = g.at[bi[:, None] * 9 + jnp.arange(9)[None, :]].add(gi)
    g = g.at[bj[:, None] * 9 + jnp.arange(9)[None, :]].add(gj)
    return h, g


@highest_precision
def fold_bias_into_factors(imu: ImuFactors, dbg, dba) -> ImuFactors:
    """Move the factors' linearization point by (dbg, dba) through the
    stored first-order Jacobians (Forster eq. 44; re-linearization
    without re-integration — the Jacobians' own bias dependence is
    second order). Returns factors whose deltas are consistent with the
    shifted bias, with the Jacobians preserved for further shifts."""
    dq2 = quat.quat_normalize(quat.quat_multiply(
        imu.dq, jax.vmap(quat.exp_so3)(
            jnp.einsum("mij,j->mi", imu.dq_dbg, dbg))))
    dv2 = imu.dv + jnp.einsum("mij,j->mi", imu.dv_dbg, dbg) \
        + jnp.einsum("mij,j->mi", imu.dv_dba, dba)
    dp2 = imu.dp + jnp.einsum("mij,j->mi", imu.dp_dbg, dbg) \
        + jnp.einsum("mij,j->mi", imu.dp_dba, dba)
    return imu._replace(dq=dq2, dv=dv2, dp=dp2)


@highest_precision
def estimate_gyro_bias(imu: ImuFactors, cons: Constraints,
                       bg0=None,
                       prior_weight: float = 2500.0,
                       n_iterations: int = 8,
                       axis_name: str | None = None) -> jnp.ndarray:
    """Decoupled rotation-only gyro-bias estimate (VINS-Mono
    initialization scheme): solve

        min_bg  sum_m w_m || log( (dq_m * exp(J_m bg))^-1 * z_q_m ) ||^2
                + prior_weight * ||bg||^2

    where z_q_m is the measured relative rotation of the CHAIN
    constraint joining the same keyframe pair (i_m, j_m) — scan-matcher
    evidence that observes the bias independently of the graph's pose
    state. Factors with no matching constraint drop out. This is the
    one robustly-observable bias signal: a joint (trajectory, bias)
    solve has a near-flat coupled direction whose minimum is set by
    accel model error, and it walks there (measured: 0.06 rad/s phantom
    z-bias on a zero-bias drive) — the rotation match has no such
    direction.

    ``prior_weight`` is a physical zero-bias prior, 1/sigma_bg^2
    (default (0.02 rad/s)^-2, consumer-MEMS scale). A real bias
    overwhelms it quickly: its evidence curvature is
    sum_m w_rot_m * T_m^2 — with capped w_rot = 1e5 and 0.1 s keyframe
    intervals, ~40x the prior within 40 keyframes.

    Under ``axis_name`` (inside shard_map, factors and constraints
    sharded on the leading axis) the 3x3 normal equations are psummed;
    each IMU factor's matching chain constraint must live on the same
    shard (the pipeline emits them in lockstep, so identical sharding
    specs guarantee it)."""
    dtype = imu.dq.dtype
    if bg0 is None:
        bg0 = jnp.zeros(3, dtype)

    # Match each factor to the chain constraint over the same pair.
    same = (cons.i[None, :] == imu.i[:, None]) \
        & (cons.j[None, :] == imu.j[:, None]) \
        & (cons.weight[None, :] > 0)
    has = jnp.any(same, axis=1)
    idx = jnp.argmax(same, axis=1)
    z_q = cons.z_q[idx]                               # [M, 4]
    w = imu.weight * imu.w_rot * has.astype(dtype)    # [M]

    def residual_one(dq, j_dbg, z, bg):
        dq_b = quat.quat_multiply(dq, quat.exp_so3(j_dbg @ bg))
        return quat.log_so3(
            quat.quat_multiply(quat.quat_conjugate(dq_b), z))

    def linearize_one(dq, j_dbg, z, bg):
        r = residual_one(dq, j_dbg, z, bg)
        j = jax.jacfwd(lambda b: residual_one(dq, j_dbg, z, b))(bg)
        return r, j

    linearize = jax.vmap(linearize_one, in_axes=(0, 0, 0, None))
    eye = jnp.eye(3, dtype=dtype)

    def newton(_, bg):
        r, j = linearize(imu.dq, imu.dq_dbg, z_q, bg)
        h = jnp.einsum("mki,m,mkj->ij", j, w, j)
        g = jnp.einsum("mki,m,mk->i", j, w, r)
        if axis_name is not None:
            h = jax.lax.psum(h, axis_name)
            g = jax.lax.psum(g, axis_name)
        h = h + prior_weight * eye
        g = g + prior_weight * bg
        return bg - jnp.linalg.solve(h, g)

    return jax.lax.fori_loop(0, n_iterations, newton, bg0)


@highest_precision
def optimize_imu_graph(graph: ImuGraph, cons: Constraints | None,
                       imu: ImuFactors | None,
                       n_iterations: int = 10,
                       prior_weight: float = 1e6,
                       damping: float = 1e-4,
                       robust_delta: float | None = None,
                       bias_prior_weight: float = 2500.0,
                       axis_name: str | None = None) -> ImuGraph:
    """Gauss-Newton over (pose, velocity) keyframe states with
    relative-pose constraints and IMU factors. Semantics mirror
    ``optimize_pose_graph`` (gauge prior on pose 0, Levenberg damping,
    optional Geman-McClure kernel on the pose constraints, optional
    ``psum`` sharding over ``axis_name``).

    When ``graph.bg`` is set (and the factors carry bias Jacobians)
    the shared gyro bias is first estimated by the decoupled
    rotation-only solve (``estimate_gyro_bias``, seeded with the
    incoming ``bg``) and folded into the factor deltas
    (``fold_bias_into_factors``); the trajectory optimization then
    runs over bias-consistent factors — the LIO-SAM-style estimation
    the reference's stubbed imu_integration intended, in the
    decoupled form that is immune to the joint problem's flat
    bias<->trajectory direction (see module docstring for the two
    failure modes this replaces). A non-None ``ba`` is folded in as a
    fixed correction, never estimated."""
    k = graph.poses_q.shape[0]
    k9 = 9 * k
    dtype = graph.poses_t.dtype
    dim = k9

    # Canonicalize factor/constraint floats to the graph dtype: under
    # jax_enable_x64 host-built float64 factors would otherwise scatter
    # into the f32 normal equations (a FutureWarning today, an error in
    # future JAX) and silently double the solve's memory.
    def _cast_floats(nt):
        return None if nt is None else jax.tree.map(
            lambda a: a.astype(dtype)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, nt)

    cons = _cast_floats(cons)
    imu = _cast_floats(imu)

    have_jac = imu is not None and imu.dq_dbg is not None
    bg_out = graph.bg
    if have_jac and (graph.bg is not None or graph.ba is not None):
        zero3 = jnp.zeros(3, dtype)
        ba = zero3 if graph.ba is None else graph.ba
        if graph.bg is not None and cons is not None:
            bg_out = estimate_gyro_bias(
                imu, cons, bg0=graph.bg,
                prior_weight=bias_prior_weight, axis_name=axis_name)
        bg = zero3 if bg_out is None else bg_out
        imu = fold_bias_into_factors(imu, bg, ba)

    def _psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def _imu_w9():
        return jnp.concatenate([
            jnp.broadcast_to((imu.weight * imu.w_rot)[:, None],
                             (imu.i.shape[0], 3)),
            jnp.broadcast_to((imu.weight * imu.w_vel)[:, None],
                             (imu.i.shape[0], 3)),
            jnp.broadcast_to((imu.weight * imu.w_pos)[:, None],
                             (imu.i.shape[0], 3))], axis=-1)

    def _cost(graph, w_cons):
        """Weighted squared cost at frozen IRLS weights (psummed:
        identical on every shard, so the LM accept decision below is
        globally consistent)."""
        c = jnp.zeros((), dtype)
        if cons is not None:
            r = jax.vmap(constraint_residual)(
                graph.poses_q[cons.i], graph.poses_t[cons.i],
                graph.poses_q[cons.j], graph.poses_t[cons.j],
                cons.z_q, cons.z_t)
            if cons.info is not None:
                rr = jnp.einsum("mi,mij,mj->m", r, cons.info, r)
            else:
                rr = jnp.sum(r * r, axis=-1)
            c = c + jnp.sum(w_cons * rr)
        if imu is not None:
            r = jax.vmap(imu_residual_9)(
                graph.poses_q[imu.i], graph.poses_t[imu.i],
                graph.vels[imu.i],
                graph.poses_q[imu.j], graph.poses_t[imu.j],
                graph.vels[imu.j], imu.dq, imu.dv, imu.dp, imu.dt)
            c = c + jnp.sum(_imu_w9() * r * r)
        return _psum(c)

    def step(_, state):
        graph, lam = state
        h = jnp.zeros((dim, dim), dtype)
        g = jnp.zeros((dim,), dtype)
        w_cons = None

        if cons is not None:
            r, ji, jj = _linearize_pose(
                graph.poses_q[cons.i], graph.poses_t[cons.i],
                graph.poses_q[cons.j], graph.poses_t[cons.j],
                cons.z_q, cons.z_t)
            w_cons = cons.weight
            if robust_delta is not None:
                d2 = robust_delta * robust_delta
                r2 = jnp.sum(r * r, axis=-1)
                w_cons = w_cons * jnp.square(d2 / (d2 + r2))
            if cons.info is not None:
                lam_c = w_cons[:, None, None] * cons.info
                wji = jnp.einsum("mab,mbk->mak", lam_c, ji)
                wjj = jnp.einsum("mab,mbk->mak", lam_c, jj)
            else:
                wji = w_cons[:, None, None] * ji
                wjj = w_cons[:, None, None] * jj
            h, g = _scatter(h, g, cons.i, cons.j, r, ji, jj, wji, wjj)

        if imu is not None:
            r, ji, jj = _linearize_imu(
                graph.poses_q[imu.i], graph.poses_t[imu.i],
                graph.vels[imu.i],
                graph.poses_q[imu.j], graph.poses_t[imu.j],
                graph.vels[imu.j],
                imu.dq, imu.dv, imu.dp, imu.dt)
            w9 = _imu_w9()
            h, g = _scatter(h, g, imu.i, imu.j, r, ji, jj,
                            w9[:, :, None] * ji, w9[:, :, None] * jj)

        h = _psum(h)
        g = _psum(g)

        prior = jnp.zeros(dim, dtype).at[:6].set(prior_weight)
        h = h + jnp.diag(prior + damping)
        # Jacobi equilibration: the raw system spans ~10 orders of
        # magnitude (gauge prior 1e6, IMU information ~1e5, damping
        # 1e-4) — beyond f32 solve precision; symmetric diagonal
        # scaling brings the condition number back into range. The
        # Levenberg-Marquardt ``lam`` rides on the equilibrated
        # (unit-diagonal) system: an accept/reject trust region that
        # keeps metrically-weighted IMU factors from throwing the
        # Gauss-Newton step outside its quadratic basin (a plain-GN
        # blow-up observed with large folded biases) without ever
        # changing the converged fixed point.
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(h), 1e-12))
        hn = h / d[:, None] / d[None, :]
        hn = hn + lam * jnp.eye(dim, dtype=dtype)
        dx = -jnp.linalg.solve(hn, g / d) / d

        xi = dx[:k9].reshape(k, 9)
        dq = quat.exp_so3(xi[:, :3])
        q2 = quat.quat_normalize(quat.quat_multiply(graph.poses_q, dq))
        t2 = graph.poses_t + quat.quat_rotate(graph.poses_q, xi[:, 3:6])
        v2 = graph.vels + xi[:, 6:9]
        cand = ImuGraph(poses_q=q2, poses_t=t2, vels=v2,
                        bg=graph.bg, ba=graph.ba)

        # Near-neutral acceptance: a hard monotone gate rejects the
        # plateau-crossing steps Gauss-Newton needs mid-GNC (measured:
        # 0.053 vs 0.009 m drive ATE), while the blow-ups this guard
        # exists for raise the cost by orders of magnitude — a 0.1%
        # slack distinguishes the two cleanly.
        accept = _cost(cand, w_cons) <= _cost(graph, w_cons) * 1.001
        out = jax.tree.map(lambda a, b: jnp.where(accept, a, b),
                           cand, graph)
        # lam stays at ZERO (pure Gauss-Newton — full steps along the
        # flat chain modes, which damping visibly slows: measured
        # 0.053 vs 0.009 m drive ATE at a constant 1e-4) until a step
        # is actually rejected; then classic LM escalation until steps
        # accept again.
        lam2 = jnp.where(accept, lam / 3.0,
                         jnp.minimum(jnp.maximum(lam * 4.0, 1e-4), 1e6))
        return out, lam2

    out, _ = jax.lax.fori_loop(
        0, n_iterations, step,
        (graph._replace(bg=bg_out), jnp.zeros((), dtype)))
    return out


def weights_from_covariance(cov: jnp.ndarray,
                            max_weight: float = 1e5) -> tuple:
    """(w_rot, w_vel, w_pos) scalar information weights from a [..., 9,
    9] preintegration covariance: inverse mean diagonal per 3-block.

    ``max_weight`` caps the information so a near-noiseless IMU cannot
    push the float32 normal equations past usable conditioning (the
    gauge prior is 1e6; weights far above it would drown it)."""
    d = jnp.diagonal(cov, axis1=-2, axis2=-1)
    eps = 1e-12
    return (jnp.minimum(1.0 / (jnp.mean(d[..., 0:3], axis=-1) + eps),
                        max_weight),
            jnp.minimum(1.0 / (jnp.mean(d[..., 3:6], axis=-1) + eps),
                        max_weight),
            jnp.minimum(1.0 / (jnp.mean(d[..., 6:9], axis=-1) + eps),
                        max_weight))
