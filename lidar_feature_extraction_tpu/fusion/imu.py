"""On-manifold IMU preintegration (Forster et al., TRO 2017 style).

The reference's ``imu_integration`` package is an empty stub — a header
with no functions and a node with no subscriptions
(``imu_integration/include/imu_integration/integration.hpp:30-33``,
``imu_integration/src/integration.cpp:37-53``; its test filename
``test_rkmk.cpp`` hints at planned Runge-Kutta-Munthe-Kaas integration,
SURVEY.md §2.6). The LIO-SAM lineage it cites requires real
preintegration, so this module implements it array-natively: the whole
sample window integrates in one ``lax.scan``, bias-correction Jacobians
and the 9x9 covariance propagate in the same pass, and the resulting
factor plugs into the keyframe pose graph (parallel/pose_graph.py).

State deltas between body times i and j (gravity-free, body frame of i):
  dq: rotation,  dv: velocity delta,  dp: position delta.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.precision import highest_precision

# Plain numpy: a module-level jnp constant would freeze whatever default
# dtype (and backend) is active at import time; consumers cast to their
# operand dtype instead.
GRAVITY = np.asarray([0.0, 0.0, -9.80665])


class ImuPreintegration(NamedTuple):
    dq: jnp.ndarray       # [4] preintegrated rotation (wxyz)
    dv: jnp.ndarray       # [3] preintegrated velocity delta
    dp: jnp.ndarray       # [3] preintegrated position delta
    dt: jnp.ndarray       # scalar total time
    # Bias-correction Jacobians (first-order, at the linearization bias).
    dq_dbg: jnp.ndarray   # [3, 3] d(log dq)/d(gyro bias)
    dv_dbg: jnp.ndarray   # [3, 3]
    dv_dba: jnp.ndarray   # [3, 3]
    dp_dbg: jnp.ndarray   # [3, 3]
    dp_dba: jnp.ndarray   # [3, 3]
    cov: jnp.ndarray      # [9, 9] (theta, v, p) covariance


@highest_precision
def preintegrate(gyro: jnp.ndarray, accel: jnp.ndarray, dts: jnp.ndarray,
                 gyro_bias: jnp.ndarray, accel_bias: jnp.ndarray,
                 valid: jnp.ndarray | None = None,
                 gyro_noise: float = 1.7e-4,
                 accel_noise: float = 2.0e-3) -> ImuPreintegration:
    """Integrate an IMU sample window into one relative-motion factor.

    gyro, accel: [N, 3] raw measurements; dts: [N] per-sample intervals;
    ``valid`` masks padding lanes (fixed-shape windows). Noise densities
    are continuous-time (rad/s/sqrt(Hz), m/s^2/sqrt(Hz)).
    """
    n = gyro.shape[0]
    if valid is None:
        valid = jnp.ones(n, bool)
    # Pin every operand to the measurement dtype: callers mix float32
    # measurements with default-dtype zeros, and under jax_enable_x64
    # (several test modules flip it globally) a float64 bias would
    # promote part of the scan carry and break the fixed-point check.
    dtype = gyro.dtype
    accel = jnp.asarray(accel, dtype)
    dts = jnp.asarray(dts, dtype)
    gyro_bias = jnp.asarray(gyro_bias, dtype)
    accel_bias = jnp.asarray(accel_bias, dtype)
    dts = jnp.where(valid, dts, 0.0)

    def step(carry, inp):
        (dq, dv, dp, dq_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba, cov) = carry
        w, a, dt, ok = inp
        w = w - gyro_bias
        a = a - accel_bias

        r = quat.quat_to_matrix(dq)                  # [3, 3]
        theta = w * dt
        dq_step = quat.exp_so3(theta)
        a_rot = quat.quat_rotate(dq, a)

        dp_new = dp + dv * dt + 0.5 * a_rot * dt * dt
        dv_new = dv + a_rot * dt
        dq_new = quat.quat_normalize(quat.quat_multiply(dq, dq_step))

        # First-order bias Jacobians (Forster eqs. (69)-(71) structure).
        # Right-Jacobian of SO(3) at theta, closed form.
        jr = _so3_right_jacobian(theta)
        hat_a = quat.hat(a)
        dq_dbg_new = (quat.quat_to_matrix(dq_step).T @ dq_dbg
                      - jr * dt)
        dv_dbg_new = dv_dbg - r @ hat_a @ dq_dbg * dt
        dv_dba_new = dv_dba - r * dt
        dp_dbg_new = dp_dbg + dv_dbg * dt - 0.5 * r @ hat_a @ dq_dbg \
            * dt * dt
        dp_dba_new = dp_dba + dv_dba * dt - 0.5 * r * dt * dt

        # Covariance propagation: state (theta, v, p).
        eye = jnp.eye(3, dtype=cov.dtype)
        zero = jnp.zeros((3, 3), cov.dtype)
        a_mat = jnp.block([
            [quat.quat_to_matrix(dq_step).T, zero, zero],
            [-r @ hat_a * dt, eye, zero],
            [-0.5 * r @ hat_a * dt * dt, eye * dt, eye],
        ])
        g_sq = gyro_noise * gyro_noise / jnp.maximum(dt, 1e-9)
        a_sq = accel_noise * accel_noise / jnp.maximum(dt, 1e-9)
        noise = jnp.block([
            [jr * dt, zero],
            [zero, r * dt],
            [zero, 0.5 * r * dt * dt],
        ])
        q_cont = jnp.block([
            [eye * g_sq, zero],
            [zero, eye * a_sq],
        ])
        cov_new = a_mat @ cov @ a_mat.T + noise @ q_cont @ noise.T

        out = (
            jnp.where(ok, dq_new, dq),
            jnp.where(ok, dv_new, dv),
            jnp.where(ok, dp_new, dp),
            jnp.where(ok, dq_dbg_new, dq_dbg),
            jnp.where(ok, dv_dbg_new, dv_dbg),
            jnp.where(ok, dv_dba_new, dv_dba),
            jnp.where(ok, dp_dbg_new, dp_dbg),
            jnp.where(ok, dp_dba_new, dp_dba),
            jnp.where(ok, cov_new, cov),
        )
        return out, None

    init = (quat.quat_identity(dtype), jnp.zeros(3, dtype),
            jnp.zeros(3, dtype),
            jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype),
            jnp.zeros((3, 3), dtype), jnp.zeros((3, 3), dtype),
            jnp.zeros((3, 3), dtype),
            jnp.zeros((9, 9), dtype))
    carry, _ = jax.lax.scan(step, init, (gyro, accel, dts, valid))
    (dq, dv, dp, dq_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba, cov) = carry
    return ImuPreintegration(dq=dq, dv=dv, dp=dp, dt=jnp.sum(dts),
                             dq_dbg=dq_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba,
                             dp_dbg=dp_dbg, dp_dba=dp_dba, cov=cov)


@highest_precision
def _so3_right_jacobian(theta: jnp.ndarray, eps: float = 1e-8):
    """Right Jacobian of SO(3): J_r(theta), closed form with small-angle
    guard (series to second order)."""
    t = jnp.linalg.norm(theta)
    hat = quat.hat(theta)
    hat2 = hat @ hat
    eye = jnp.eye(3, dtype=theta.dtype)
    small = t < eps
    t_safe = jnp.where(small, 1.0, t)
    c1 = jnp.where(small, 0.5, (1 - jnp.cos(t_safe)) / (t_safe * t_safe))
    c2 = jnp.where(small, 1.0 / 6.0,
                   (t_safe - jnp.sin(t_safe)) / (t_safe ** 3))
    return eye - c1 * hat + c2 * hat2


def predict_state(q, t, v, pre: ImuPreintegration, gravity=GRAVITY):
    """Dead-reckon a world-frame state (q, t, v) through a
    preintegrated IMU window: the inverse of ``imu_factor_residual``'s
    measurement model (r == 0 at exactly this prediction).

    This is the IMU-aided Gauss-Newton PRIOR: the scan matcher starts
    from the IMU-predicted pose instead of the last pose
    (constant-position assumption), which keeps fast rotation inside
    the convergence basin — the LIO-SAM-style role the reference's
    stubbed ``imu_integration`` package was meant to play
    (``imu_integration/include/imu_integration/integration.hpp:30-33``).
    """
    dt = pre.dt
    gravity = jnp.asarray(gravity, t.dtype)
    t_new = t + v * dt + 0.5 * gravity * dt * dt \
        + quat.quat_rotate(q, pre.dp)
    v_new = v + gravity * dt + quat.quat_rotate(q, pre.dv)
    q_new = quat.quat_normalize(quat.quat_multiply(q, pre.dq))
    return q_new, t_new, v_new


def synthesize_imu(poses_q, poses_t, dt: float, gravity=GRAVITY):
    """Generate ideal IMU measurements from a ground-truth pose
    sequence [N, 4] / [N, 3] sampled every ``dt`` seconds — the test
    harness for IMU-aided pipelines (gyro = body rates from finite
    rotation deltas, accel = specific force from second differences).
    Returns (gyro [N-1, 3], accel [N-1, 3], dts [N-1], vel0 [3]):
    sample k covers the interval k -> k+1 (zeroth-order hold)."""
    q = jnp.asarray(poses_q)
    t = jnp.asarray(poses_t)
    gravity = jnp.asarray(gravity, t.dtype)
    n = q.shape[0]
    rel = quat.quat_multiply(quat.quat_conjugate(q[:-1]), q[1:])
    gyro = jax.vmap(quat.log_so3)(rel) / dt
    # World-frame velocities at sample midpoints; accel from their
    # differences, attributed to the interval start (ZOH).
    v = (t[1:] - t[:-1]) / dt                       # [N-1, 3] v_{k+1/2}
    a_w = jnp.diff(v, axis=0, append=v[-1:]) / dt   # [N-1, 3]
    accel = jax.vmap(quat.quat_rotate)(
        quat.quat_conjugate(q[:-1]), a_w - gravity)
    dts = jnp.full((n - 1,), dt, t.dtype)
    return gyro, accel, dts, v[0]


class ImuFactorResidual(NamedTuple):
    r_theta: jnp.ndarray  # [3]
    r_v: jnp.ndarray      # [3]
    r_p: jnp.ndarray      # [3]


@highest_precision
def imu_factor_residual(pre: ImuPreintegration,
                        qi, pi, vi, qj, pj, vj,
                        delta_bg=None, delta_ba=None,
                        gravity=GRAVITY) -> ImuFactorResidual:
    """Preintegration residual between keyframe states i and j.

    States: world-frame orientation q, position p, velocity v. Deltas
    ``delta_bg``/``delta_ba`` correct the factor to a bias estimate away
    from the linearization point (first order, no re-integration).
    """
    dt = pre.dt
    gravity = jnp.asarray(gravity, jnp.asarray(pi).dtype)
    dq = pre.dq
    dv = pre.dv
    dp = pre.dp
    if delta_bg is not None:
        dq = quat.quat_multiply(dq, quat.exp_so3(pre.dq_dbg @ delta_bg))
        dv = dv + pre.dv_dbg @ delta_bg
        dp = dp + pre.dp_dbg @ delta_bg
    if delta_ba is not None:
        dv = dv + pre.dv_dba @ delta_ba
        dp = dp + pre.dp_dba @ delta_ba

    qi_inv = quat.quat_conjugate(qi)
    rel_q = quat.quat_multiply(qi_inv, qj)
    r_theta = quat.log_so3(
        quat.quat_multiply(quat.quat_conjugate(dq), rel_q))
    r_v = quat.quat_rotate(qi_inv, vj - vi - gravity * dt) - dv
    r_p = quat.quat_rotate(
        qi_inv, pj - pi - vi * dt - 0.5 * gravity * dt * dt) - dp
    return ImuFactorResidual(r_theta=r_theta, r_v=r_v, r_p=r_p)
