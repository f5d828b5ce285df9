"""2D-dynamics EKF for LiDAR pose fusion (the ekf_localizer equivalent).

State: [x, y, yaw, yaw_bias, vx, wz] (parity: ekf_localizer
state_index.hpp). Components:

- bicycle-model predict + analytic Jacobian + process noise
  (``ekf_localizer/src/state_transition.cpp:19-70``);
- delayed pose measurement (x, y, yaw) and twist measurement (vx, wz)
  with Mahalanobis gating (``pose_measurement.cpp:74-114``,
  ``twist_measurement.cpp:70-110``, ``mahalanobis.cpp:19-33``);
- the time-delay filter from fusion/kalman.py;
- three scalar filters for z / roll / pitch (``Simple1DFilter``,
  ``ekf_localizer/include/ekf_localizer/ekf_localizer.hpp:55-103``).

Everything numerical is a pure jitted function over an ``EkfState``
pytree; the queueing/timing host logic lives in pipeline/ (the device
analogue of the rclcpp timer node, ``ekf_localizer.cpp:176-233``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import EkfConfig
from lidar_feature_extraction_tpu.fusion import kalman
from lidar_feature_extraction_tpu.core.precision import highest_precision

DIM_X = 6
IDX_X, IDX_Y, IDX_YAW, IDX_YAWB, IDX_VX, IDX_WZ = range(6)


def normalize_yaw(yaw):
    """atan2(sin, cos) wrap (state_transition.cpp:19-26)."""
    return jnp.arctan2(jnp.sin(yaw), jnp.cos(yaw))


def predict_next_state(x, dt):
    """Nonlinear bicycle-model step (state_transition.cpp:27-44)."""
    yaw = x[IDX_YAW] + x[IDX_YAWB]
    return jnp.array([
        x[IDX_X] + x[IDX_VX] * jnp.cos(yaw) * dt,
        x[IDX_Y] + x[IDX_VX] * jnp.sin(yaw) * dt,
        normalize_yaw(x[IDX_YAW] + x[IDX_WZ] * dt),
        x[IDX_YAWB],
        x[IDX_VX],
        x[IDX_WZ],
    ], dtype=x.dtype)


def state_transition_matrix(x, dt):
    """Analytic 6x6 Jacobian A (state_transition.cpp:47-62)."""
    yaw = x[IDX_YAW] + x[IDX_YAWB]
    vx = x[IDX_VX]
    a = jnp.eye(DIM_X, dtype=x.dtype)
    a = a.at[IDX_X, IDX_YAW].set(-vx * jnp.sin(yaw) * dt)
    a = a.at[IDX_X, IDX_YAWB].set(-vx * jnp.sin(yaw) * dt)
    a = a.at[IDX_X, IDX_VX].set(jnp.cos(yaw) * dt)
    a = a.at[IDX_Y, IDX_YAW].set(vx * jnp.cos(yaw) * dt)
    a = a.at[IDX_Y, IDX_YAWB].set(vx * jnp.cos(yaw) * dt)
    a = a.at[IDX_Y, IDX_VX].set(jnp.sin(yaw) * dt)
    a = a.at[IDX_YAW, IDX_WZ].set(dt)
    return a


def process_noise(variances, dtype=jnp.float32):
    """diag(0, 0, q_yaw, q_yawb, q_vx, q_wz) (state_transition.cpp:
    64-70) — x/y receive no direct process noise."""
    v = jnp.asarray(variances, dtype)
    return jnp.diag(jnp.concatenate([jnp.zeros(2, dtype), v]))


@highest_precision
def squared_mahalanobis(x, y, cov):
    """(mahalanobis.cpp:19-27)."""
    d = x - y
    return d @ jnp.linalg.solve(cov, d)


class EkfState(NamedTuple):
    td: kalman.TimeDelayState


def init_ekf(cfg: EkfConfig, x0=None, p0=None, pose_cov=(1e4, 1e4, 1e2),
             dtype=jnp.float32) -> EkfState:
    """Initial state/covariance parity with ``InitState``/
    ``InitCovariance`` (ekf_localizer.cpp:104-114): pose entries from
    the initial-pose covariance, yaw_bias var 0.0001 (0 when bias
    estimation is disabled the bias state just stays 0), vx/wz 0.01."""
    if x0 is None:
        x0 = jnp.zeros(DIM_X, dtype)
    if p0 is None:
        p0 = jnp.diag(jnp.asarray(
            [pose_cov[0], pose_cov[1], pose_cov[2], 1e-4, 1e-2, 1e-2],
            dtype))
    return EkfState(td=kalman.init_time_delay(x0, p0, cfg.extend_state_step))


@partial(jax.jit, static_argnames=("cfg",))
def predict(state: EkfState, dt, cfg: EkfConfig) -> EkfState:
    """One timer tick: nonlinear predict through the shift register
    (timerCallback predict section, ekf_localizer.cpp:176-207)."""
    dtype = state.td.x.dtype
    x_curr = state.td.x[:DIM_X]
    x_next = predict_next_state(x_curr, dt)
    a = state_transition_matrix(x_curr, dt)
    yaw_bias_var = jnp.where(
        cfg.enable_yaw_bias_estimation,
        (cfg.proc_stddev_yaw_bias_c * dt) ** 2, 0.0)
    variances = jnp.stack([
        jnp.asarray((cfg.proc_stddev_yaw_c * dt) ** 2, dtype),
        jnp.asarray(yaw_bias_var, dtype),
        jnp.asarray((cfg.proc_stddev_vx_c * dt) ** 2, dtype),
        jnp.asarray((cfg.proc_stddev_wz_c * dt) ** 2, dtype),
    ])
    q = process_noise(variances, dtype)
    return EkfState(td=kalman.predict_with_delay(state.td, x_next, a, q))


# Measurement matrices (pose_measurement.cpp:38-45,
# twist_measurement.cpp:33-43).
def _pose_c(dtype):
    c = jnp.zeros((3, DIM_X), dtype)
    return c.at[0, IDX_X].set(1.0).at[1, IDX_Y].set(1.0) \
            .at[2, IDX_YAW].set(1.0)


def _twist_c(dtype):
    c = jnp.zeros((2, DIM_X), dtype)
    return c.at[0, IDX_VX].set(1.0).at[1, IDX_WZ].set(1.0)


@partial(jax.jit, static_argnames=("cfg",))
def update_pose(state: EkfState, y: jnp.ndarray, r: jnp.ndarray,
                delay_step: jnp.ndarray, cfg: EkfConfig) -> EkfState:
    """Delayed (x, y, yaw) update with Mahalanobis gate
    (pose_measurement.cpp:74-114). ``r`` is the 3x3 measurement
    covariance already scaled by smoothing steps; ``y[2]`` must be a
    normalized yaw. Gated-out or non-finite measurements leave the
    state untouched (the C++ ``continue``)."""
    dtype = state.td.x.dtype
    c = _pose_c(dtype)
    y = y.at[2].set(normalize_yaw(y[2]))
    y_ekf = kalman.state_at(state.td, delay_step, DIM_X)[:3]
    p_y = state.td.p[:3, :3]
    md2 = squared_mahalanobis(y_ekf, y, p_y)
    ok = (md2 <= cfg.pose_gate_dist ** 2) & jnp.all(jnp.isfinite(y)) \
        & (delay_step < cfg.extend_state_step) & (delay_step >= 0)
    new = kalman.update_with_delay(state.td, y, c, r, delay_step, DIM_X)
    ok = ok & jnp.all(jnp.isfinite(new.x)) & jnp.all(jnp.isfinite(new.p))
    td = kalman.TimeDelayState(
        x=jnp.where(ok, new.x, state.td.x),
        p=jnp.where(ok, new.p, state.td.p))
    return EkfState(td=td)


@partial(jax.jit, static_argnames=("cfg",))
def update_twist(state: EkfState, y: jnp.ndarray, r: jnp.ndarray,
                 delay_step: jnp.ndarray, cfg: EkfConfig) -> EkfState:
    """Delayed (vx, wz) update (twist_measurement.cpp:70-110)."""
    dtype = state.td.x.dtype
    c = _twist_c(dtype)
    idx = jnp.array([IDX_VX, IDX_WZ])
    y_ekf = kalman.state_at(state.td, delay_step, DIM_X)[idx]
    p_y = state.td.p[jnp.ix_(idx, idx)]
    md2 = squared_mahalanobis(y_ekf, y, p_y)
    ok = (md2 <= cfg.twist_gate_dist ** 2) & jnp.all(jnp.isfinite(y)) \
        & (delay_step < cfg.extend_state_step) & (delay_step >= 0)
    new = kalman.update_with_delay(state.td, y, c, r, delay_step, DIM_X)
    ok = ok & jnp.all(jnp.isfinite(new.x)) & jnp.all(jnp.isfinite(new.p))
    td = kalman.TimeDelayState(
        x=jnp.where(ok, new.x, state.td.x),
        p=jnp.where(ok, new.p, state.td.p))
    return EkfState(td=td)


def current_pose_twist(state: EkfState):
    """(x, y, unbiased yaw), (vx, wz), and the 6x6 covariance — what the
    node publishes (ekf_localizer.cpp:209-232: pose yaw = yaw + yaw_bias)."""
    x, p = kalman.latest(state.td, DIM_X)
    pose = jnp.array([x[IDX_X], x[IDX_Y],
                      normalize_yaw(x[IDX_YAW] + x[IDX_YAWB])])
    twist = jnp.array([x[IDX_VX], x[IDX_WZ]])
    return pose, twist, p


class Filter1D(NamedTuple):
    """Scalar KF for z / roll / pitch (Simple1DFilter,
    ekf_localizer.hpp:55-103). ``initialized`` is part of the state so
    the whole thing stays jittable."""

    x: jnp.ndarray
    stddev: jnp.ndarray
    proc_stddev: jnp.ndarray
    initialized: jnp.ndarray

    @staticmethod
    def create(proc_stddev=0.0, dtype=jnp.float32) -> "Filter1D":
        return Filter1D(x=jnp.zeros((), dtype),
                        stddev=jnp.asarray(1e9, dtype),
                        proc_stddev=jnp.asarray(proc_stddev, dtype),
                        initialized=jnp.zeros((), bool))


@jax.jit
def filter1d_update(f: Filter1D, obs, obs_stddev, dt) -> Filter1D:
    proc = f.proc_stddev * dt
    pred_std = jnp.sqrt(f.stddev ** 2 + proc ** 2)
    gain = pred_std ** 2 / (pred_std ** 2 + obs_stddev ** 2)
    x_new = f.x + gain * (obs - f.x)
    std_new = jnp.sqrt(1 - gain) * pred_std
    init = f.initialized
    return Filter1D(
        x=jnp.where(init, x_new, obs),
        stddev=jnp.where(init, std_new, obs_stddev),
        proc_stddev=f.proc_stddev,
        initialized=jnp.ones((), bool))
