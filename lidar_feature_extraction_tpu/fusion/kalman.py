"""Kalman-filter primitive kernels and the time-delay (augmented-state)
filter, in JAX.

Parity sources:
- predict/update kernels: ``kalman_filter/include/kalman_filter/
  kalman_filter.hpp:28-63`` (predictNextState, predictNextCovariance,
  calcKalmanGain, updateState, updateCovariance);
- time-delay filter: ``kalman_filter/src/time_delay_kalman_filter.cpp``
  — state is a shift register of the last ``max_delay_step`` states
  (initX/initP :19-40, updateX/updateP :43-92), delayed measurements hit
  the ``delay_step``-th block (makeMeasurementMatrix :95-103,
  UpdateWithDelay :115-140).

Design notes: the block measurement matrix D = [0..C..0] is never
materialized — ``D P`` and ``P D^T`` are dynamic block slices, turning
the reference's [m x nd][nd x nd] products into [m x d][d x nd] ones.
All functions are pure and jittable; the filter state is a pytree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core.precision import highest_precision


# --- stateless kernels (kalman_filter.hpp:28-63) ---

@highest_precision
def predict_next_state(x, u, a, b):
    return a @ x + b @ u


@highest_precision
def predict_next_covariance(p, a, q):
    return a @ p @ a.T + q


@highest_precision
def calc_kalman_gain(p, c, r):
    pct = p @ c.T
    return pct @ jnp.linalg.inv(r + c @ pct)


@highest_precision
def update_state(x, y, c, k):
    return x + k @ (y - c @ x)


@highest_precision
def update_covariance(p, c, k):
    return p - k @ c @ p


# --- time-delay filter ---

class TimeDelayState(NamedTuple):
    """x: [n*d] newest-first shift register; p: [n*d, n*d]."""

    x: jnp.ndarray
    p: jnp.ndarray


def init_time_delay(x0: jnp.ndarray, p0: jnp.ndarray,
                    max_delay_step: int) -> TimeDelayState:
    """Replicate the initial state/covariance into every delay block
    (initX/initP, time_delay_kalman_filter.cpp:19-40)."""
    d = x0.shape[0]
    n = max_delay_step
    x = jnp.tile(x0, n)
    p = jnp.kron(jnp.eye(n, dtype=p0.dtype), p0)
    return TimeDelayState(x=x, p=p)


@highest_precision
def predict_with_delay(state: TimeDelayState, x_next: jnp.ndarray,
                       a: jnp.ndarray, q: jnp.ndarray) -> TimeDelayState:
    """Shift the register and propagate covariance.

    Parity: PredictWithDelay (time_delay_kalman_filter.cpp:106-113):
    x <- [x_next, x[:-d]];  P <- [[A P11 A'+Q, A P1:], [P:1 A', P::]]
    where P11/P1:/P:1/P:: are the top-left d-block slices of the OLD P
    shifted down-right by one block (updateP :43-92).
    """
    d = a.shape[0]
    nd = state.x.shape[0]
    c = nd - d
    x1 = jnp.concatenate([x_next, state.x[:c]])

    bb = state.p[:d, :d]
    bc = state.p[:d, :c]
    cb = state.p[:c, :d]
    cc = state.p[:c, :c]
    top = jnp.concatenate([a @ bb @ a.T + q, a @ bc], axis=1)
    bot = jnp.concatenate([cb @ a.T, cc], axis=1)
    return TimeDelayState(x=x1, p=jnp.concatenate([top, bot], axis=0))


@highest_precision
def update_with_delay(state: TimeDelayState, y: jnp.ndarray,
                      c_mat: jnp.ndarray, r: jnp.ndarray,
                      delay_step: jnp.ndarray, dim_x: int) -> TimeDelayState:
    """Apply measurement y = C x(t - delay_step) + v.

    Parity: UpdateWithDelay (time_delay_kalman_filter.cpp:115-140), but
    with the sparse block measurement matrix applied as dynamic slices:
      P D^T = P[:, s:s+d] C^T,  D P D^T = C P[s:s+d, s:s+d] C^T.
    ``delay_step`` is a traced scalar — no recompilation per delay.
    """
    d = dim_x
    nd = state.x.shape[0]
    s = delay_step * d

    p_cols = jax.lax.dynamic_slice(state.p, (0, s), (nd, d))       # P[:, s:s+d]
    pct = p_cols @ c_mat.T                                          # [nd, m]
    p_block = jax.lax.dynamic_slice(p_cols, (s, 0), (d, d))         # P[s:s+d, s:s+d]
    innov_cov = r + c_mat @ p_block @ c_mat.T                       # [m, m]
    k = pct @ jnp.linalg.inv(innov_cov)                             # [nd, m]

    x_at = jax.lax.dynamic_slice(state.x, (s,), (d,))
    x1 = state.x + k @ (y - c_mat @ x_at)
    # P <- P - K D P;  D P = (P D^T)^T by symmetry of P.
    p1 = state.p - k @ pct.T
    return TimeDelayState(x=x1, p=p1)


def latest(state: TimeDelayState, dim_x: int):
    """Newest state block and its covariance (getLatestX/getLatestP)."""
    return state.x[:dim_x], state.p[:dim_x, :dim_x]


def state_at(state: TimeDelayState, delay_step: jnp.ndarray, dim_x: int):
    """State block ``delay_step`` steps in the past (getX :164)."""
    return jax.lax.dynamic_slice(state.x, (delay_step * dim_x,), (dim_x,))
