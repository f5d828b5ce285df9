"""Robust Gauss-Newton pose optimizer as one jitted ``lax.while_loop``.

Array re-design of ``Optimizer::Run`` (``localization/include/
lidar_feature_localization/optimizer.hpp:72-129``) and its helpers
(``localization/src/optimizer.cpp:35-128``):

- Huber-IRLS on MAD-normalized squared residual norms
  (``ComputeErrors`` / ``NormalizeErrorScale`` / ``ComputeWeights``,
  optimizer.cpp:100-128) — here masked reductions over fixed-shape
  correspondence tensors;
- quaternion-manifold update through the 7->6 lift M
  (``MakeM`` optimizer.cpp:74-85): dx = -(M^T A M)^{-1} M^T b solved
  with Cholesky;
- degeneracy guard on the unweighted J^T J spectrum
  (``IsDegenerate`` degenerate.cpp:32-37, threshold 0.1: any
  |eigenvalue| below it zeroes the update);
- early-abort states (empty input, error increase, scale increase,
  convergence, max-iteration) carried as a status code through the
  while-loop instead of C++ early returns
  (``optimization_result.hpp:38-80``).

The per-iteration problem construction (correspondence search +
residual linearization) is a caller-supplied function, so the same
optimizer drives scan-to-map localization, scan-to-scan odometry and
the point-to-point alignment problem used in tests (parity with the
template parameter ``ProblemType`` of the C++ Optimizer).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core import stats
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.ops import smallalg
from lidar_feature_extraction_tpu.core.precision import highest_precision

# Status codes (parity: the OptimizationResult constructors,
# optimization_result.hpp:47-80).
CONVERGED = 0
MAX_ITERATIONS = 1
ERROR_INCREASED = 2
SCALE_INCREASED = 3
EMPTY_INPUT = 4


class GNResult(NamedTuple):
    pose: Pose
    status: jnp.ndarray      # int32 code above
    iterations: jnp.ndarray  # int32
    error: jnp.ndarray       # sum of squared residual norms
    scale: jnp.ndarray       # MAD scale of the error vector
    # Weighted manifold Hessian M^T A M [6, 6] at the returned pose —
    # the registration's natural information matrix (the quantity the
    # reference inverts in WeightedUpdate, optimizer.cpp:40-72, and the
    # measurement covariance its EKF consumes downstream,
    # pose_measurement.cpp:38-55). Tangent coordinates: (dtheta_right,
    # dt_world), the update parameterization of run_gauss_newton.
    hessian: jnp.ndarray | None = None
    # Per-residual-block masked median of the squared residual norms at
    # the returned pose ([n_blocks], static block order of
    # make_problem). Total error cannot flag a wrong-but-converged
    # registration when one feature class dominates (a ground plane
    # fits any ground plane); the per-class medians can — the caller's
    # fitness gates read these (pipeline/odometry.py re-seed gate,
    # pipeline/slam.py loop acceptance).
    block_errors: jnp.ndarray | None = None


class Problem(NamedTuple):
    """Stacked correspondences in MXU-friendly row form.

    jac_rows:  [M, 7] all jacobian rows (M = sum of N_b * D_b)
    res_rows:  [M] residual entries matching the rows
    errors:    [N] r_i . r_i per correspondence
    valid:     [N] per-correspondence validity
    shape:     static ((N_b, D_b), ...) block structure — lets per-
               correspondence quantities broadcast to rows with static
               reshapes instead of a [M] index gather)
    """

    jac_rows: jnp.ndarray
    res_rows: jnp.ndarray
    errors: jnp.ndarray
    valid: jnp.ndarray
    shape: tuple


def rows_from_corr(problem: Problem, values: jnp.ndarray) -> jnp.ndarray:
    """Broadcast a per-correspondence [N] vector to per-row [M] using the
    static block structure (replaces ``values[row_corr]``: a reshape
    chain instead of an irregular gather)."""
    out = []
    offset = 0
    for n, d in problem.shape:
        seg = values[offset:offset + n]
        out.append(jnp.broadcast_to(seg[:, None], (n, d)).reshape(n * d))
        offset += n
    return jnp.concatenate(out, axis=0)


def make_problem(blocks) -> Problem:
    """Stack ResidualBlocks (possibly of different row-dims D) into one
    row-form problem. Parity: ``LOAMOptimizationProblem::Make``
    (loam_optimization_problem.hpp:51-88) concatenates the edge and
    surface jacobian/residual lists. Row form keeps the normal-equation
    reductions as two [7, M] x [M, 7] matmuls on the MXU instead of
    per-correspondence outer-product einsums."""
    jacs, ress, errs, valids, shape = [], [], [], [], []
    for b in blocks:
        n, d, _ = b.jacobian.shape
        jacs.append(b.jacobian.reshape(n * d, 7))
        ress.append(b.residual.reshape(n * d))
        errs.append(jnp.sum(b.residual * b.residual, axis=-1))
        valids.append(b.valid)
        shape.append((n, d))
    return Problem(jac_rows=jnp.concatenate(jacs, axis=0),
                   res_rows=jnp.concatenate(ress, axis=0),
                   errors=jnp.concatenate(errs, axis=0),
                   valid=jnp.concatenate(valids, axis=0),
                   shape=tuple(shape))


def make_m(q: jnp.ndarray) -> jnp.ndarray:
    """7x6 manifold lift: dx(6) -> d(q, t)(7). Parity: MakeM
    (optimizer.cpp:74-85): top-left 4x3 = 0.5 * L(q)[:, 1:]."""
    L = quat.left_multiplication_matrix(q)
    top = jnp.concatenate([0.5 * L[..., :, 1:],
                           jnp.zeros(L.shape[:-2] + (4, 3), L.dtype)],
                          axis=-1)
    bot = jnp.concatenate([jnp.zeros(L.shape[:-2] + (3, 3), L.dtype),
                           jnp.broadcast_to(jnp.eye(3, dtype=L.dtype),
                                            L.shape[:-2] + (3, 3))],
                          axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@highest_precision
def weighted_update(q: jnp.ndarray, weights: jnp.ndarray,
                    problem: Problem,
                    degeneracy_threshold: float):
    """One GN solve: dx = -(M^T A M)^{-1} M^T b, or zero when the
    unweighted Hessian is degenerate. Parity: WeightedUpdate
    (optimizer.cpp:40-72). The three reductions are [7, M] x [M, 7]
    matmuls over the jacobian rows (MXU) with per-row weight scaling.

    Returns ``(dx [6], H [6, 6])`` with H the weighted manifold Hessian
    M^T A M — the registration's information matrix."""
    dtype = problem.jac_rows.dtype
    w = jnp.where(problem.valid, weights, 0.0)
    vf = problem.valid.astype(dtype)
    w_rows = rows_from_corr(problem, w)[:, None]
    v_rows = rows_from_corr(problem, vf)[:, None]
    j = problem.jac_rows
    D = (j * v_rows).T @ j
    A = (j * w_rows).T @ j
    b = j.T @ (w_rows[:, 0] * problem.res_rows)

    M = make_m(q)
    H = M.T @ A @ M
    g = M.T @ b
    # Unrolled Cholesky solve (the reference's LLT, optimizer.cpp:71) —
    # smallalg keeps tiny factorizations as straight-line VPU code
    # instead of XLA's iterative linalg lowerings.
    dx = -smallalg.cholesky_solve(H, g)

    degenerate = smallalg.min_eigval_below(D, degeneracy_threshold)
    bad = degenerate | ~jnp.all(jnp.isfinite(dx))
    return jnp.where(bad, jnp.zeros_like(dx), dx), H


def run_gauss_newton(
    problem_fn: Callable[[Pose], Problem],
    initial_pose: Pose,
    max_iterations: int,
    convergence_tol: float = 1e-3,
    huber_k: float = 1.345,
    degeneracy_threshold: float = 0.1,
    abort_on_increase: bool = True,
) -> GNResult:
    """Iterate GN with recomputed correspondences until convergence or an
    abort condition, inside ``lax.while_loop``. ``problem_fn`` is traced
    once; it must be shape-stable.

    ``abort_on_increase=False`` disables the error/scale-increase
    aborts (EMPTY_INPUT still terminates): correct for basin-crawling
    registrations like loop-closure candidates, where early iterations
    legitimately raise the total error as the correspondence set churns
    toward the true alignment — the reference's aborts assume an
    online tracker already near its optimum (optimizer.hpp:93-108)."""

    dtype = initial_pose.t.dtype
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    def cond(state):
        _, _, _, _, it, status, _, _ = state
        return (status < 0) & (it < max_iterations)

    def body(state):
        q, t, prev_error, prev_scale, it, status, _, _ = state
        pose = Pose(q, t)
        problem = problem_fn(pose)

        n_valid = jnp.sum(problem.valid.astype(jnp.int32))
        errors = jnp.where(problem.valid, problem.errors, 0.0)
        error = jnp.sum(errors)
        scale = stats.masked_scale_bisect(problem.errors, problem.valid)
        normalized = errors / (scale + 1e-16)

        # Per-block error medians (see GNResult.block_errors).
        meds, off = [], 0
        for n_b, _ in problem.shape:
            meds.append(stats._wide_median(
                problem.errors[off:off + n_b],
                problem.valid[off:off + n_b]))
            off += n_b
        block_meds = jnp.stack(meds)

        empty = n_valid == 0
        allow_abort = jnp.asarray(abort_on_increase)
        err_up = (error > prev_error) & allow_abort
        scale_up = (scale > prev_scale) & allow_abort

        weights = stats.huber_derivative(normalized, huber_k)
        dx, hess = weighted_update(q, weights, problem,
                                   degeneracy_threshold)
        dq = quat.exp_so3(dx[:3])
        dt = dx[3:]
        q_new = quat.quat_normalize(quat.quat_multiply(q, dq))
        t_new = t + dt
        converged = (jnp.linalg.norm(dq[1:]) < convergence_tol) \
            & (jnp.linalg.norm(dt) < convergence_tol)

        # Abort conditions keep the *pre-update* pose (the C++ returns
        # MakePose(q, t) before applying the update, optimizer.hpp:93-108).
        abort = empty | err_up | scale_up
        new_status = jnp.where(
            empty, EMPTY_INPUT,
            jnp.where(err_up, ERROR_INCREASED,
                      jnp.where(scale_up, SCALE_INCREASED,
                                jnp.where(converged, CONVERGED, -1))))
        q_out = jnp.where(abort, q, q_new)
        t_out = jnp.where(abort, t, t_new)
        prev_error = jnp.where(abort, prev_error, error)
        prev_scale = jnp.where(abort, prev_scale, scale)
        # hess is evaluated at the body-entry pose, which IS the
        # returned pose on every abort path (and within tol of it on
        # convergence) — so the last body's Hessian is always the
        # information at the result.
        return (q_out, t_out, prev_error, prev_scale, it + 1,
                new_status.astype(jnp.int32), hess, block_meds)

    # Block count via an abstract trace (no runtime cost): the static
    # tuple structure of Problem.shape survives eval_shape.
    n_blocks = len(jax.eval_shape(
        lambda q, t: problem_fn(Pose(q, t)),
        initial_pose.q, initial_pose.t).shape)
    init = (initial_pose.q.astype(dtype), initial_pose.t.astype(dtype),
            big, big, jnp.asarray(0, jnp.int32), jnp.asarray(-1, jnp.int32),
            jnp.zeros((6, 6), dtype), jnp.full((n_blocks,), big, dtype))
    q, t, error, scale, it, status, hess, block_meds = jax.lax.while_loop(
        cond, body, init)
    status = jnp.where(status < 0, MAX_ITERATIONS, status)
    return GNResult(pose=Pose(q, t), status=status, iterations=it,
                    error=error, scale=scale, hessian=hess,
                    block_errors=block_meds)


class GNStep(NamedTuple):
    """Device outputs of one host-driven GN iteration."""

    pose: Pose
    error: jnp.ndarray     # sum of squared residual norms (this problem)
    scale: jnp.ndarray     # MAD scale
    n_valid: jnp.ndarray   # valid correspondence count
    dq_norm: jnp.ndarray   # |dq.vec| of the applied update
    dt_norm: jnp.ndarray   # |dt|
    hessian: jnp.ndarray | None = None  # M^T A M [6, 6] at input pose


def gn_iteration(problem: Problem, pose: Pose,
                 huber_k: float = 1.345,
                 degeneracy_threshold: float = 0.1) -> GNStep:
    """One Gauss-Newton iteration as a standalone jittable step.

    ``HostLocalizer`` drives the reference's loop logic
    (optimizer.hpp:83-121) from the host with this step per iteration;
    host-side convergence checks give early exit for free.
    """
    n_valid = jnp.sum(problem.valid.astype(jnp.int32))
    errors = jnp.where(problem.valid, problem.errors, 0.0)
    error = jnp.sum(errors)
    scale = stats.masked_scale_bisect(problem.errors, problem.valid)
    normalized = errors / (scale + 1e-16)
    weights = stats.huber_derivative(normalized, huber_k)
    dx, hess = weighted_update(pose.q, weights, problem,
                               degeneracy_threshold)
    dq = quat.exp_so3(dx[:3])
    q_new = quat.quat_normalize(quat.quat_multiply(pose.q, dq))
    return GNStep(pose=Pose(q_new, pose.t + dx[3:]),
                  error=error, scale=scale, n_valid=n_valid,
                  dq_norm=jnp.linalg.norm(dq[1:]),
                  dt_norm=jnp.linalg.norm(dx[3:]), hessian=hess)


def run_gauss_newton_host(step_fn, initial_pose: Pose,
                          max_iterations: int,
                          convergence_tol: float = 1e-3) -> GNResult:
    """Host-driven GN: ``step_fn(pose) -> GNStep`` is a (jitted) device
    step; abort/convergence logic runs in Python with the same semantics
    as ``Optimizer::Run`` (empty-input / error-increase / scale-increase
    aborts keep the pre-update pose; convergence keeps the update)."""
    pose = initial_pose
    prev_error = float("inf")
    prev_scale = float("inf")
    error = scale = 0.0
    it = 0
    for it in range(1, max_iterations + 1):
        out = step_fn(pose)
        n_valid = int(out.n_valid)
        error = float(out.error)
        scale = float(out.scale)
        if n_valid == 0:
            return GNResult(pose=pose, status=jnp.asarray(EMPTY_INPUT),
                            iterations=jnp.asarray(it),
                            error=jnp.asarray(error),
                            scale=jnp.asarray(scale),
                            hessian=out.hessian)
        if error > prev_error:
            return GNResult(pose=pose, status=jnp.asarray(ERROR_INCREASED),
                            iterations=jnp.asarray(it),
                            error=jnp.asarray(error),
                            scale=jnp.asarray(scale),
                            hessian=out.hessian)
        prev_error = error
        if scale > prev_scale:
            return GNResult(pose=pose, status=jnp.asarray(SCALE_INCREASED),
                            iterations=jnp.asarray(it),
                            error=jnp.asarray(error),
                            scale=jnp.asarray(scale),
                            hessian=out.hessian)
        prev_scale = scale
        pose = out.pose
        if (float(out.dq_norm) < convergence_tol
                and float(out.dt_norm) < convergence_tol):
            return GNResult(pose=pose, status=jnp.asarray(CONVERGED),
                            iterations=jnp.asarray(it),
                            error=jnp.asarray(error),
                            scale=jnp.asarray(scale),
                            hessian=out.hessian)
    return GNResult(pose=pose, status=jnp.asarray(MAX_ITERATIONS),
                    iterations=jnp.asarray(it),
                    error=jnp.asarray(error), scale=jnp.asarray(scale),
                    hessian=out.hessian if it > 0 else None)
