"""Gauss-Newton optimizer tests, modeled on the reference's convergence
tests (localization/test/test_optimizer.cpp:53-127): synthetic rigid
transforms recovered from point correspondences."""

import numpy as np
import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.ops import gauss_newton as gn
from lidar_feature_extraction_tpu.ops.alignment import (alignment_problem,
                                                        align_points)
from lidar_feature_extraction_tpu.ops.residuals import ResidualBlock

jax.config.update("jax_enable_x64", True)


def random_pose(rng, angle=0.3, trans=0.5):
    axis = rng.normal(size=3)
    axis *= angle / np.linalg.norm(axis)
    q = quat.exp_so3(jnp.asarray(axis))
    return Pose(q, jnp.asarray(rng.normal(scale=trans, size=3)))


def test_converges_to_true_transform():
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.uniform(-5, 5, size=(40, 3)))
    true = random_pose(rng)
    dst = true.apply(src)
    problem_fn = alignment_problem(src, dst, jnp.ones(40, bool))
    res = gn.run_gauss_newton(problem_fn, Pose.identity(jnp.float64),
                              max_iterations=40)
    assert int(res.status) == gn.CONVERGED
    np.testing.assert_allclose(np.asarray(res.pose.apply(src)),
                               np.asarray(dst), atol=1e-4)


def test_start_at_truth_converges_immediately():
    """Parity with test_optimizer.cpp: starting at the true pose, the
    first update is ~zero and the optimizer reports convergence with
    tiny error."""
    rng = np.random.default_rng(1)
    src = jnp.asarray(rng.uniform(-5, 5, size=(30, 3)))
    true = random_pose(rng)
    dst = true.apply(src)
    problem_fn = alignment_problem(src, dst, jnp.ones(30, bool))
    res = gn.run_gauss_newton(problem_fn, true, max_iterations=40)
    assert int(res.status) == gn.CONVERGED
    assert int(res.iterations) == 1
    assert float(res.error) < 1e-8


def test_error_decreases_after_one_step():
    rng = np.random.default_rng(2)
    src = jnp.asarray(rng.uniform(-5, 5, size=(25, 3)))
    true = random_pose(rng)
    dst = true.apply(src)
    problem_fn = alignment_problem(src, dst, jnp.ones(25, bool))

    def total_error(pose):
        p = gn.make_problem([ResidualBlock(
            jacobian=jnp.zeros((25, 3, 7)),
            residual=pose.apply(src) - dst,
            valid=jnp.ones(25, bool))])
        return float(jnp.sum(jnp.where(p.valid, p.errors, 0.0)))

    start = Pose.identity(jnp.float64)
    one = gn.run_gauss_newton(problem_fn, start, max_iterations=1)
    assert total_error(one.pose) < total_error(start)


def test_empty_input_status():
    src = jnp.zeros((10, 3))
    problem_fn = alignment_problem(src, src, jnp.zeros(10, bool))
    res = gn.run_gauss_newton(problem_fn, Pose.identity(jnp.float64),
                              max_iterations=5)
    assert int(res.status) == gn.EMPTY_INPUT
    np.testing.assert_allclose(np.asarray(res.pose.t), 0.0)


def test_degenerate_problem_keeps_pose():
    """All points identical -> J^T J singular -> zero update, reported
    converged with unchanged pose (parity: WeightedUpdate zero-update on
    IsDegenerate, optimizer.cpp:66-69)."""
    src = jnp.zeros((12, 3))
    dst = jnp.ones((12, 3))
    problem_fn = alignment_problem(src, dst, jnp.ones(12, bool))
    start = Pose.identity(jnp.float64)
    res = gn.run_gauss_newton(problem_fn, start, max_iterations=10)
    assert int(res.status) == gn.CONVERGED
    np.testing.assert_allclose(np.asarray(res.pose.t), 0.0, atol=1e-12)


def test_robust_to_outliers():
    """Huber-IRLS downweights gross outliers: transform recovered despite
    corrupted correspondences."""
    rng = np.random.default_rng(3)
    src = jnp.asarray(rng.uniform(-5, 5, size=(200, 3)))
    true = random_pose(rng, angle=0.2, trans=0.3)
    dst = np.array(true.apply(src))
    dst[:8] += rng.uniform(5, 10, size=(8, 3))  # 4% outliers
    problem_fn = alignment_problem(src, jnp.asarray(dst),
                                   jnp.ones(200, bool))
    res = gn.run_gauss_newton(problem_fn, Pose.identity(jnp.float64),
                              max_iterations=40)
    inliers = np.asarray(res.pose.apply(src))[8:]
    np.testing.assert_allclose(inliers, dst[8:], atol=2e-2)


def test_masked_lanes_do_not_affect_solution():
    rng = np.random.default_rng(4)
    src = rng.uniform(-5, 5, size=(50, 3))
    true = random_pose(rng)
    dst = np.asarray(true.apply(jnp.asarray(src)))
    # Corrupt the masked-out half with garbage.
    src_pad = np.concatenate([src, rng.normal(size=(50, 3)) * 100])
    dst_pad = np.concatenate([dst, rng.normal(size=(50, 3)) * 100])
    valid = jnp.asarray(np.arange(100) < 50)
    problem_fn = alignment_problem(jnp.asarray(src_pad),
                                   jnp.asarray(dst_pad), valid)
    res = gn.run_gauss_newton(problem_fn, Pose.identity(jnp.float64),
                              max_iterations=40)
    np.testing.assert_allclose(
        np.asarray(res.pose.apply(jnp.asarray(src))), dst, atol=1e-4)


def test_make_m_lifts_quaternion_tangent():
    """M maps (dtheta, dt) to (dq, dt): top block must equal
    0.5 * L(q)[:, 1:] (optimizer.cpp:74-85)."""
    rng = np.random.default_rng(5)
    q = quat.quat_normalize(jnp.asarray(rng.normal(size=4)))
    M = gn.make_m(q)
    L = quat.left_multiplication_matrix(q)
    np.testing.assert_allclose(np.asarray(M[:4, :3]),
                               np.asarray(0.5 * L[:, 1:]), atol=1e-12)
    np.testing.assert_allclose(np.asarray(M[4:, 3:]), np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.asarray(M[:4, 3:]), 0.0)
    np.testing.assert_allclose(np.asarray(M[4:, :3]), 0.0)


def test_align_points_facade():
    """ops.alignment.align_points recovers a rigid transform end-to-end
    (the library-level AlignmentProblem entry, alignment.cpp:65-76)."""
    rng = np.random.default_rng(6)
    src = jnp.asarray(rng.uniform(-5, 5, size=(32, 3)))
    true = random_pose(rng)
    dst = true.apply(src)
    res = align_points(src, dst, jnp.ones(32, bool),
                       Pose.identity(jnp.float64))
    assert int(res.status) == gn.CONVERGED
    np.testing.assert_allclose(np.asarray(res.pose.apply(src)),
                               np.asarray(dst), atol=1e-4)


def test_hessian_output_matches_weighted_normal_equations():
    """GNResult.hessian must equal M^T A M rebuilt by hand from the
    final problem (the registration information the pose graph
    consumes)."""
    rng = np.random.default_rng(7)
    src = jnp.asarray(rng.uniform(-5, 5, size=(24, 3)))
    true = random_pose(rng)
    dst = true.apply(src) + jnp.asarray(
        rng.normal(scale=0.01, size=(24, 3)))
    problem_fn = alignment_problem(src, dst, jnp.ones(24, bool))

    # One iteration from a fixed start: the returned Hessian is
    # evaluated exactly at the start pose (body-entry pose).
    start = Pose.identity(jnp.float64)
    res = gn.run_gauss_newton(problem_fn, start, max_iterations=1)

    h = np.asarray(res.hessian)
    # Symmetric positive definite for a well-posed alignment.
    np.testing.assert_allclose(h, h.T, atol=1e-8)
    assert np.linalg.eigvalsh(h).min() > 0

    # Rebuild at the start pose: weights are Huber' of the
    # MAD-normalized squared errors, A = J^T W J, H = M^T A M.
    from lidar_feature_extraction_tpu.core import stats

    problem = problem_fn(start)
    errors = jnp.where(problem.valid, problem.errors, 0.0)
    scale = stats.masked_scale_bisect(problem.errors, problem.valid)
    weights = stats.huber_derivative(errors / (scale + 1e-16), 1.345)
    _, h_ref = gn.weighted_update(start.q, weights, problem, 0.1)
    np.testing.assert_allclose(h, np.asarray(h_ref),
                               rtol=1e-4, atol=1e-6)


def test_block_errors_flag_wrong_block():
    """Per-block error medians must separate a well-fit block from a
    misaligned one where the TOTAL error cannot (the odometry re-seed
    gate's signal, pipeline/odometry.py)."""
    rng = np.random.default_rng(8)
    src_a = jnp.asarray(rng.uniform(-5, 5, size=(30, 3)))
    src_b = jnp.asarray(rng.uniform(-5, 5, size=(30, 3)))

    def make_two_block(offset_b):
        def problem_fn(pose):
            blocks = []
            for src, off in ((src_a, jnp.zeros(3)), (src_b, offset_b)):
                p = pose.apply(src)
                dst = src + off
                jac_t = jnp.broadcast_to(jnp.eye(3), (src.shape[0], 3, 3))
                dr = quat.drpdq(jnp.broadcast_to(pose.q,
                                                 src.shape[:-1] + (4,)),
                                src)
                jac = jnp.concatenate([dr, jac_t], axis=-1)
                blocks.append(ResidualBlock(
                    jacobian=jac, residual=p - dst,
                    valid=jnp.ones(src.shape[0], bool)))
            return gn.make_problem(blocks)
        return problem_fn

    # Block b claims its points sit 1 m away: at the identity optimum
    # of block a, block b's median squared error is ~1, block a's ~0.
    res = gn.run_gauss_newton(
        make_two_block(jnp.asarray([1.0, 0, 0])), Pose.identity(
            jnp.float64), max_iterations=1)
    be = np.asarray(res.block_errors)
    assert be.shape == (2,)
    assert be[0] < 1e-6, be
    assert abs(be[1] - 1.0) < 0.1, be
