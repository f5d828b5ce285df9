"""Closed-form / fixed-iteration small-matrix linear algebra.

XLA lowers ``jnp.linalg`` factorizations (LU, Cholesky, eigh) to
iterative library routines that are poor fits for tiny matrices inside
jitted hot loops. The registration loop only ever needs:

- batched symmetric 3x3 solves (plane fit normal equations),
- one 6x6 SPD solve per GN iteration (the lifted normal equations),
- the eigenvalue spectrum of one symmetric 7x7 per iteration
  (degeneracy guard, ``IsDegenerate`` degenerate.cpp:32-37).

All are implemented here as straight-line arithmetic (Cramer/adjugate,
unrolled Cholesky, fixed-sweep cyclic Jacobi) — pure elementwise code, no
data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve3x3_sym(a: jnp.ndarray, b: jnp.ndarray,
                 eps: float = 1e-30) -> jnp.ndarray:
    """Solve a x = b for symmetric 3x3 ``a`` [..., 3, 3], b [..., 3].

    Adjugate/Cramer closed form; singular systems return large-magnitude
    garbage the caller gates (same contract as lstsq on degenerate
    neighborhoods).
    """
    a00 = a[..., 0, 0]
    a01 = a[..., 0, 1]
    a02 = a[..., 0, 2]
    a11 = a[..., 1, 1]
    a12 = a[..., 1, 2]
    a22 = a[..., 2, 2]

    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01

    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps,
                              jnp.where(det < 0, -eps, eps), det)

    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return jnp.stack([x0, x1, x2], axis=-1)


def cholesky_solve(a: jnp.ndarray, b: jnp.ndarray,
                   eps: float = 1e-30) -> jnp.ndarray:
    """Solve SPD ``a x = b`` for small static n via unrolled Cholesky.

    a: [n, n], b: [n]. Entirely unrolled at trace time (n is a Python
    int), producing straight-line scalar arithmetic. Non-SPD inputs
    yield inf/nan the caller detects (the degeneracy guard zeroes the
    update, matching the reference's LLT usage, optimizer.cpp:63-71).
    """
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][i] = jnp.sqrt(s)
            else:
                l[i][j] = s / jnp.where(jnp.abs(l[j][j]) < eps, eps,
                                        l[j][j])
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x)


def min_eigval_below(a: jnp.ndarray, tau: float) -> jnp.ndarray:
    """True iff the minimum eigenvalue of symmetric PSD ``a`` [n, n] is
    below ``tau`` — exactly the reference degeneracy test
    (``IsDegenerate`` degenerate.cpp:32-37: any |lambda| < 0.1; J^T J is
    PSD so |lambda| = lambda).

    lambda_min(a) < tau  <=>  (a - tau I) is not positive definite,
    decided by one unrolled Cholesky: a pivot hits a non-positive value
    iff the factorization fails (sqrt of a negative yields NaN, which
    also fails the > 0 comparison). ~30 flops instead of the
    168-rotation Jacobi spectrum this replaces in the GN hot loop.
    """
    n = a.shape[-1]
    a = a - tau * jnp.eye(n, dtype=a.dtype)
    l = [[None] * n for _ in range(n)]
    ok = jnp.asarray(True)
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                ok = ok & (s > 0)
                l[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                l[i][j] = s / l[j][j]
    return ~ok


def jacobi_eigvalsh(a: jnp.ndarray, sweeps: int = 8) -> jnp.ndarray:
    """Eigenvalues of a symmetric [n, n] via fixed-sweep cyclic Jacobi.

    n is static and small (7 for the degeneracy guard); ``sweeps`` full
    cycles of (p, q) rotations executed unconditionally — branch-free,
    quadratically convergent, plenty for 7x7 at float32 precision.
    Returns eigenvalues in unspecified order (the guard only thresholds
    their magnitudes).
    """
    n = a.shape[-1]
    eps = jnp.asarray(1e-30, a.dtype)

    def rotate(a, p, q):
        app, aqq, apq = a[p, p], a[q, q], a[p, q]
        # Branch-free Jacobi rotation angle.
        theta = (aqq - app) / (2.0 * jnp.where(jnp.abs(apq) < eps,
                                               eps, apq))
        sign = jnp.where(theta >= 0, 1.0, -1.0)
        t = sign / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
        t = jnp.where(jnp.abs(apq) < eps, 0.0, t)
        c = 1.0 / jnp.sqrt(t * t + 1.0)
        s = t * c
        # Apply G^T A G with G the (p, q) rotation.
        rp = c * a[p, :] - s * a[q, :]
        rq = s * a[p, :] + c * a[q, :]
        a = a.at[p, :].set(rp).at[q, :].set(rq)
        cp = c * a[:, p] - s * a[:, q]
        cq = s * a[:, p] + c * a[:, q]
        a = a.at[:, p].set(cp).at[:, q].set(cq)
        return a

    def sweep(_, a):
        for p in range(n):
            for q in range(p + 1, n):
                a = rotate(a, p, q)
        return a

    # fori_loop keeps the HLO a single sweep (the unrolled 8-sweep chain
    # measurably bloats compile time of the surrounding GN loop).
    a = jax.lax.fori_loop(0, sweeps, sweep, a)
    return jnp.diagonal(a)
