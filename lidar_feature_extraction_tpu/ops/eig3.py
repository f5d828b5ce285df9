"""Closed-form eigendecomposition of symmetric 3x3 matrices, batched.

The reference calls Eigen's ``SelfAdjointEigenSolver::computeDirect``
per edge point (``localization/include/lidar_feature_localization/
edge.hpp:111-113``). Here we need thousands of simultaneous 3x3
eigenproblems with no iteration or pivoting; this implements the
analytic method (trigonometric eigenvalues + cross-product
eigenvectors with a branch-free pivot choice), vmappable and
jit-friendly.

Algorithm: Eberly, "A Robust Eigensolver for 3x3 Symmetric Matrices"
(public-domain technique; also Smith 1961, Comm. ACM 4(4)).
"""

from __future__ import annotations

import jax.numpy as jnp


def eigh3x3(a: jnp.ndarray, eps: float = 1e-30):
    """Eigenvalues (ascending) and eigenvectors of symmetric [..., 3, 3].

    Returns ``(w [..., 3], v [..., 3, 3])`` with ``v[..., :, k]`` the unit
    eigenvector of ``w[..., k]`` — same layout as Eigen / numpy.
    """
    dtype = a.dtype
    # Shift by the mean of the diagonal for numerical stability.
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    a00 = a[..., 0, 0] - q
    a11 = a[..., 1, 1] - q
    a22 = a[..., 2, 2] - q
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    p2 = (a00 * a00 + a11 * a11 + a22 * a22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, eps))

    # det(B) where B = (A - q I) / p
    b00, b11, b22 = a00 / p, a11 / p, a22 / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = jnp.clip(detb / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    two_pi_3 = jnp.asarray(2.0943951023931953, dtype)
    w2 = q + 2.0 * p * jnp.cos(phi)                  # largest
    w0 = q + 2.0 * p * jnp.cos(phi + two_pi_3)       # smallest
    w1 = 3.0 * q - w0 - w2
    w = jnp.stack([w0, w1, w2], axis=-1)

    # Degenerate (near-isotropic) matrices: p2 ~ 0 -> all eigenvalues q.
    # Threshold is relative to the matrix scale (q) so tiny- and huge-
    # magnitude covariances behave identically; the absolute floor only
    # catches the exactly-zero matrix.
    iso = p2 < (1e-12 * q * q + 1e-30)

    def eigenvector(lam):
        """Unit eigenvector for eigenvalue lam via the largest cross
        product of rows of (A - lam I) — branch-free pivoting."""
        r0 = jnp.stack([a[..., 0, 0] - lam, a01, a02], axis=-1)
        r1 = jnp.stack([a01, a[..., 1, 1] - lam, a12], axis=-1)
        r2 = jnp.stack([a02, a12, a[..., 2, 2] - lam], axis=-1)
        c01 = jnp.cross(r0, r1)
        c02 = jnp.cross(r0, r2)
        c12 = jnp.cross(r1, r2)
        n01 = jnp.sum(c01 * c01, axis=-1, keepdims=True)
        n02 = jnp.sum(c02 * c02, axis=-1, keepdims=True)
        n12 = jnp.sum(c12 * c12, axis=-1, keepdims=True)
        best = jnp.where(n01 >= jnp.maximum(n02, n12), c01,
                         jnp.where(n02 >= n12, c02, c12))
        norm = jnp.sqrt(jnp.maximum(
            jnp.sum(best * best, axis=-1, keepdims=True), eps))
        return best / norm

    v2 = eigenvector(w2)
    v0 = eigenvector(w0)
    # Force orthogonality: v0 <- v0 - (v0.v2) v2; v1 = v2 x v0. When the
    # two smallest eigenvalues coincide (rank-1 A: a perfect line of
    # points) the cross-product eigenvector for w0 degenerates — fall
    # back to an arbitrary unit vector orthogonal to v2.
    v0 = v0 - jnp.sum(v0 * v2, axis=-1, keepdims=True) * v2
    v0sq = jnp.sum(v0 * v0, axis=-1, keepdims=True)
    pick_x = jnp.abs(v2[..., 0:1]) < 0.9
    axis = jnp.where(pick_x,
                     jnp.asarray([1.0, 0.0, 0.0], dtype),
                     jnp.asarray([0.0, 1.0, 0.0], dtype))
    fallback = jnp.cross(axis, v2)
    fallback = fallback / jnp.sqrt(jnp.maximum(
        jnp.sum(fallback * fallback, axis=-1, keepdims=True), eps))
    v0 = jnp.where(v0sq < 1e-12, fallback,
                   v0 / jnp.sqrt(jnp.maximum(v0sq, eps)))
    v1 = jnp.cross(v2, v0)

    # Isotropic fallback: identity basis.
    ex = jnp.broadcast_to(jnp.asarray([1.0, 0, 0], dtype), v0.shape)
    ey = jnp.broadcast_to(jnp.asarray([0, 1.0, 0], dtype), v0.shape)
    ez = jnp.broadcast_to(jnp.asarray([0, 0, 1.0], dtype), v0.shape)
    iso_b = iso[..., None]
    v0 = jnp.where(iso_b, ex, v0)
    v1 = jnp.where(iso_b, ey, v1)
    v2 = jnp.where(iso_b, ez, v2)
    w = jnp.where(iso[..., None], jnp.stack([q, q, q], axis=-1), w)

    v = jnp.stack([v0, v1, v2], axis=-1)  # columns are eigenvectors
    return w, v
