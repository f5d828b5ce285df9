"""Quaternion calculus, fully vectorized over point batches.

Array-native re-design of the reference's ``rotationlib`` (C++/Eigen free
functions over single quaternions): every function here accepts arbitrary
leading batch dimensions and is jit/vmap/grad friendly.

Conventions: quaternions are ``[..., 4]`` arrays in **wxyz** order
(matching ``rotationlib/src/quaternion.cpp:35-45``); rotations act as
``R(q) p``; the Jacobian ``drpdq`` follows Sola, "Quaternion kinematics
for the error-state Kalman filter", eq. 174 (the same formulation as
``rotationlib/src/jacobian/quaternion.cpp:35-52``).
"""

from __future__ import annotations

import jax.numpy as jnp


def hat(v: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric (cross-product) matrix of ``v``: ``hat(v) @ u = v x u``.

    Parity: ``rotationlib/src/hat.cpp:35``. Batched: ``[..., 3] -> [..., 3, 3]``.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    rows = jnp.stack([
        jnp.stack([zero, -z, y], axis=-1),
        jnp.stack([z, zero, -x], axis=-1),
        jnp.stack([-y, x, zero], axis=-1),
    ], axis=-2)
    return rows


def quat_identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product ``a * b`` in wxyz, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def quat_rotate(q: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Rotate point(s) ``p`` [..., 3] by quaternion(s) ``q`` [..., 4].

    Uses the expanded Rodrigues form (two cross products) — cheaper on the
    VPU than building rotation matrices for single-point use.
    """
    w = q[..., :1]
    v = q[..., 1:]
    uv = jnp.cross(v, p)
    uuv = jnp.cross(v, uv)
    return p + 2.0 * (w * uv + uuv)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return jnp.stack([
        jnp.stack([1.0 - (tyy + tzz), txy - twz, txz + twy], axis=-1),
        jnp.stack([txy + twz, 1.0 - (txx + tzz), tyz - twx], axis=-1),
        jnp.stack([txz - twy, tyz + twx, 1.0 - (txx + tyy)], axis=-1),
    ], axis=-2)


def matrix_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] wxyz.

    Branch-free Shepperd-style extraction: computes all four candidate
    quaternions and selects by the largest pivot — XLA-friendly (no
    data-dependent control flow).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                   axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                   axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                   axis=-1)

    pivots = jnp.stack([1.0 + tr,
                        1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], axis=-1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4, 4]
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32)
                            .repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign (w >= 0) so round-trips are deterministic.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def left_multiplication_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """4x4 matrix L(q) with ``L(q) vec(r) = vec(q*r)``.

    Parity: ``rotationlib/src/quaternion.cpp:45-59``.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([w, -x, -y, -z], axis=-1),
        jnp.stack([x, w, -z, y], axis=-1),
        jnp.stack([y, z, w, -x], axis=-1),
        jnp.stack([z, -y, x, w], axis=-1),
    ], axis=-2)


def right_multiplication_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """4x4 matrix R(q) with ``R(q) vec(l) = vec(l*q)``.

    Parity: ``rotationlib/src/quaternion.cpp:62-76``.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([w, -x, -y, -z], axis=-1),
        jnp.stack([x, w, z, -y], axis=-1),
        jnp.stack([y, -z, w, x], axis=-1),
        jnp.stack([z, y, -x, w], axis=-1),
    ], axis=-2)


def rpy_to_quat(roll, pitch, yaw) -> jnp.ndarray:
    """ZYX-composed roll/pitch/yaw -> quaternion.

    Parity: ``rotationlib/src/quaternion.cpp:79-86`` (qz * qy * qx).
    """
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    cr, sr = jnp.cos(hr), jnp.sin(hr)
    cp, sp = jnp.cos(hp), jnp.sin(hp)
    cy, sy = jnp.cos(hy), jnp.sin(hy)
    return jnp.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], axis=-1)


def quat_yaw(q: jnp.ndarray) -> jnp.ndarray:
    """Extract yaw (rotation about +z) from a quaternion, batched."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def exp_so3(theta: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    """Angle-axis vector [..., 3] -> unit quaternion (exponential map).

    Parity: ``localization/src/posevec.cpp:32-44`` (AngleAxisToQuaternion),
    with a Taylor-safe small-angle branch expressed via ``where`` instead
    of control flow.
    """
    k = jnp.linalg.norm(theta, axis=-1, keepdims=True)
    small = k < eps
    ksafe = jnp.where(small, 1.0, k)
    half = ksafe * 0.5
    sinc = jnp.where(small, 0.5, jnp.sin(half) / ksafe)
    w = jnp.where(small[..., 0], 1.0, jnp.cos(half[..., 0]))
    xyz = theta * sinc
    return jnp.concatenate([w[..., None], xyz], axis=-1)


def log_so3(q: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    """Unit quaternion -> angle-axis vector (logarithmic map), batched."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 branch
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vn = jnp.linalg.norm(q[..., 1:], axis=-1)
    angle = 2.0 * jnp.arctan2(vn, w)
    scale = jnp.where(vn < eps, 2.0, angle / jnp.maximum(vn, eps))
    return q[..., 1:] * scale[..., None]


def drpdq(q: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Jacobian d(R(q) p)/dq, shape [..., 3, 4].

    Sola eq. 174; parity: ``rotationlib/src/jacobian/quaternion.cpp:35-52``.
    Batched over arbitrary leading dims of both ``q`` [..., 4] and ``p``
    [..., 3].
    """
    w = q[..., :1]
    v = q[..., 1:]
    col0 = w * p + jnp.cross(v, p)  # [..., 3]
    vdotp = jnp.sum(v * p, axis=-1, keepdims=True)  # [..., 1]
    eye = jnp.eye(3, dtype=q.dtype)
    right = (vdotp[..., None] * eye
             + v[..., :, None] * p[..., None, :]
             - p[..., :, None] * v[..., None, :]
             - w[..., None] * hat(p))
    return 2.0 * jnp.concatenate([col0[..., :, None], right], axis=-1)
