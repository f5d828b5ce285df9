"""Range-image scan container: the fixed-shape replacement for
per-ring ``std::vector`` point lists.

The reference groups points by the ``ring`` field into a hash map of
index vectors and sorts each ring by azimuth with a branch-heavy
comparator (``ExtractAngleSortedRings``, ``extraction/include/
lidar_feature_extraction/ring.hpp:115-166``). Here a raw scan
``(xyz [N,3], ring [N])`` becomes one padded tensor ``[n_rings,
max_points_per_ring, 3]`` plus a validity mask via a single device-side
argsort over a composite (ring, azimuth) key — O(N log N), fully batched,
no per-ring control flow.

Rings with fewer than ``padding + 1`` valid points are masked out
entirely (parity: ``RemoveSparseRings``, ``extraction/src/ring.cpp:46``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class RangeImage(NamedTuple):
    """Azimuth-sorted, ring-major scan.

    xyz:   [R, P, 3] point coordinates; garbage where ``mask`` is False.
    mask:  [R, P] validity. Valid points are compacted to the front of
           each ring and sorted by ascending atan2(y, x).
    count: [R] number of valid points per ring.
    """

    xyz: jnp.ndarray
    mask: jnp.ndarray
    count: jnp.ndarray

    @property
    def n_rings(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_points(self) -> int:
        return self.xyz.shape[1]


def build_range_image(
    xyz: jnp.ndarray,
    ring: jnp.ndarray,
    valid: jnp.ndarray,
    n_rings: int,
    max_points_per_ring: int,
    min_points_per_ring: int = 0,
) -> RangeImage:
    """Organize a raw scan into a RangeImage.

    xyz:   [N, 3] float points (N is static; pad with ``valid=False``).
    ring:  [N] int ring index in [0, n_rings).
    valid: [N] bool — False for padding / dropped points.

    The reference sorts with an atan2-free polar-angle comparator
    (``ring.hpp:55-98``) whose order equals ascending ``atan2(y, x)``
    over (-pi, pi]; we compute the angle directly — one fused VPU pass.
    """
    n = xyz.shape[0]
    azimuth = jnp.arctan2(xyz[:, 1], xyz[:, 0])  # (-pi, pi]
    ring = jnp.clip(ring, 0, n_rings - 1)
    ring_ok = valid
    # Composite sort key: invalid points to the very end, then by ring,
    # then by azimuth. Azimuth spans < 2*pi, so a stride of 8 separates
    # rings unambiguously.
    key = jnp.where(ring_ok, ring.astype(xyz.dtype) * 8.0 + azimuth,
                    jnp.asarray(jnp.inf, xyz.dtype))
    order = jnp.argsort(key)
    sorted_xyz = xyz[order]
    sorted_ring = ring[order]
    sorted_valid = ring_ok[order]

    # Position of each sorted point within its ring = global position
    # minus the number of points in preceding rings.
    counts = jnp.bincount(jnp.where(ring_ok, ring, n_rings),
                          length=n_rings + 1)[:n_rings]
    ring_starts = jnp.concatenate(
        [jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
    pos_global = jnp.arange(n)
    pos_in_ring = pos_global - ring_starts[sorted_ring]

    keep = sorted_valid & (pos_in_ring < max_points_per_ring)
    rows = jnp.where(keep, sorted_ring, n_rings)
    cols = jnp.where(keep, pos_in_ring, 0)

    img = jnp.zeros((n_rings + 1, max_points_per_ring, 3), xyz.dtype)
    img = img.at[rows, cols].set(sorted_xyz, mode="drop")
    msk = jnp.zeros((n_rings + 1, max_points_per_ring), bool)
    msk = msk.at[rows, cols].set(keep, mode="drop")

    img = img[:n_rings]
    msk = msk[:n_rings]
    count = jnp.minimum(counts, max_points_per_ring)

    if min_points_per_ring > 0:
        ring_alive = count >= min_points_per_ring
        msk = msk & ring_alive[:, None]
        count = jnp.where(ring_alive, count, 0)

    return RangeImage(xyz=img, mask=msk, count=count)


def xy_range(image: RangeImage) -> jnp.ndarray:
    """Per-point XY-plane range, [R, P]. Parity: ``XYNorm``
    (``extraction/include/lidar_feature_extraction/math.hpp:36``) — the
    reference's ``Range`` uses the XY norm, not the 3D norm."""
    return jnp.sqrt(image.xyz[..., 0] ** 2 + image.xyz[..., 1] ** 2)
