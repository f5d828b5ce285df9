"""Keyframe feature-map builder: the equivalent of the ``mapping``
package (``mapping/include/lidar_feature_mapping/map.hpp:40-150``).

The reference accumulates transformed scans into one growing PCL cloud,
gated by a keyframe motion threshold, and saves a PCD at shutdown. Here
the map is a fixed-capacity device tensor (points + validity) appended
to with dynamic-slice writes; the voxel-hash table for localization is
(re)built from it on demand. Both edge and surface maps are built —
the reference only wires the edge map (mapping.launch.py:79-88) but the
surface map is implied by symmetry (SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import MappingConfig
from lidar_feature_extraction_tpu.core.pose import Pose, pose_delta_magnitudes


class PointMapState(NamedTuple):
    """Append-only device point buffer."""

    points: jnp.ndarray   # [capacity, 3]
    n: jnp.ndarray        # scalar int32 write cursor
    prev_pose_q: jnp.ndarray
    prev_pose_t: jnp.ndarray
    has_prev: jnp.ndarray  # bool


def init_point_map(capacity: int, dtype=jnp.float32) -> PointMapState:
    return PointMapState(
        points=jnp.zeros((capacity, 3), dtype),
        n=jnp.zeros((), jnp.int32),
        prev_pose_q=jnp.array([1.0, 0, 0, 0], dtype),
        prev_pose_t=jnp.zeros(3, dtype),
        has_prev=jnp.zeros((), bool))


def keyframe_gate(state: PointMapState, pose: Pose,
                  cfg: MappingConfig) -> jnp.ndarray:
    """True when the scan should be added: first scan, or pose moved
    beyond the translation/rotation thresholds. Parity:
    ``PoseDiffIsSufficientlySmall`` + the skip logic in
    ``MapBuilder::Callback`` (map.hpp:49-59, :123-129)."""
    prev = Pose(state.prev_pose_q, state.prev_pose_t)
    dt, dq = pose_delta_magnitudes(prev, pose)
    small = (dt < cfg.keyframe_translation_threshold) \
        & (dq < cfg.keyframe_rotation_threshold)
    return ~state.has_prev | ~small


@jax.jit
def add_scan(state: PointMapState, scan_xyz: jnp.ndarray,
             scan_valid: jnp.ndarray, pose: Pose,
             accept: jnp.ndarray) -> PointMapState:
    """Transform the masked scan by ``pose`` and append its valid points
    at the cursor (Map::TransformAdd, map.hpp:68-73). When ``accept`` is
    False the state is returned unchanged. Valid points are compacted
    first so the buffer stays dense; overflowing points are dropped.
    """
    capacity = state.points.shape[0]
    n_scan = scan_xyz.shape[0]
    transformed = pose.apply(scan_xyz)

    (sel,) = jnp.nonzero(scan_valid, size=n_scan, fill_value=n_scan)
    ok = (sel < n_scan) & accept
    src = transformed[jnp.minimum(sel, n_scan - 1)]
    dst = state.n + jnp.arange(n_scan)
    ok = ok & (dst < capacity)
    # Out-of-bounds destinations are dropped by the scatter, leaving
    # existing buffer contents untouched.
    dst = jnp.where(ok, dst, capacity)
    points = state.points.at[dst].set(src, mode="drop")
    n_new = jnp.minimum(state.n + jnp.sum(ok.astype(jnp.int32)), capacity)
    return PointMapState(
        points=jnp.where(accept, points, state.points),
        n=jnp.where(accept, n_new, state.n),
        prev_pose_q=jnp.where(accept, pose.q, state.prev_pose_q),
        prev_pose_t=jnp.where(accept, pose.t, state.prev_pose_t),
        has_prev=state.has_prev | accept)


def map_mask(state: PointMapState) -> jnp.ndarray:
    return jnp.arange(state.points.shape[0]) < state.n


class MapBuilder:
    """Host-side driver mirroring ``MapBuilder`` (map.hpp:96-150): feed
    (scan, pose) pairs; the device state accumulates keyframes."""

    def __init__(self, cfg: MappingConfig, capacity: int | None = None,
                 dtype=jnp.float32):
        self.cfg = cfg
        self.state = init_point_map(capacity or cfg.max_map_points, dtype)

    def add(self, scan_xyz, scan_valid, pose: Pose) -> bool:
        accept = keyframe_gate(self.state, pose, self.cfg)
        self.state = add_scan(self.state, scan_xyz, scan_valid, pose, accept)
        return bool(accept)

    @property
    def points(self):
        return self.state.points

    @property
    def valid(self):
        return map_mask(self.state)

    def save_pcd(self, path: str) -> None:
        """SaveMap parity (map.hpp:135-148) via io/pcd.py."""
        import numpy as np

        from lidar_feature_extraction_tpu.io import pcd

        pts = np.asarray(self.points)[np.asarray(self.valid)]
        pcd.save_pcd(path, pts)
