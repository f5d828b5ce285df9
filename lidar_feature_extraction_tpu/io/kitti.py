"""KITTI odometry dataset readers.

The reference consumes ROS bags; this engine replays KITTI velodyne
``.bin`` scans (float32 x,y,z,intensity records) directly. Ring indices
are not stored in KITTI scans, so they are recovered geometrically from
the elevation angle — the standard HDL-64E beam model.

Uses the native C shim (native/) via ctypes when built, falling back to
numpy.fromfile; both paths produce identical arrays.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

# HDL-64E vertical field of view (degrees).
_HDL64_UP = 2.0
_HDL64_DOWN = -24.8


def read_velodyne_bin(path: str) -> np.ndarray:
    """Load one KITTI scan: returns [N, 4] float32 (x, y, z, intensity)."""
    from lidar_feature_extraction_tpu.io import native_io

    data = native_io.read_f32(path)
    return data.reshape(-1, 4)


def estimate_rings(xyz: np.ndarray, n_rings: int = 64,
                   fov_up: float = _HDL64_UP,
                   fov_down: float = _HDL64_DOWN) -> np.ndarray:
    """Ring index from elevation angle (uniform beam-angle model)."""
    d = np.linalg.norm(xyz[:, :2], axis=-1)
    elev = np.degrees(np.arctan2(xyz[:, 2], np.maximum(d, 1e-9)))
    frac = (fov_up - elev) / (fov_up - fov_down)
    ring = np.floor(frac * n_rings).astype(np.int32)
    return np.clip(ring, 0, n_rings - 1)


def scan_files(sequence_dir: str) -> list[str]:
    files = sorted(f for f in os.listdir(sequence_dir) if f.endswith(".bin"))
    return [os.path.join(sequence_dir, f) for f in files]


def iter_scans(sequence_dir: str, limit: int | None = None
               ) -> Iterator[np.ndarray]:
    for path in scan_files(sequence_dir)[:limit]:
        yield read_velodyne_bin(path)


def load_poses(path: str) -> np.ndarray:
    """KITTI odometry ground-truth poses: [N, 3, 4] row-major."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    return raw.astype(np.float64)
