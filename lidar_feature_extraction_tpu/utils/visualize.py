"""Visualization exports: colored point clouds and trajectories to PLY.

The reference ships rviz configs (``rviz/*.rviz``) as its visualization
layer; this engine is ROS-free, so debug artifacts export to PLY
(any standard viewer: MeshLab, CloudCompare, Open3D) instead. The
colored-label cloud mirrors the reference's ``colored_scan`` topic.
"""

from __future__ import annotations

import numpy as np


def save_ply(path: str, xyz: np.ndarray,
             rgb: np.ndarray | None = None) -> None:
    """Write points (+ optional uint8 colors) as binary little-endian PLY."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    has_color = rgb is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = xyz
            rec["rgb"] = np.ascontiguousarray(rgb, np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(xyz.tobytes())


def export_labeled_scan(path: str, image_xyz, mask, labels) -> None:
    """The ``colored_scan`` debug cloud as PLY."""
    from lidar_feature_extraction_tpu.ops.color import color_by_label

    m = np.asarray(mask).reshape(-1)
    pts = np.asarray(image_xyz).reshape(-1, 3)[m]
    rgb = np.asarray(color_by_label(labels)).reshape(-1, 3)[m]
    save_ply(path, pts, rgb)


def export_trajectory(path: str, positions: np.ndarray,
                      color=(255, 200, 0)) -> None:
    pts = np.asarray(positions, np.float32)
    rgb = np.tile(np.asarray(color, np.uint8), (len(pts), 1))
    save_ply(path, pts, rgb)
