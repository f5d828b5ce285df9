"""Plain-numpy reference implementations mirroring the C++ reference's
*sequential* semantics (written from the surveyed behavior of
tier4/lidar_feature_extraction, not copied). These are the golden oracles
for the array kernels: slow, scalar, order-faithful.

Reference behavior sources are cited per function.
"""

from __future__ import annotations

import math

import numpy as np

DEFAULT = 0
EDGE = 1
EDGE_NEIGHBOR = 2
SURFACE = 3
SURFACE_NEIGHBOR = 4
OUT_OF_RANGE = 5
OCCLUDED = 6
PARALLEL_BEAM = 7


def calc_curvature(ranges: np.ndarray, padding: int) -> np.ndarray:
    """curvature.cpp:36-51 + convolution.cpp:35-66."""
    n = len(ranges)
    w = np.ones(2 * padding + 1)
    w[padding] = -2.0 * padding
    out = np.zeros(n)
    for i in range(padding, n - padding):
        out[i] = np.dot(ranges[i - padding:i + padding + 1], w) ** 2
    return out


def is_neighbor(xy: np.ndarray, i: int, j: int, radian_threshold: float) -> bool:
    """neighbor.hpp:45 + math.cpp:34-49."""
    a, b = xy[i], xy[j]
    dot = float(a @ b)
    n1, n2 = np.hypot(*a), np.hypot(*b)
    if n1 == 0 and n2 == 0:
        raise ValueError("zero vectors")
    c = np.clip(dot / (n1 * n2), -1.0, 1.0)
    return math.acos(c) < radian_threshold


def neighbor_pairs(xy: np.ndarray, radian_threshold: float) -> np.ndarray:
    """nb[i] = is_neighbor(i, i+1), length n-1."""
    return np.array([is_neighbor(xy, i, i + 1, radian_threshold)
                     for i in range(len(xy) - 1)])


def fill_from_left(labels, nb, begin, end, label):
    """fill.hpp:41-66: labels [begin, end-1] stopping after a gap."""
    for i in range(begin, end - 1):
        labels[i] = label
        if not nb[i]:
            return
    labels[end - 1] = label


def fill_from_right(labels, nb, begin, end, label):
    """fill.hpp:71-97: labels [end, begin+1] downward, stopping at a gap."""
    for i in range(end, begin + 1, -1):
        labels[i] = label
        if not nb[i - 1]:
            return
    labels[begin + 1] = label


def fill_neighbors(labels, nb, index, padding, label):
    """fill.hpp:102-118."""
    lo = max(-1, index - padding - 1)
    hi = min(index + 1 + padding, len(labels))
    fill_from_right(labels, nb, lo, index, label)
    fill_from_left(labels, nb, index, hi, label)


def block_boundaries(n: int, padding: int, n_blocks: int) -> list[int]:
    """index_range.cpp:31-79 (PaddedIndexRange: start=padding,
    end=n-padding). Raises like the C++ ctor when the ring is too small.

    Deliberate deviation: the C++ evaluates
    ``int(s*(1.-j/n) + e*j/n)`` in double and truncates, which can land
    one below the exact rational value when it is an exact integer
    (float round-down). We use the integer-exact floor
    ``(s*(B-j) + e*j) // B`` in both the oracle and the array kernel; the
    partitions differ from the C++ by at most one point at exact-integer
    boundaries."""
    s, e = padding, n - padding
    if e - s < n_blocks:
        raise ValueError("ring too small for n_blocks")
    return [(s * (n_blocks - j) + e * j) // n_blocks
            for j in range(n_blocks + 1)]


def assign_labels(labels, curvature, nb, n, padding, n_blocks,
                  edge_threshold, surface_threshold):
    """label.hpp:61-164: per block, descending-curvature edge pass then
    ascending-curvature surface pass, each suppressing +/-padding
    connected neighbors. Operates on block-local views exactly like the
    C++ span slicing."""
    bounds = block_boundaries(n, padding, n_blocks)
    for j in range(n_blocks):
        b, e = bounds[j], bounds[j + 1]
        lview = labels[b:e]
        cview = curvature[b:e]
        nbview = nb[b:e - 1] if e - 1 > b else nb[b:b]
        order = np.argsort(cview, kind="stable")
        for idx in order[::-1]:  # descending: edges
            if lview[idx] == DEFAULT and cview[idx] >= edge_threshold:
                fill_neighbors(lview, nbview, idx, padding, EDGE_NEIGHBOR)
                lview[idx] = EDGE
        for idx in order:  # ascending: surfaces
            if lview[idx] == DEFAULT and cview[idx] <= surface_threshold:
                fill_neighbors(lview, nbview, idx, padding, SURFACE_NEIGHBOR)
                lview[idx] = SURFACE


def label_occluded(labels, nb, ranges, padding, distance_diff_threshold):
    """occlusion.hpp:38-93."""
    n = len(labels)
    for i in range(0, n - padding - 1):
        if not nb[i]:
            continue
        if ranges[i + 1] > ranges[i] + distance_diff_threshold:
            fill_from_left(labels, nb, i + 1, i + padding + 2, OCCLUDED)
    for i in range(n - 1, padding, -1):
        if not nb[i - 1]:
            continue
        if ranges[i - 1] > ranges[i] + distance_diff_threshold:
            fill_from_right(labels, nb, i - padding - 2, i - 1, OCCLUDED)


def label_out_of_range(labels, ranges, min_range, max_range):
    """out_of_range.hpp:37-47."""
    for i in range(len(labels)):
        if not (min_range <= ranges[i] <= max_range):
            labels[i] = OUT_OF_RANGE


def label_parallel_beam(labels, ranges, ratio_threshold):
    """parallel_beam.hpp:37-53."""
    for i in range(1, len(labels) - 1):
        r1 = abs(ranges[i - 1] - ranges[i]) / ranges[i]
        r2 = abs(ranges[i + 1] - ranges[i]) / ranges[i]
        if r1 > ratio_threshold and r2 > ratio_threshold:
            labels[i] = PARALLEL_BEAM


def extract_ring_labels(xyz: np.ndarray, cfg) -> np.ndarray:
    """Full per-ring labeling pipeline in the reference's order
    (feature_extraction.cpp:120-157). ``xyz`` is one azimuth-sorted
    compacted ring [n, 3]. Returns the int label array, or all-DEFAULT
    if the ring would have been skipped by a thrown exception."""
    n = len(xyz)
    labels = np.full(n, DEFAULT)
    ranges = np.hypot(xyz[:, 0], xyz[:, 1])
    radian_threshold = math.radians(cfg.neighbor_degree_threshold)
    try:
        nb = neighbor_pairs(xyz[:, :2], radian_threshold)
        curvature = calc_curvature(ranges, cfg.padding)
        assign_labels(labels, curvature, nb, n, cfg.padding, cfg.n_blocks,
                      cfg.edge_threshold, cfg.surface_threshold)
        label_occluded(labels, nb, ranges, cfg.padding,
                       cfg.distance_diff_threshold)
        label_out_of_range(labels, ranges, cfg.min_range, cfg.max_range)
        label_parallel_beam(labels, ranges, cfg.parallel_beam_min_range_ratio)
    except ValueError:
        return np.full(n, DEFAULT)
    return labels
