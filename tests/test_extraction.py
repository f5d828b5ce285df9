"""Parity tests: array extraction kernels vs the sequential numpy oracle
(tests/np_ref.py) that mirrors the C++ reference's behavior."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import np_ref
from lidar_feature_extraction_tpu.config import ExtractionConfig
from lidar_feature_extraction_tpu.core.scan import (RangeImage,
                                                    build_range_image)
from lidar_feature_extraction_tpu.ops import extraction as ex

jax.config.update("jax_enable_x64", True)


def make_synthetic_ring(rng, n, edge_fraction=0.05):
    """Azimuth-sorted ring: smooth arcs with occasional range jumps so
    all label classes (edges, surfaces, occlusion, parallel beams) occur."""
    az = np.sort(rng.uniform(-np.pi, np.pi, size=n))
    r = 10.0 + 2.0 * np.sin(3 * az)
    # Range discontinuities -> occlusion triggers + edges
    for s in rng.choice(n, size=max(1, int(n * edge_fraction)), replace=False):
        r[s:] += rng.uniform(-3, 3)
    r = np.abs(r) + 0.5
    z = rng.uniform(-2, 2) + 0.05 * az
    xyz = np.stack([r * np.cos(az), r * np.sin(az), np.full(n, z)], axis=-1)
    return xyz


def ring_to_image(xyz_ring, max_pts, n_rings=1, row=0):
    n = len(xyz_ring)
    xyz = np.zeros((n_rings, max_pts, 3))
    mask = np.zeros((n_rings, max_pts), bool)
    xyz[row, :n] = xyz_ring
    mask[row, :n] = True
    count = np.zeros(n_rings, np.int32)
    count[row] = n
    return RangeImage(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(count))


# A cap >= the largest block size makes the bounded NMS exactly
# equivalent to the sequential oracle: blocks of a 512-point ring have
# at most ceil((512-2*5)/6)+1 = 85 points.
CFG = ExtractionConfig(n_rings=1, max_points_per_ring=512,
                       nms_rounds=96)


def test_curvature_matches_oracle():
    rng = np.random.default_rng(0)
    ring = make_synthetic_ring(rng, 300)
    img = ring_to_image(ring, 512)
    r = np.hypot(ring[:, 0], ring[:, 1])
    want = np_ref.calc_curvature(r, CFG.padding)
    got = np.asarray(ex.curvature_kernel(
        jnp.where(img.mask, jnp.hypot(img.xyz[..., 0], img.xyz[..., 1]), 0.0),
        img.count, CFG.padding))[0, :300]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_neighbor_flags_match_oracle():
    rng = np.random.default_rng(1)
    ring = make_synthetic_ring(rng, 200)
    img = ring_to_image(ring, 512)
    want = np_ref.neighbor_pairs(ring[:, :2],
                                 math.radians(CFG.neighbor_degree_threshold))
    got = np.asarray(ex.neighbor_flags(img.xyz, img.count,
                                       CFG.radian_threshold))[0]
    np.testing.assert_array_equal(got[:199], want)
    assert not got[199:].any()


def test_block_ids_match_oracle():
    for n in [16, 17, 100, 301, 512]:
        count = jnp.asarray([n])
        got = np.asarray(ex.block_ids(count, 512, CFG.padding, CFG.n_blocks))[0]
        bounds = np_ref.block_boundaries(n, CFG.padding, CFG.n_blocks)
        want = np.full(512, -1)
        for j in range(CFG.n_blocks):
            want[bounds[j]:bounds[j + 1]] = j
        np.testing.assert_array_equal(got, want)


def test_block_ids_inactive_small_ring():
    n = 2 * CFG.padding + CFG.n_blocks - 1  # one too small
    got = np.asarray(ex.block_ids(jnp.asarray([n]), 512, CFG.padding,
                                  CFG.n_blocks))[0]
    assert (got == -1).all()


@pytest.mark.parametrize("seed", range(8))
def test_full_labeling_parity(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 500))
    ring = make_synthetic_ring(rng, n)
    img = ring_to_image(ring, 512)

    want = np_ref.extract_ring_labels(ring, CFG)
    labels, _ = ex.label_range_image(img, CFG)
    got = np.asarray(labels)[0, :n]

    # Edge/Surface/masking labels must agree exactly. EdgeNeighbor vs
    # SurfaceNeighbor may differ only in overwrite cases that don't
    # affect extracted features (see ops/extraction.py docstring) — but
    # the faithful implementation should match exactly, so require it.
    np.testing.assert_array_equal(got, want)


def test_multi_ring_batching_matches_single():
    rng = np.random.default_rng(99)
    cfg = ExtractionConfig(n_rings=4, max_points_per_ring=512,
                           nms_rounds=96)
    rings = [make_synthetic_ring(rng, int(rng.integers(30, 400)))
             for _ in range(4)]
    xyz = np.zeros((4, 512, 3))
    mask = np.zeros((4, 512), bool)
    count = np.zeros(4, np.int32)
    for i, ring in enumerate(rings):
        xyz[i, :len(ring)] = ring
        mask[i, :len(ring)] = True
        count[i] = len(ring)
    img = RangeImage(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(count))
    labels, _ = ex.label_range_image(img, cfg)
    for i, ring in enumerate(rings):
        want = np_ref.extract_ring_labels(ring, cfg)
        np.testing.assert_array_equal(np.asarray(labels)[i, :len(ring)], want)


def test_extract_features_compaction():
    rng = np.random.default_rng(3)
    ring = make_synthetic_ring(rng, 400)
    img = ring_to_image(ring, 512)
    res = ex.extract_features(img, CFG)
    labels = np.asarray(res.labels)[0, :400]
    n_edges = int((labels == np_ref.EDGE).sum())
    n_surf = int((labels == np_ref.SURFACE).sum())
    assert int(res.edge_valid.sum()) == n_edges
    assert int(res.surface_valid.sum()) == n_surf
    # Compacted points are exactly the labeled ones, in scan order.
    want_edges = ring[labels == np_ref.EDGE]
    np.testing.assert_allclose(np.asarray(res.edge_xyz)[:n_edges], want_edges,
                               atol=1e-12)


def test_build_range_image_sorts_by_azimuth():
    rng = np.random.default_rng(4)
    n = 256
    ring_sorted = make_synthetic_ring(rng, n)
    perm = rng.permutation(n)
    xyz = ring_sorted[perm]
    img = build_range_image(jnp.asarray(xyz), jnp.zeros(n, jnp.int32),
                            jnp.ones(n, bool), n_rings=1,
                            max_points_per_ring=512)
    assert int(img.count[0]) == n
    np.testing.assert_allclose(np.asarray(img.xyz)[0, :n], ring_sorted,
                               atol=1e-12)
    assert not np.asarray(img.mask)[0, n:].any()


def test_build_range_image_multi_ring_and_sparse_drop():
    rng = np.random.default_rng(5)
    # ring 0: 100 pts, ring 1: 3 pts (sparse -> dropped at min_points=6)
    r0 = make_synthetic_ring(rng, 100)
    r1 = make_synthetic_ring(rng, 3)
    xyz = np.concatenate([r0, r1])
    ring = np.concatenate([np.zeros(100, int), np.ones(3, int)])
    perm = rng.permutation(103)
    img = build_range_image(jnp.asarray(xyz[perm]),
                            jnp.asarray(ring[perm]),
                            jnp.ones(103, bool), n_rings=2,
                            max_points_per_ring=128, min_points_per_ring=6)
    assert int(img.count[0]) == 100
    assert int(img.count[1]) == 0
    assert not np.asarray(img.mask)[1].any()
    np.testing.assert_allclose(np.asarray(img.xyz)[0, :100], r0, atol=1e-12)


def _nms_oracle(curvature, nb, n, cfg):
    """Sequential labeling only (no masking passes) on explicit
    curvature/neighbor arrays."""
    labels = np.full(n, np_ref.DEFAULT)
    np_ref.assign_labels(labels, curvature.astype(float), nb, n,
                         cfg.padding, cfg.n_blocks, cfg.edge_threshold,
                         cfg.surface_threshold)
    return labels


def _nms_device(curvature, nb, n, cfg, max_pts=128):
    curv = jnp.zeros((1, max_pts)).at[0, :n].set(curvature)
    nbj = jnp.zeros((1, max_pts), bool).at[0, :n - 1].set(nb)
    g = ex.gap_prefix(nbj)
    blk = ex.block_ids(jnp.asarray([n]), max_pts, cfg.padding,
                       cfg.n_blocks)
    labels = jnp.full((1, max_pts), ex.DEFAULT, jnp.int32)
    labels = ex._nms_pass(labels, curv, blk, g, jnp.asarray([n]),
                          padding=cfg.padding, n_blocks=cfg.n_blocks,
                          threshold=cfg.edge_threshold, pick_max=True,
                          point_code=ex.EDGE,
                          neighbor_code=ex.EDGE_NEIGHBOR,
                          n_iter=cfg.nms_rounds)
    labels = ex._nms_pass(labels, curv, blk, g, jnp.asarray([n]),
                          padding=cfg.padding, n_blocks=cfg.n_blocks,
                          threshold=cfg.surface_threshold, pick_max=False,
                          point_code=ex.SURFACE,
                          neighbor_code=ex.SURFACE_NEIGHBOR,
                          n_iter=cfg.nms_rounds)
    return np.asarray(labels)[0, :n]


def test_nms_exact_ties_match_stable_sequential_order():
    """All-equal curvature: selection must follow the stable sequential
    order (higher index first for edges, lower first for surfaces)."""
    n = 100
    cfg = ExtractionConfig(nms_rounds=128, n_blocks=2, padding=3,
                           edge_threshold=1e9, surface_threshold=1e12)
    curvature = np.zeros(n)          # exact ties everywhere
    nb = np.ones(n - 1, bool)
    want = _nms_oracle(curvature, nb, n, cfg)
    got = _nms_device(curvature, nb, n, cfg)
    np.testing.assert_array_equal(got, want)

    # Edge pass with ties: everything above threshold 0 (ties at 1.0).
    cfg2 = ExtractionConfig(nms_rounds=128, n_blocks=2, padding=3,
                            edge_threshold=1.0, surface_threshold=-1.0)
    curvature2 = np.ones(n)
    want2 = _nms_oracle(curvature2, nb, n, cfg2)
    got2 = _nms_device(curvature2, nb, n, cfg2)
    np.testing.assert_array_equal(got2, want2)


def test_nms_adversarial_monotone_chain():
    """Monotonically decreasing curvature spaced closer than the
    suppression window forces one resolution per round (worst case for
    multi-select NMS)."""
    n = 100
    cfg = ExtractionConfig(nms_rounds=128, n_blocks=1, padding=4,
                           edge_threshold=1.0, surface_threshold=-1.0)
    curvature = np.arange(n, 0, -1).astype(float)  # strictly decreasing
    nb = np.ones(n - 1, bool)
    want = _nms_oracle(curvature, nb, n, cfg)
    got = _nms_device(curvature, nb, n, cfg)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_nms_random_integer_curvatures_with_duplicates(seed):
    """Randomized NMS parity on integer curvature (exactly
    representable in both precisions) with many duplicates and random
    connectivity gaps."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 120))
    cfg = ExtractionConfig(nms_rounds=128,
                           n_blocks=int(rng.integers(1, 4)),
                           padding=int(rng.integers(1, 5)),
                           edge_threshold=6.0, surface_threshold=3.0)
    if n - 2 * cfg.padding < cfg.n_blocks:
        return
    curvature = rng.integers(0, 10, size=n).astype(float)
    nb = rng.random(n - 1) < 0.8
    want = _nms_oracle(curvature, nb, n, cfg)
    got = _nms_device(curvature, nb, n, cfg)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# extract_features_compact: the single-matmul compaction path
# ---------------------------------------------------------------------------

def _multi_ring_image(rng, n_rings=4, max_pts=512):
    rings = [make_synthetic_ring(rng, int(rng.integers(60, 450)))
             for _ in range(n_rings)]
    xyz = np.zeros((n_rings, max_pts, 3))
    mask = np.zeros((n_rings, max_pts), bool)
    count = np.zeros(n_rings, np.int32)
    for i, ring in enumerate(rings):
        xyz[i, :len(ring)] = ring
        mask[i, :len(ring)] = True
        count[i] = len(ring)
    return RangeImage(jnp.asarray(xyz), jnp.asarray(mask),
                      jnp.asarray(count))


def _voxel_run_key_np(xyz, leaf):
    c = np.floor(xyz / leaf).astype(np.int32)
    return ((c[..., 0] * np.int32(73856093))
            ^ (c[..., 1] * np.int32(19349663))
            ^ (c[..., 2] * np.int32(83492791)))


def _compact_oracle(xyz, mask, labels, leaf, ce, cs, centroid):
    """Sequential oracle of the documented compact semantics."""
    R, P = labels.shape
    edge = np.zeros((R, ce, 3))
    edge_ok = np.zeros((R, ce), bool)
    surf = np.zeros((R, cs, 3))
    surf_ok = np.zeros((R, cs), bool)
    key = _voxel_run_key_np(xyz, leaf)
    for r in range(R):
        e = 0
        runs = []       # list of [sum_xyz, count, last_xyz]
        prev_in_run = False
        for p in range(P):
            if mask[r, p] and labels[r, p] == np_ref.EDGE and e < ce:
                edge[r, e] = xyz[r, p]
                edge_ok[r, e] = True
                e += 1
            in_surf = mask[r, p] and labels[r, p] == np_ref.SURFACE
            if in_surf:
                if prev_in_run and key[r, p] == key[r, p - 1]:
                    runs[-1][0] += xyz[r, p]
                    runs[-1][1] += 1
                    runs[-1][2] = xyz[r, p]
                else:
                    runs.append([xyz[r, p].copy(), 1, xyz[r, p]])
            prev_in_run = in_surf
        n_runs = max(len(runs), 1)
        denom = max(n_runs, cs)
        prev_col = -1
        for rid, (s, n, last) in enumerate(runs):
            col = (rid * cs) // denom
            if col > prev_col:
                surf[r, col] = s / n if centroid else last
                surf_ok[r, col] = True
                prev_col = col
    return edge, edge_ok, surf, surf_ok


@pytest.mark.parametrize("seed,centroid", [(0, True), (1, True),
                                           (2, False), (3, False)])
def test_extract_features_compact_matches_oracle(seed, centroid):
    rng = np.random.default_rng(seed)
    cfg = ExtractionConfig(n_rings=4, max_points_per_ring=512,
                           nms_rounds=96, surface_threshold=0.3)
    img = _multi_ring_image(rng, 4, 512)
    leaf, ce, cs = 1.0, 16, 24
    res = ex.extract_features_compact(img, cfg, surface_leaf=leaf,
                                      edges_per_ring=ce,
                                      surface_runs_per_ring=cs,
                                      surface_centroid=centroid)
    labels = np.asarray(res.labels)
    mask = np.asarray(img.mask)
    e, eok, s, sok = _compact_oracle(np.asarray(img.xyz), mask, labels,
                                     leaf, ce, cs, centroid)
    np.testing.assert_array_equal(
        np.asarray(res.edge_valid).reshape(4, ce), eok)
    np.testing.assert_allclose(
        np.asarray(res.edge_xyz).reshape(4, ce, 3), e, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(res.surface_valid).reshape(4, cs), sok)
    np.testing.assert_allclose(
        np.asarray(res.surface_xyz).reshape(4, cs, 3), s, atol=1e-5)


def test_extract_features_compact_edges_match_standard_path():
    """With no per-ring overflow, the compact edge set equals the
    standard path's compacted edge set (as point sets)."""
    rng = np.random.default_rng(11)
    cfg = ExtractionConfig(n_rings=4, max_points_per_ring=512,
                           nms_rounds=96)
    img = _multi_ring_image(rng, 4, 512)
    std = ex.extract_features(img, cfg)
    cmp_ = ex.extract_features_compact(img, cfg, surface_leaf=1.0,
                                       edges_per_ring=128,
                                       surface_runs_per_ring=16)
    want = np.asarray(std.edge_xyz)[np.asarray(std.edge_valid)]
    got = np.asarray(cmp_.edge_xyz)[np.asarray(cmp_.edge_valid)]
    assert len(want) == len(got)
    order_w = np.lexsort(want.T)
    order_g = np.lexsort(got.T)
    np.testing.assert_allclose(got[order_g], want[order_w], atol=1e-6)
