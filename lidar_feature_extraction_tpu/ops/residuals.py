"""Batched edge / surface correspondence residuals and Jacobians.

Array re-design of the reference's per-point residual factories:

- edge (point-to-line): ``Edge::Make`` (``localization/include/
  lidar_feature_localization/edge.hpp:78-126``, ``src/edge.cpp:43-98``).
  Per scan point: k-NN in the edge map, PCA of the neighborhood, the
  principal axis spans two virtual points p1 = mean - principal,
  p2 = mean + principal; residual (p - p1) x (p - p2) in R^3, Jacobian
  [Hat(p2-p1) @ DRpDq | Hat(p2-p1)] in R^{3x7};
- surface (point-to-plane): ``Surface::Make`` (``surface.hpp:96-143``).
  Per downsampled point: k-NN in the surface map, least-squares plane
  X w = -1, residual (w.x + 1)/|w| in R, Jacobian [u^T DRpDq | u^T]
  with u = w/|w|.

Everything is one fused batch on the VPU/MXU. Invalid lanes (masked
scan points, starved neighborhoods) carry zero Jacobians/residuals so
they drop out of the normal equations.

Two retrieval paths:
- ``edge_residuals`` / ``surface_residuals``: full kNN against a map
  structure (dense voxel grid or voxel-hash table);
- ``*_residuals_from_candidates``: top-k against a **cached candidate
  set** gathered once per search round — the retrieval gather dominates
  the per-iteration cost, and candidates from the 27-voxel
  neighborhood of the prior pose stay valid while pose corrections are
  below a voxel size, so the Gauss-Newton inner loop only re-ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.ops.eig3 import eigh3x3
from lidar_feature_extraction_tpu.ops.smallalg import solve3x3_sym
from lidar_feature_extraction_tpu.ops import voxel_grid as vg
from lidar_feature_extraction_tpu.ops import voxel_map as vh
from lidar_feature_extraction_tpu.core.precision import highest_precision


class ResidualBlock(NamedTuple):
    """Fixed-shape correspondence set.

    jacobian: [N, D, 7], residual: [N, D], valid: [N] — D=3 for edge,
    D=1 for surface rows.
    """

    jacobian: jnp.ndarray
    residual: jnp.ndarray
    valid: jnp.ndarray


def lookup_knn(map_struct, queries: jnp.ndarray, k: int):
    """kNN against either map structure (static dispatch at trace time)."""
    if isinstance(map_struct, vg.DenseVoxelGrid):
        return vg.knn(map_struct, queries, k)
    return vh.knn(map_struct, queries, k)


@highest_precision
def masked_mean_and_cov(pts: jnp.ndarray, valid: jnp.ndarray):
    """Mean and covariance over valid neighbors, batched [..., K, 3].

    Parity: ``CalcMeanAndCovariance`` (edge.cpp:43-50) — covariance
    normalized by the (valid) count, not count-1.
    """
    w = valid.astype(pts.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=-2), 1.0)
    mean = jnp.sum(pts * w, axis=-2) / cnt
    d = (pts - mean[..., None, :]) * w
    cov = jnp.einsum("...ki,...kj->...ij", d, d) / cnt[..., None]
    return mean, cov


@highest_precision
def edge_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                             pose: Pose, min_neighbors: int
                             ) -> ResidualBlock:
    """Linearize point-to-line residuals given the k neighborhoods."""
    p_map = pose.apply(scan_pts)
    mean, cov = masked_mean_and_cov(nbrs, nvalid)
    _, evecs = eigh3x3(cov)
    principal = evecs[..., :, 2]                       # largest eigenvalue
    p1 = mean - principal
    p2 = mean + principal

    khat = quat.hat(p2 - p1)                           # [N, 3, 3]
    dr = quat.drpdq(jnp.broadcast_to(pose.q, scan_pts.shape[:-1] + (4,)),
                    scan_pts)                          # [N, 3, 4]
    jac = jnp.concatenate([khat @ dr, khat], axis=-1)  # [N, 3, 7]
    res = jnp.cross(p_map - p1, p_map - p2)            # [N, 3]

    ok = scan_valid & (jnp.sum(nvalid, axis=-1) >= min_neighbors)
    okf = ok[..., None]
    return ResidualBlock(jacobian=jnp.where(okf[..., None], jac, 0.0),
                         residual=jnp.where(okf, res, 0.0),
                         valid=ok)


@highest_precision
def fit_plane(nbrs: jnp.ndarray, valid: jnp.ndarray,
              eps: float = 1e-9) -> jnp.ndarray:
    """Least-squares plane X w = -1 over valid neighbors, batched.

    Parity: ``EstimatePlaneCoefficients`` (surface.hpp:79-83) solves the
    overdetermined system with Householder QR; we use the normal
    equations (X^T X) w = -X^T 1 closed-form (smallalg.solve3x3_sym)
    with a Tikhonov floor — the same least-squares solution for
    well-conditioned neighborhoods.
    """
    w = valid.astype(nbrs.dtype)[..., None]
    xw = nbrs * w
    ata = jnp.einsum("...ki,...kj->...ij", xw, nbrs)   # [..., 3, 3]
    atb = -jnp.sum(xw, axis=-2)                        # [..., 3]
    ata = ata + eps * jnp.eye(3, dtype=nbrs.dtype)
    return solve3x3_sym(ata, atb)


@highest_precision
def surface_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                pose: Pose, min_neighbors: int
                                ) -> ResidualBlock:
    """Linearize point-to-plane residuals given the k neighborhoods."""
    p_map = pose.apply(scan_pts)
    w = fit_plane(nbrs, nvalid)                        # [N, 3]
    wnorm = jnp.linalg.norm(w, axis=-1, keepdims=True)
    u = w / jnp.maximum(wnorm, 1e-12)

    dr = quat.drpdq(jnp.broadcast_to(pose.q, scan_pts.shape[:-1] + (4,)),
                    scan_pts)                          # [N, 3, 4]
    ju = jnp.einsum("...i,...ij->...j", u, dr)         # [N, 4]
    jac = jnp.concatenate([ju, u], axis=-1)[..., None, :]  # [N, 1, 7]
    res = ((jnp.sum(w * p_map, axis=-1, keepdims=True) + 1.0)
           / jnp.maximum(wnorm, 1e-12))                # [N, 1]

    ok = scan_valid & (jnp.sum(nvalid, axis=-1) >= min_neighbors)
    okf = ok[..., None]
    return ResidualBlock(jacobian=jnp.where(okf[..., None], jac, 0.0),
                         residual=jnp.where(okf, res, 0.0),
                         valid=ok)


# --- fitted-geometry paths (fit once per search round) ---

class EdgeGeometry(NamedTuple):
    """Pose-independent per-correspondence line geometry.

    The reference refits the neighborhood PCA every Gauss-Newton
    iteration (``Edge::Make``, edge.hpp:83-126), but the fitted line is
    a function of the *map neighbors* only — with cached candidate sets
    (one gather per search round) the selected neighbors move only when
    the pose leaves the candidate neighborhood, which triggers a round
    refresh anyway. Fitting once per round makes each GN iteration pure
    elementwise work + the normal-equation matmuls.
    """

    p1: jnp.ndarray     # [N, 3] virtual line point mean - principal
    p2: jnp.ndarray     # [N, 3] virtual line point mean + principal
    khat: jnp.ndarray   # [N, 3, 3] Hat(p2 - p1)
    valid: jnp.ndarray  # [N]


class SurfaceGeometry(NamedTuple):
    """Pose-independent per-correspondence plane geometry (w: X w = -1)."""

    w: jnp.ndarray      # [N, 3] plane coefficients
    u: jnp.ndarray      # [N, 3] unit normal w/|w|
    wnorm: jnp.ndarray  # [N, 1]
    valid: jnp.ndarray  # [N]


def fit_edge_geometry(cand, cand_ok, scan_pts, scan_valid, pose: Pose,
                      k: int, min_neighbors: int = 5) -> EdgeGeometry:
    """Select k nearest candidates at the round pose and fit the lines."""
    p_map = pose.apply(scan_pts)
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok, p_map, k)
    mean, cov = masked_mean_and_cov(nbrs, nvalid)
    _, evecs = eigh3x3(cov)
    principal = evecs[..., :, 2]
    p1 = mean - principal
    p2 = mean + principal
    ok = scan_valid & (jnp.sum(nvalid, axis=-1) >= min_neighbors)
    return EdgeGeometry(p1=p1, p2=p2, khat=quat.hat(p2 - p1), valid=ok)


def fit_surface_geometry(cand, cand_ok, scan_pts, scan_valid, pose: Pose,
                         k: int, min_neighbors: int = 5) -> SurfaceGeometry:
    """Select k nearest candidates at the round pose and fit the planes."""
    p_map = pose.apply(scan_pts)
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok, p_map, k)
    w = fit_plane(nbrs, nvalid)
    wnorm = jnp.linalg.norm(w, axis=-1, keepdims=True)
    u = w / jnp.maximum(wnorm, 1e-12)
    ok = scan_valid & (jnp.sum(nvalid, axis=-1) >= min_neighbors)
    return SurfaceGeometry(w=w, u=u, wnorm=wnorm, valid=ok)


@highest_precision
def edge_rows_from_geometry(geom: EdgeGeometry, scan_pts,
                            pose: Pose) -> ResidualBlock:
    """Pose-dependent half of the edge linearization (inner GN loop)."""
    p_map = pose.apply(scan_pts)
    dr = quat.drpdq(jnp.broadcast_to(pose.q, scan_pts.shape[:-1] + (4,)),
                    scan_pts)                              # [N, 3, 4]
    jac = jnp.concatenate([geom.khat @ dr, geom.khat], axis=-1)
    res = jnp.cross(p_map - geom.p1, p_map - geom.p2)
    okf = geom.valid[..., None]
    return ResidualBlock(jacobian=jnp.where(okf[..., None], jac, 0.0),
                         residual=jnp.where(okf, res, 0.0),
                         valid=geom.valid)


@highest_precision
def surface_rows_from_geometry(geom: SurfaceGeometry, scan_pts,
                               pose: Pose) -> ResidualBlock:
    """Pose-dependent half of the surface linearization (inner GN loop)."""
    p_map = pose.apply(scan_pts)
    dr = quat.drpdq(jnp.broadcast_to(pose.q, scan_pts.shape[:-1] + (4,)),
                    scan_pts)                              # [N, 3, 4]
    ju = jnp.einsum("...i,...ij->...j", geom.u, dr)        # [N, 4]
    jac = jnp.concatenate([ju, geom.u], axis=-1)[..., None, :]
    res = ((jnp.sum(geom.w * p_map, axis=-1, keepdims=True) + 1.0)
           / jnp.maximum(geom.wnorm, 1e-12))
    okf = geom.valid[..., None]
    return ResidualBlock(jacobian=jnp.where(okf[..., None], jac, 0.0),
                         residual=jnp.where(okf, res, 0.0),
                         valid=geom.valid)


# --- full-search paths ---

def edge_residuals(edge_map, scan_pts, scan_valid, pose: Pose, k: int,
                   min_neighbors: int = 5) -> ResidualBlock:
    nbrs, _, nvalid = lookup_knn(edge_map, pose.apply(scan_pts), k)
    return edge_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                    pose, min_neighbors)


def surface_residuals(surface_map, scan_pts, scan_valid, pose: Pose,
                      k: int, min_neighbors: int = 5) -> ResidualBlock:
    nbrs, _, nvalid = lookup_knn(surface_map, pose.apply(scan_pts), k)
    return surface_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                       pose, min_neighbors)


# --- cached-candidate paths ---

def edge_residuals_from_candidates(cand, cand_ok, scan_pts, scan_valid,
                                   pose: Pose, k: int,
                                   min_neighbors: int = 5) -> ResidualBlock:
    p_map = pose.apply(scan_pts)
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok, p_map, k)
    return edge_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                    pose, min_neighbors)


def surface_residuals_from_candidates(cand, cand_ok, scan_pts, scan_valid,
                                      pose: Pose, k: int,
                                      min_neighbors: int = 5
                                      ) -> ResidualBlock:
    p_map = pose.apply(scan_pts)
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok, p_map, k)
    return surface_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                       pose, min_neighbors)
