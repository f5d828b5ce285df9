"""Precomputed per-voxel correspondence geometry: build-time line/plane
fits over 3x3x3 voxel neighborhoods.

The reference refits the neighborhood geometry per scan point per
Gauss-Newton iteration: k-NN in the map, then PCA for edges
(``Edge::Make``, ``localization/include/lidar_feature_localization/
edge.hpp:78-126``) or a least-squares plane for surfaces
(``Surface::Make``, ``surface.hpp:96-143``). The cost of that
formulation is the candidate *gather* of the 27-voxel point sets plus
top-k and per-point fits, every iteration.

This module moves the entire neighborhood fit to **map build time**,
VGICP/NDT-style: the fitted line/plane is a function of the map points
only, and map points near a query are exactly the points in the 3x3x3
voxel neighborhood of the query's voxel. So:

1. scatter point moments (count, sum, second moment) into the voxel
   grid — one scatter-add of a [N, 10] feature row per point;
2. aggregate 3x3x3 neighborhoods as a **separable box filter** over the
   dense [nx, ny, nz, 10] moment grid (three shifted-add passes, pure
   VPU work, no gathers). Moments are kept in voxel-center-local
   coordinates for f32 accuracy and translated between frames with the
   parallel-axis rule when shifted;
3. fit every voxel's line (PCA principal axis) / plane (centered normal)
   in one batched closed-form pass (ops/eig3.eigh3x3).

At registration time a scan point needs ONE 8-float gather (its voxel's
geometry record) per Gauss-Newton iteration — re-searching every
iteration like the reference's KD-tree loop, at ~1/40 the cost of the
cached-candidate scheme this replaces.

Deviations from the reference (acceptance: ATE parity, BASELINE.md):
- neighborhoods are voxel-centric (all points in the 3x3x3 cells of the
  query's voxel) instead of query-centric k=15 nearest;
- the surface plane is the orthogonal-regression plane through the
  neighborhood centroid (smallest covariance eigenvector) instead of
  the ``X w = -1`` least-squares fit (``surface.hpp:79-83``); residual
  and Jacobian keep the same signed point-plane-distance form.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.core import quaternion as quat
from lidar_feature_extraction_tpu.core.pose import Pose
from lidar_feature_extraction_tpu.ops.eig3 import eigh3x3
from lidar_feature_extraction_tpu.ops.voxel_grid import (
    _cell_of, _ravel, grid_for_bounds)  # noqa: F401 (re-export)
from lidar_feature_extraction_tpu.core.precision import highest_precision


class GeometryGrid(NamedTuple):
    """Dense per-voxel geometry records.

    rec: [C + 1, 8] with C = nx*ny*nz (+1 zero dump row for
    out-of-bounds queries). Edge grids store (m(3), v(3), count, 0):
    line through m with unit direction v, virtual points m -/+ v.
    Surface grids store (u(3), b, count, 0, 0, 0): plane u . x = b with
    unit normal u. count <= min_points marks the record invalid.
    """

    rec: jnp.ndarray
    voxel_size: jnp.ndarray
    origin: jnp.ndarray
    dims: tuple[int, int, int]

    @property
    def capacity(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def _point_moments(y: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] local coords -> [..., 10] moment rows
    (1, y, y y^T upper triangle: xx xy xz yy yz zz)."""
    x0, x1, x2 = y[..., 0], y[..., 1], y[..., 2]
    return jnp.stack([jnp.ones_like(x0), x0, x1, x2,
                      x0 * x0, x0 * x1, x0 * x2,
                      x1 * x1, x1 * x2, x2 * x2], axis=-1)


def _translate_moments(m: jnp.ndarray, o: jnp.ndarray) -> jnp.ndarray:
    """Parallel-axis translation: moments of (y + o) from moments of y.

    n' = n;  s' = s + n o;  S'_ij = S_ij + s_i o_j + o_i s_j + n o_i o_j.
    ``o`` broadcasts against m[..., :]'s batch shape with a trailing [3].
    """
    n = m[..., 0:1]
    s = m[..., 1:4]
    o = jnp.broadcast_to(o, s.shape)
    s_new = s + n * o
    sxx = m[..., 4] + 2 * s[..., 0] * o[..., 0] + n[..., 0] * o[..., 0] ** 2
    sxy = (m[..., 5] + s[..., 0] * o[..., 1] + s[..., 1] * o[..., 0]
           + n[..., 0] * o[..., 0] * o[..., 1])
    sxz = (m[..., 6] + s[..., 0] * o[..., 2] + s[..., 2] * o[..., 0]
           + n[..., 0] * o[..., 0] * o[..., 2])
    syy = m[..., 7] + 2 * s[..., 1] * o[..., 1] + n[..., 0] * o[..., 1] ** 2
    syz = (m[..., 8] + s[..., 1] * o[..., 2] + s[..., 2] * o[..., 1]
           + n[..., 0] * o[..., 1] * o[..., 2])
    szz = m[..., 9] + 2 * s[..., 2] * o[..., 2] + n[..., 0] * o[..., 2] ** 2
    return jnp.concatenate([n, s_new,
                            jnp.stack([sxx, sxy, sxz, syy, syz, szz],
                                      axis=-1)], axis=-1)


def voxel_moments(xyz: jnp.ndarray, mask: jnp.ndarray, voxel_size,
                  origin, dims: tuple[int, int, int],
                  weight: jnp.ndarray | None = None) -> jnp.ndarray:
    """Scatter masked points into per-voxel local moments [C, 10].

    Local = relative to the owning voxel's center, so the second moments
    stay O(voxel_size^2) and f32-exact regardless of map extent.
    ``weight`` scales each point's moment row; weight -1 REMOVES a
    previously inserted point (moments are additive — the basis of the
    incremental odometry map, pipeline/odometry.py).
    """
    dtype = xyz.dtype
    origin = jnp.asarray(origin, dtype)
    voxel_size = jnp.asarray(voxel_size, dtype)
    capacity = dims[0] * dims[1] * dims[2]

    c = _cell_of(xyz, voxel_size, origin)
    cell = _ravel(c, dims)
    cell = jnp.where(mask, cell, capacity)
    center = origin + (c.astype(dtype) + 0.5) * voxel_size
    feats = _point_moments(xyz - center)
    feats = jnp.where(mask[:, None], feats, 0.0)
    if weight is not None:
        feats = feats * weight[:, None].astype(dtype)

    # On a GPU this scatter-add runs as atomics: the sums can differ in
    # the last bits from run to run and from the CPU.
    m = jnp.zeros((capacity + 1, 10), dtype)
    m = m.at[cell].add(feats, mode="drop")
    return m[:capacity]


def recenter_moments(m: jnp.ndarray, dims: tuple[int, int, int],
                     voxel_size, origin, target_center):
    """Roll a dense moment grid so its center tracks ``target_center``.

    The odometry map must follow the vehicle; instead of rebuilding,
    the grid is shifted by an integer number of voxels (``jnp.roll``)
    and the bands that wrapped around (newly entered space) are
    zeroed. Per-voxel LOCAL moment frames ride along unchanged: the
    origin moves by exactly the roll distance, so every surviving
    voxel keeps its absolute center. Returns (m, new_origin)."""
    dtype = m.dtype
    nx, ny, nz = dims
    h = jnp.asarray(voxel_size, dtype)
    origin = jnp.asarray(origin, dtype)
    half = jnp.asarray(dims, dtype) * h / 2.0
    desired = jnp.asarray(target_center, dtype) - half
    shift = jnp.round((desired - origin) / h).astype(jnp.int32)   # [3]

    g = m.reshape(nx, ny, nz, 10)
    g = jnp.roll(g, shift=(-shift[0], -shift[1], -shift[2]),
                 axis=(0, 1, 2))
    for axis, n_a in enumerate((nx, ny, nz)):
        idx = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, nz), axis)
        s = shift[axis]
        keep = jnp.where(s >= 0, idx < n_a - s, idx >= -s)
        g = jnp.where(keep[..., None], g, 0.0)
    return g.reshape(-1, 10), origin + shift.astype(dtype) * h


def neighborhood_moments(m: jnp.ndarray, dims: tuple[int, int, int],
                         voxel_size) -> jnp.ndarray:
    """3x3x3 box-sum of per-voxel local moments, [C, 10] -> [C, 10].

    Separable: one shifted-add pass per axis. A neighbor one step UP the
    axis (index i+1) holds moments local to a center +h away, so its
    contribution to voxel i is translated by +h e_a; the i-1 neighbor
    by -h e_a.
    """
    nx, ny, nz = dims
    g = m.reshape(nx, ny, nz, 10)
    h = jnp.asarray(voxel_size, m.dtype)

    def shift(a, axis, direction):
        """Zero-padded shift pulling the neighbor at index+direction."""
        pad = [(0, 0)] * a.ndim
        if direction > 0:
            pad[axis] = (0, 1)
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(1, None)
        else:
            pad[axis] = (1, 0)
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(0, a.shape[axis])
        return jnp.pad(a, pad)[tuple(sl)]

    for axis in range(3):
        e = jnp.zeros(3, m.dtype).at[axis].set(h)
        g = (g
             + _translate_moments(shift(g, axis, +1), e)
             + _translate_moments(shift(g, axis, -1), -e))
    return g.reshape(-1, 10)


def _voxel_centers(dims: tuple[int, int, int], voxel_size, origin,
                   dtype) -> jnp.ndarray:
    nx, ny, nz = dims
    idx = jnp.arange(nx * ny * nz)
    cx = idx // (ny * nz)
    cy = (idx // nz) % ny
    cz = idx % nz
    c = jnp.stack([cx, cy, cz], axis=-1).astype(dtype)
    return jnp.asarray(origin, dtype) + (c + 0.5) * jnp.asarray(
        voxel_size, dtype)


def _mean_cov(m: jnp.ndarray):
    """Neighborhood mean/covariance from local moments [..., 10].

    Covariance normalized by count, matching ``CalcMeanAndCovariance``
    (``localization/src/edge.cpp:43-50``).
    """
    n = jnp.maximum(m[..., 0], 1.0)
    mu = m[..., 1:4] / n[..., None]
    s2 = jnp.stack([
        jnp.stack([m[..., 4], m[..., 5], m[..., 6]], axis=-1),
        jnp.stack([m[..., 5], m[..., 7], m[..., 8]], axis=-1),
        jnp.stack([m[..., 6], m[..., 8], m[..., 9]], axis=-1),
    ], axis=-2)
    cov = s2 / n[..., None, None] - mu[..., :, None] * mu[..., None, :]
    return m[..., 0], mu, cov


def edge_records_from_moments(m: jnp.ndarray, dims, voxel_size,
                              origin) -> jnp.ndarray:
    """Raw per-voxel moments [C, 10] -> edge records [C + 1, 8].

    Record: line point m (neighborhood mean, world frame), unit
    principal axis v — the virtual points of ``Edge::Make``
    (edge.hpp:111-116) are m - v and m + v.
    """
    dtype = m.dtype
    nb = neighborhood_moments(m, dims, voxel_size)
    n, mu, cov = _mean_cov(nb)
    _, evecs = eigh3x3(cov)
    v = evecs[..., :, 2]                        # largest eigenvalue axis
    centers = _voxel_centers(dims, voxel_size, origin, dtype)
    rec = jnp.concatenate([centers + mu, v, n[:, None],
                           jnp.zeros_like(n[:, None])], axis=-1)
    return jnp.concatenate([rec, jnp.zeros((1, 8), dtype)], axis=0)


def surface_records_from_moments(m: jnp.ndarray, dims, voxel_size,
                                 origin) -> jnp.ndarray:
    """Raw per-voxel moments [C, 10] -> surface records [C + 1, 8].

    Record: unit normal u (smallest covariance eigenvector) and offset
    b = u . p0 through the neighborhood centroid p0. Signed distance of
    a point x is u . x - b — the same residual geometry as
    ``SignedPointPlaneDistance`` (surface.hpp:49-57).
    """
    dtype = m.dtype
    nb = neighborhood_moments(m, dims, voxel_size)
    n, mu, cov = _mean_cov(nb)
    _, evecs = eigh3x3(cov)
    u = evecs[..., :, 0]                        # smallest eigenvalue axis
    centers = _voxel_centers(dims, voxel_size, origin, dtype)
    p0 = centers + mu
    b = jnp.sum(u * p0, axis=-1, keepdims=True)
    rec = jnp.concatenate([u, b, n[:, None],
                           jnp.zeros((u.shape[0], 3), dtype)], axis=-1)
    return jnp.concatenate([rec, jnp.zeros((1, 8), dtype)], axis=0)


@partial(jax.jit, static_argnames=("dims",))
def build_edge_geometry_grid(xyz, mask, voxel_size, origin,
                             dims: tuple[int, int, int]) -> GeometryGrid:
    """Fit the neighborhood PCA line of every voxel (batched)."""
    dtype = xyz.dtype
    m = voxel_moments(xyz, mask, voxel_size, origin, dims)
    rec = edge_records_from_moments(m, dims, voxel_size, origin)
    return GeometryGrid(rec=rec,
                        voxel_size=jnp.asarray(voxel_size, dtype),
                        origin=jnp.asarray(origin, dtype), dims=dims)


@partial(jax.jit, static_argnames=("dims",))
def build_surface_geometry_grid(xyz, mask, voxel_size, origin,
                                dims: tuple[int, int, int]) -> GeometryGrid:
    """Fit the neighborhood plane of every voxel (batched)."""
    dtype = xyz.dtype
    m = voxel_moments(xyz, mask, voxel_size, origin, dims)
    rec = surface_records_from_moments(m, dims, voxel_size, origin)
    return GeometryGrid(rec=rec,
                        voxel_size=jnp.asarray(voxel_size, dtype),
                        origin=jnp.asarray(origin, dtype), dims=dims)


def gather_records(grid: GeometryGrid, queries: jnp.ndarray):
    """[Q, 3] world points -> ([Q, 8] records, [Q] in-grid mask)."""
    cells = _ravel(_cell_of(queries, grid.voxel_size, grid.origin),
                   grid.dims)
    return grid.rec[cells], cells < grid.capacity


def fuse_record_tables(edge: GeometryGrid,
                       surface: GeometryGrid) -> jnp.ndarray:
    """Concatenate the two record tables into one [Ce + Cs + 1, 8] array
    (edge rows, surface rows, shared zero dump row) so registration can
    gather edge AND surface records in a single irregular op per
    iteration — on this hardware every gather launch costs ~0.3 ms
    regardless of row count, so one fused gather halves the per-
    iteration correspondence cost (docs/design.md §7)."""
    return jnp.concatenate([edge.rec[:-1], surface.rec], axis=0)


@highest_precision
def fused_rows_from_grids(edge_grid: GeometryGrid,
                          surf_grid: GeometryGrid,
                          fused_rec: jnp.ndarray,
                          edge_pts, edge_valid, surf_pts, surf_valid,
                          pose: Pose, min_points: int):
    """Edge + surface residual rows with ONE record gather.

    Identical math to ``edge_rows_from_grid`` + ``surface_rows_from_grid``
    (the per-iteration re-search of Edge::Make / Surface::Make against
    precomputed per-voxel geometry); the only difference is that the two
    record lookups ride a single concatenated-index gather against
    ``fuse_record_tables`` output.
    """
    from lidar_feature_extraction_tpu.ops.residuals import ResidualBlock

    ce_cap = edge_grid.capacity
    cs_cap = surf_grid.capacity
    dump = ce_cap + cs_cap

    pe = pose.apply(edge_pts)
    ps = pose.apply(surf_pts)
    cells_e = _ravel(_cell_of(pe, edge_grid.voxel_size, edge_grid.origin),
                     edge_grid.dims)
    cells_s = _ravel(_cell_of(ps, surf_grid.voxel_size, surf_grid.origin),
                     surf_grid.dims)
    in_e = cells_e < ce_cap
    in_s = cells_s < cs_cap
    idx = jnp.concatenate([jnp.where(in_e, cells_e, dump),
                           ce_cap + cells_s], axis=0)
    rec = fused_rec[idx]
    qe = edge_pts.shape[0]
    rec_e, rec_s = rec[:qe], rec[qe:]

    # Edge rows: residual (p - p1) x (p - p2), Jacobian
    # [Hat(p2 - p1) DRpDq | Hat(p2 - p1)] (edge.cpp:66-88).
    m, v, cnt_e = rec_e[..., 0:3], rec_e[..., 3:6], rec_e[..., 6]
    p1, p2 = m - v, m + v
    khat = quat.hat(p2 - p1)
    dr_e = quat.drpdq(jnp.broadcast_to(pose.q, edge_pts.shape[:-1] + (4,)),
                      edge_pts)
    jac_e = jnp.concatenate([khat @ dr_e, khat], axis=-1)
    res_e = jnp.cross(pe - p1, pe - p2)
    ok_e = edge_valid & in_e & (cnt_e >= min_points)
    oef = ok_e[..., None]
    eb = ResidualBlock(jacobian=jnp.where(oef[..., None], jac_e, 0.0),
                       residual=jnp.where(oef, res_e, 0.0), valid=ok_e)

    # Surface rows: residual u . p - b, Jacobian [u^T DRpDq | u^T]
    # (surface.hpp:85-93).
    u, b, cnt_s = rec_s[..., 0:3], rec_s[..., 3], rec_s[..., 4]
    dr_s = quat.drpdq(jnp.broadcast_to(pose.q, surf_pts.shape[:-1] + (4,)),
                      surf_pts)
    ju = jnp.einsum("...i,...ij->...j", u, dr_s)
    jac_s = jnp.concatenate([ju, u], axis=-1)[..., None, :]
    res_s = (jnp.sum(u * ps, axis=-1) - b)[..., None]
    ok_s = surf_valid & in_s & (cnt_s >= min_points)
    osf = ok_s[..., None]
    sb = ResidualBlock(jacobian=jnp.where(osf[..., None], jac_s, 0.0),
                       residual=jnp.where(osf, res_s, 0.0), valid=ok_s)
    return eb, sb


@highest_precision
def edge_rows_from_grid(grid: GeometryGrid, scan_pts, scan_valid,
                        pose: Pose, min_points: int):
    """Point-to-line residual rows with per-iteration grid re-search.

    Same linearization as ``edge_rows_from_geometry`` (residuals.py):
    residual (p - p1) x (p - p2), Jacobian [Hat(p2 - p1) DRpDq | Hat].
    Returns a ResidualBlock-compatible (jacobian, residual, valid).
    """
    from lidar_feature_extraction_tpu.ops.residuals import ResidualBlock

    p_map = pose.apply(scan_pts)
    rec, in_grid = gather_records(grid, p_map)
    m, v, cnt = rec[..., 0:3], rec[..., 3:6], rec[..., 6]
    p1 = m - v
    p2 = m + v
    khat = quat.hat(p2 - p1)
    dr = quat.drpdq(jnp.broadcast_to(pose.q, scan_pts.shape[:-1] + (4,)),
                    scan_pts)
    jac = jnp.concatenate([khat @ dr, khat], axis=-1)
    res = jnp.cross(p_map - p1, p_map - p2)
    ok = scan_valid & in_grid & (cnt >= min_points)
    okf = ok[..., None]
    return ResidualBlock(jacobian=jnp.where(okf[..., None], jac, 0.0),
                         residual=jnp.where(okf, res, 0.0),
                         valid=ok)


@highest_precision
def surface_rows_from_grid(grid: GeometryGrid, scan_pts, scan_valid,
                           pose: Pose, min_points: int):
    """Point-to-plane residual rows with per-iteration grid re-search.

    Residual u . p - b (signed plane distance), Jacobian
    [u^T DRpDq | u^T] — the form of ``MakeJacobianRow``
    (surface.hpp:85-93)."""
    from lidar_feature_extraction_tpu.ops.residuals import ResidualBlock

    p_map = pose.apply(scan_pts)
    rec, in_grid = gather_records(grid, p_map)
    u, b, cnt = rec[..., 0:3], rec[..., 3], rec[..., 4]
    dr = quat.drpdq(jnp.broadcast_to(pose.q, scan_pts.shape[:-1] + (4,)),
                    scan_pts)
    ju = jnp.einsum("...i,...ij->...j", u, dr)
    jac = jnp.concatenate([ju, u], axis=-1)[..., None, :]
    res = (jnp.sum(u * p_map, axis=-1) - b)[..., None]
    ok = scan_valid & in_grid & (cnt >= min_points)
    okf = ok[..., None]
    return ResidualBlock(jacobian=jnp.where(okf[..., None], jac, 0.0),
                         residual=jnp.where(okf, res, 0.0),
                         valid=ok)
