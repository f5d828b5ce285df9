"""Dense direct-addressed voxel grid: the fast-path correspondence
structure for bounded maps.

The open-addressed hash lookup (ops/voxel_map.py) is dominated by its
probe loop: up to 16 rounds of [Q, 27] gathers against one for the
distance+top-k math. For maps with known bounds (any localization submap; KITTI-scale
with re-centering) direct addressing removes hashing entirely: bucket
index = ravel(clip(floor((p - origin)/voxel) - grid_min)), one integer
expression, then a single points gather. Build is one rank-scatter —
no claim rounds.

The hash map remains for unbounded/sparse worlds; both expose the same
(neighbors, sq_dists, valid) kNN contract, so residual factories accept
either.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class DenseVoxelGrid(NamedTuple):
    """points: [C, S, 3] slot storage with C = nx*ny*nz (+1 dump row at
    index C), n_pts: [C] occupancy, dims: static via shape metadata."""

    points: jnp.ndarray
    n_pts: jnp.ndarray
    voxel_size: jnp.ndarray
    origin: jnp.ndarray      # [3] world position of grid cell (0,0,0)
    dims: tuple[int, int, int]

    @property
    def capacity(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def _cell_of(xyz, voxel_size, origin):
    return jnp.floor((xyz - origin) / voxel_size).astype(jnp.int32)


def _ravel(c, dims):
    nx, ny, nz = dims
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    inside = ((x >= 0) & (x < nx) & (y >= 0) & (y < ny)
              & (z >= 0) & (z < nz))
    idx = (x * ny + y) * nz + z
    return jnp.where(inside, idx, nx * ny * nz)  # out-of-bounds -> dump


@partial(jax.jit, static_argnames=("dims", "slots"))
def build_voxel_grid(xyz: jnp.ndarray, mask: jnp.ndarray, voxel_size,
                     origin, dims: tuple[int, int, int],
                     slots: int) -> DenseVoxelGrid:
    """Insert masked points [N, 3]; first ``slots`` points per cell in
    key-sorted order are kept (voxel-downsample maps before insertion to
    avoid slot starvation)."""
    n = xyz.shape[0]
    dtype = xyz.dtype
    origin = jnp.asarray(origin, dtype)
    capacity = dims[0] * dims[1] * dims[2]

    cell = _ravel(_cell_of(xyz, voxel_size, origin), dims)
    cell = jnp.where(mask, cell, capacity)

    order = jnp.argsort(cell)
    scell = cell[order]
    sxyz = xyz[order]
    first = jnp.concatenate([jnp.ones(1, bool), scell[1:] != scell[:-1]])
    idx = jnp.arange(n)
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(first, idx, 0))
    rank = idx - seg_start

    ok = (scell < capacity) & (rank < slots)
    rows = jnp.where(ok, scell, capacity)
    cols = jnp.where(ok, jnp.minimum(rank, slots - 1), 0)
    points = jnp.zeros((capacity + 1, slots, 3), dtype)
    points = points.at[rows, cols].set(
        jnp.where(ok[:, None], sxyz, 0.0), mode="drop")
    n_pts = jnp.zeros(capacity + 1, jnp.int32)
    n_pts = n_pts.at[rows].add(ok.astype(jnp.int32), mode="drop")

    return DenseVoxelGrid(points=points,
                          n_pts=jnp.minimum(n_pts, slots),
                          voxel_size=jnp.asarray(voxel_size, dtype),
                          origin=origin, dims=dims)


def grid_for_bounds(lo, hi, voxel_size, margin_voxels: int = 2):
    """(origin, dims) covering the AABB [lo, hi] plus a margin.

    The origin snaps to the global voxel lattice (multiples of
    ``voxel_size``) so cell boundaries are identical to the hash map's
    ``floor(p / voxel_size)`` partition — kNN results match across the
    two structures."""
    import numpy as np

    lo = (np.floor(np.asarray(lo, np.float64) / voxel_size)
          - margin_voxels) * voxel_size
    hi = np.asarray(hi, np.float64) + margin_voxels * voxel_size
    dims = tuple(int(d) for d in
                 np.maximum(np.ceil((hi - lo) / voxel_size), 1).astype(int))
    return lo.astype(np.float32), dims


def neighborhood_candidates(grid: DenseVoxelGrid, queries: jnp.ndarray):
    """Gather the 27-voxel candidate sets around each query.

    Returns (cand [Q, 27*S, 3], cand_ok [Q, 27*S]) — the reusable
    retrieval half of kNN (cache it across Gauss-Newton iterations; the
    selection half is ``topk_from_candidates``)."""
    slots = grid.points.shape[1]
    qc = _cell_of(queries, grid.voxel_size, grid.origin)  # [Q, 3]
    offs = jnp.stack(jnp.meshgrid(jnp.arange(-1, 2), jnp.arange(-1, 2),
                                  jnp.arange(-1, 2),
                                  indexing="ij"), -1).reshape(27, 3)
    cells = _ravel(qc[:, None, :] + offs[None, :, :], grid.dims)  # [Q,27]
    cand = grid.points[cells]                        # [Q, 27, S, 3]
    cnt = grid.n_pts[cells]                          # [Q, 27]
    slot_idx = jnp.arange(slots)[None, None, :]
    ok = (cells[..., None] < grid.capacity) & (slot_idx < cnt[..., None])
    q = queries.shape[0]
    return cand.reshape(q, 27 * slots, 3), ok.reshape(q, 27 * slots)


def topk_from_candidates(cand, cand_ok, queries, k: int):
    """Select k nearest candidates; same contract as voxel_map.knn."""
    d = cand - queries[:, None, :]
    sq = jnp.sum(d * d, axis=-1)
    sq = jnp.where(cand_ok, sq, jnp.inf)
    neg_top, top_idx = jax.lax.top_k(-sq, k)
    sq_k = -neg_top
    nbrs = jnp.take_along_axis(cand, top_idx[..., None], axis=1)
    valid = jnp.isfinite(sq_k)
    nbrs = jnp.where(valid[..., None], nbrs, 0.0)
    return nbrs, sq_k, valid


@partial(jax.jit, static_argnames=("k",))
def knn(grid: DenseVoxelGrid, queries: jnp.ndarray, k: int):
    cand, ok = neighborhood_candidates(grid, queries)
    return topk_from_candidates(cand, ok, queries, k)
