"""Voxel-grid centroid downsampling with fixed-capacity output.

Replaces ``Downsample`` / ``pcl::VoxelGrid`` (``lib/include/
lidar_feature_library/downsample.hpp:38-49``): points are bucketed by
voxel and each occupied voxel emits its centroid. Sort + segmented
reduction, one pass, fixed output shape.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lidar_feature_extraction_tpu.ops.voxel_map import _pack_coords, _EMPTY


@partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample(xyz: jnp.ndarray, mask: jnp.ndarray, voxel_size,
                     capacity: int):
    """Centroid per occupied voxel of the masked points.

    Returns (points [capacity, 3], valid [capacity]). Output order is
    packed-key order (deterministic). Voxels beyond ``capacity`` are
    dropped (log-worthy but silent on device; size capacity generously).
    """
    dtype = xyz.dtype
    origin = jnp.zeros(3, dtype)
    key = jnp.where(mask, _pack_coords(xyz, voxel_size, origin), _EMPTY)
    order = jnp.argsort(key)
    skey = key[order]
    sxyz = xyz[order]
    valid = skey != _EMPTY

    first = jnp.concatenate([jnp.ones(1, bool), skey[1:] != skey[:-1]])
    first = first & valid
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1          # [N]
    seg = jnp.where(valid & (seg >= 0), seg, capacity)
    seg_c = jnp.minimum(seg, capacity)

    # On a GPU these scatter-adds run as atomics: the sums can differ in
    # the last bits from run to run and from the CPU.
    sums = jnp.zeros((capacity + 1, 3), dtype)
    sums = sums.at[seg_c].add(jnp.where(valid[:, None], sxyz, 0.0),
                              mode="drop")
    cnts = jnp.zeros(capacity + 1, dtype)
    cnts = cnts.at[seg_c].add(valid.astype(dtype), mode="drop")

    n_voxels = jnp.sum(first.astype(jnp.int32))
    out_valid = jnp.arange(capacity) < jnp.minimum(n_voxels, capacity)
    pts = sums[:capacity] / jnp.maximum(cnts[:capacity, None], 1.0)
    return jnp.where(out_valid[:, None], pts, 0.0), out_valid


@partial(jax.jit, static_argnames=("capacity", "grid_dims"))
def voxel_downsample_dense(xyz: jnp.ndarray, mask: jnp.ndarray,
                           voxel_size, capacity: int,
                           grid_dims: tuple[int, int, int]):
    """Sort-free centroid downsample over a dense scan-local grid.

    Same contract and centroid math as ``voxel_downsample`` (parity:
    ``pcl::VoxelGrid`` via downsample.hpp:38-49) but the segmented
    reduction runs as a scatter-add into a fixed-dims grid anchored at
    the scan's voxel minimum instead of an argsort. ``grid_dims`` bounds the scan extent in
    voxels (points outside are dropped, like capacity overflow). Output
    is raveled-cell order — lexicographic in (x, y, z) cell coords,
    matching the packed-key order of the sort-based variant.
    """
    dtype = xyz.dtype
    nx, ny, nz = grid_dims
    cells_cap = nx * ny * nz

    c = jnp.floor(xyz / jnp.asarray(voxel_size, dtype)).astype(jnp.int32)
    big = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
    cmin = jnp.min(jnp.where(mask[:, None], c, big), axis=0)
    c = c - cmin
    inside = (mask & (c[..., 0] >= 0) & (c[..., 0] < nx)
              & (c[..., 1] >= 0) & (c[..., 1] < ny)
              & (c[..., 2] >= 0) & (c[..., 2] < nz))
    cell = (c[..., 0] * ny + c[..., 1]) * nz + c[..., 2]
    cell = jnp.where(inside, cell, cells_cap)

    # Atomic on a GPU, as in voxel_downsample.
    sums = jnp.zeros((cells_cap + 1, 3), dtype)
    sums = sums.at[cell].add(jnp.where(inside[:, None], xyz, 0.0),
                             mode="drop")
    cnts = jnp.zeros(cells_cap + 1, dtype)
    cnts = cnts.at[cell].add(inside.astype(dtype), mode="drop")

    occupied = cnts[:cells_cap] > 0
    (sel,) = jnp.nonzero(occupied, size=capacity, fill_value=cells_cap)
    out_valid = sel < cells_cap
    sel_c = jnp.minimum(sel, cells_cap - 1)
    pts = sums[sel_c] / jnp.maximum(cnts[sel_c, None], 1.0)
    return jnp.where(out_valid[:, None], pts, 0.0), out_valid
