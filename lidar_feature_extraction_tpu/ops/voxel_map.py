"""Device-resident voxel-hash point map with 3x3x3-neighborhood k-NN.

Array-native replacement for the reference's nanoflann KD-tree
(``localization/include/lidar_feature_localization/kdtree.hpp:56``,
``src/kdtree.cpp:42-63``): tree traversal is irreducibly sequential and
pointer-chasing, so instead map points are hashed into an open-addressed
voxel table once, and k-NN becomes a dense gather + top-k over the 27
voxels around each query — thousands of queries batched onto the VPU.

Acceptance criterion is trajectory (ATE) parity, not neighbor-set parity
(SURVEY.md §7 hard part (c)): the 27-voxel neighborhood bounds the
search radius at ~1.5 voxel sizes, which for k=15 LOAM correspondence
search is the locality the KD-tree exploits anyway.

Coordinates are packed **map-locally** into one int32 key: x, y in
[-1024, 1024) voxels, z in [-256, 256) voxels relative to ``origin``.
With 1 m voxels that is a 2 km x 2 km x 512 m submap volume; larger
worlds re-center the origin per submap (the mapping layer owns that).
Out-of-volume points are dropped at insert and never matched.

The table is built on device with a constant number of scatter rounds
(claim-by-max), so incremental mapping can rebuild/extend maps without
host round-trips.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_XY_BITS = 11  # +/- 1024 voxels
_Z_BITS = 9    # +/- 256 voxels
_XY_HALF = 1 << (_XY_BITS - 1)
_Z_HALF = 1 << (_Z_BITS - 1)
_EMPTY = jnp.int32(0x7FFFFFFF)  # sorts last, never a valid packed key


class VoxelHashMap(NamedTuple):
    """Open-addressed voxel table.

    keys:    [C] int32 packed voxel key; _EMPTY = free bucket.
    points:  [C, S, 3] point slots per bucket (zeros when unused).
    n_pts:   [C] int32 occupied slots per bucket.
    voxel_size: scalar array.
    origin:  [3] map-local frame origin subtracted before voxelization.
    """

    keys: jnp.ndarray
    points: jnp.ndarray
    n_pts: jnp.ndarray
    voxel_size: jnp.ndarray
    origin: jnp.ndarray


def _pack_coords(xyz: jnp.ndarray, voxel_size, origin) -> jnp.ndarray:
    """Points [..., 3] -> int32 packed voxel key; _EMPTY if out of volume."""
    c = jnp.floor((xyz - origin) / voxel_size).astype(jnp.int32)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    inside = ((x >= -_XY_HALF) & (x < _XY_HALF)
              & (y >= -_XY_HALF) & (y < _XY_HALF)
              & (z >= -_Z_HALF) & (z < _Z_HALF))
    key = (((x + _XY_HALF) << (_XY_BITS + _Z_BITS))
           | ((y + _XY_HALF) << _Z_BITS)
           | (z + _Z_HALF))
    return jnp.where(inside, key, _EMPTY)


def _shift_key(key: jnp.ndarray, d: tuple[int, int, int]) -> jnp.ndarray:
    """Packed key of the voxel offset by d (valid keys only)."""
    dx, dy, dz = d
    delta = ((dx << (_XY_BITS + _Z_BITS)) | ((dy & ((1 << _XY_BITS) - 1))
             << _Z_BITS) | (dz & ((1 << _Z_BITS) - 1)))
    # Recompute componentwise to handle borrow/carry correctly.
    x = (key >> (_XY_BITS + _Z_BITS)) + dx
    y = ((key >> _Z_BITS) & ((1 << _XY_BITS) - 1)) + dy
    z = (key & ((1 << _Z_BITS) - 1)) + dz
    inside = ((x >= 0) & (x < 2 * _XY_HALF)
              & (y >= 0) & (y < 2 * _XY_HALF)
              & (z >= 0) & (z < 2 * _Z_HALF) & (key != _EMPTY))
    out = (x << (_XY_BITS + _Z_BITS)) | (y << _Z_BITS) | z
    del delta
    return jnp.where(inside, out, _EMPTY)


def _hash_key(key: jnp.ndarray, capacity: int) -> jnp.ndarray:
    """murmur3-finalizer style avalanche, then mod capacity."""
    h = key.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h % jnp.uint32(capacity)).astype(jnp.int32)


def _find_buckets(table_keys, key, capacity: int, max_probes: int):
    """Linear-probe lookup; -1 where not found. Vector over key shape."""
    home = _hash_key(key, capacity)
    found = jnp.full(key.shape, -1, jnp.int32)

    def body(t, found):
        slot = (home + t) % capacity
        hit = (found == -1) & (table_keys[slot] == key) & (key != _EMPTY)
        return jnp.where(hit, slot, found)

    return jax.lax.fori_loop(0, max_probes, body, found)


@partial(jax.jit, static_argnames=("capacity", "slots", "max_probes"))
def build_voxel_map(xyz: jnp.ndarray, mask: jnp.ndarray, voxel_size,
                    capacity: int, slots: int, max_probes: int = 16,
                    origin=None) -> VoxelHashMap:
    """Insert masked points [N, 3] into a fresh voxel table.

    Bucket assignment runs ``max_probes`` rounds of scatter-max "claims":
    each round, every still-homeless voxel key proposes itself for its
    next probe slot, one proposal wins each free bucket, losers advance
    their cursor. Point slots are then filled with a rank scatter (first
    ``slots`` points per voxel in key-sorted order).
    """
    n = xyz.shape[0]
    dtype = xyz.dtype
    if origin is None:
        origin = jnp.zeros(3, dtype)
    key = jnp.where(mask, _pack_coords(xyz, voxel_size, origin), _EMPTY)

    order = jnp.argsort(key)  # _EMPTY sorts last
    skey = key[order]
    sxyz = xyz[order]
    first = jnp.concatenate([jnp.ones(1, bool), skey[1:] != skey[:-1]])
    first = first & (skey != _EMPTY)
    uniq = jnp.where(first, skey, _EMPTY)

    table_keys = jnp.full((capacity,), _EMPTY)
    probe = jnp.zeros(n, jnp.int32)
    home = _hash_key(uniq, capacity)
    placed = ~first

    def claim_round(state, _):
        table_keys, probe, placed = state
        slot = (home + probe) % capacity
        want = ~placed
        # Propose key+1 via scatter-max so 0 means "no proposal"
        # (valid packed keys are >= 0, so key+1 >= 1).
        proposal = jnp.zeros(capacity, jnp.int32)
        proposal = proposal.at[slot].max(
            jnp.where(want, uniq + 1, 0), mode="drop")
        free = table_keys == _EMPTY
        table_keys = jnp.where(free & (proposal > 0), proposal - 1,
                               table_keys)
        got = want & (table_keys[slot] == uniq)
        placed = placed | got
        probe = jnp.where(want & ~got, probe + 1, probe)
        return (table_keys, probe, placed), None

    (table_keys, probe, placed), _ = jax.lax.scan(
        claim_round, (table_keys, probe, placed), None, length=max_probes)

    bucket = _find_buckets(table_keys, skey, capacity, max_probes)

    idx = jnp.arange(n)
    seg_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(first, idx, 0))
    rank = idx - seg_start

    ok = (skey != _EMPTY) & (bucket >= 0) & (rank < slots)
    rows = jnp.where(ok, bucket, capacity)
    cols = jnp.where(ok, jnp.minimum(rank, slots - 1), 0)
    points = jnp.zeros((capacity + 1, slots, 3), dtype)
    points = points.at[rows, cols].set(
        jnp.where(ok[:, None], sxyz, 0.0), mode="drop")
    n_pts = jnp.zeros(capacity + 1, jnp.int32)
    n_pts = n_pts.at[rows].add(ok.astype(jnp.int32), mode="drop")

    return VoxelHashMap(
        keys=table_keys, points=points[:capacity],
        n_pts=jnp.minimum(n_pts[:capacity], slots),
        voxel_size=jnp.asarray(voxel_size, dtype),
        origin=jnp.asarray(origin, dtype))


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def neighborhood_candidates(vm: VoxelHashMap, queries: jnp.ndarray,
                            max_probes: int = 16):
    """Gather the 27-voxel candidate sets around each query (the
    cacheable retrieval half of kNN; same contract as
    voxel_grid.neighborhood_candidates)."""
    capacity = vm.keys.shape[0]
    slots = vm.points.shape[1]
    q = queries.shape[0]
    qkey = _pack_coords(queries, vm.voxel_size, vm.origin)
    nk = jnp.stack([_shift_key(qkey, d) for d in _OFFSETS], axis=-1)
    bucket = _find_buckets(vm.keys, nk, capacity, max_probes)
    safe_bucket = jnp.maximum(bucket, 0)
    cand = vm.points[safe_bucket]
    cnt = vm.n_pts[safe_bucket]
    slot_idx = jnp.arange(slots)[None, None, :]
    ok = (bucket[..., None] >= 0) & (slot_idx < cnt[..., None])
    return cand.reshape(q, 27 * slots, 3), ok.reshape(q, 27 * slots)


@partial(jax.jit, static_argnames=("k", "max_probes"))
def knn(vm: VoxelHashMap, queries: jnp.ndarray, k: int,
        max_probes: int = 16):
    """k nearest neighbors of each query from the 27 voxels around it.

    queries: [Q, 3]. Returns (neighbors [Q, k, 3], sq_dists [Q, k],
    valid [Q, k]); invalid lanes have +inf distance. Replaces
    ``KDTreeEigen::NearestKSearch`` (``localization/src/kdtree.cpp:
    42-63``). Queries landing in sparse neighborhoods may yield fewer
    than k valid neighbors — downstream estimators mask accordingly.
    """
    capacity = vm.keys.shape[0]
    slots = vm.points.shape[1]
    q = queries.shape[0]

    qkey = _pack_coords(queries, vm.voxel_size, vm.origin)      # [Q]
    nk = jnp.stack([_shift_key(qkey, d) for d in _OFFSETS], axis=-1)  # [Q,27]
    bucket = _find_buckets(vm.keys, nk, capacity, max_probes)   # [Q,27]

    safe_bucket = jnp.maximum(bucket, 0)
    cand = vm.points[safe_bucket]                               # [Q,27,S,3]
    cnt = vm.n_pts[safe_bucket]                                 # [Q,27]
    slot_idx = jnp.arange(slots)[None, None, :]
    cand_ok = (bucket[..., None] >= 0) & (slot_idx < cnt[..., None])

    cand = cand.reshape(q, 27 * slots, 3)
    cand_ok = cand_ok.reshape(q, 27 * slots)

    d = cand - queries[:, None, :]
    sq = jnp.sum(d * d, axis=-1)
    sq = jnp.where(cand_ok, sq, jnp.inf)
    neg_top, top_idx = jax.lax.top_k(-sq, k)
    sq_k = -neg_top
    nbrs = jnp.take_along_axis(cand, top_idx[..., None], axis=1)
    valid = jnp.isfinite(sq_k)
    nbrs = jnp.where(valid[..., None], nbrs, 0.0)
    return nbrs, sq_k, valid
