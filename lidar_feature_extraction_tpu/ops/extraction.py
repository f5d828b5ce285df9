"""LOAM feature extraction as batched fixed-shape array programs.

Re-designs the reference's per-ring sequential pipeline
(``extraction/app/feature_extraction.cpp:92-171``) as a handful of
vectorized passes over the whole ``[n_rings, max_points]`` range image:

1. curvature — 1-D convolution of the XY range with weight
   ``[1..1, -2p, 1..1]`` then square (``extraction/src/curvature.cpp:
   36-51``, ``convolution.cpp:35-66``), expressed as a sum of lane
   shifts (one fused elementwise pass) instead of a scalar loop;
2. neighbor flags + "gap prefix" — the azimuth-adjacency predicate
   (``neighbor.hpp:45``, ``math.cpp:34``) evaluated once per adjacent
   pair; a prefix-sum of gaps turns the reference's directional
   flood-fills (``fill.hpp:41-118``) into O(1) window tests:
   points i<j are "connected" iff gap_prefix[i] == gap_prefix[j];
3. block partitioning — integer-exact boundaries of ``PaddedIndexRange``
   (``index_range.cpp:31-79``);
4. edge/surface labeling — the order-dependent argsort+suppress loops
   (``label.hpp:61-139``) become a bounded segmented non-max-suppression:
   every block of every ring picks its best candidate simultaneously each
   round (argmax of curvature for edges, argmin for surfaces), labels it,
   and suppresses its connected +/-padding window. Selection order within
   a block is identical to the reference (monotone curvature order), so
   labels agree exactly whenever the iteration cap is not hit;
5. occlusion / out-of-range / parallel-beam masking (``occlusion.hpp:
   38-93``, ``out_of_range.hpp:37``, ``parallel_beam.hpp:37``) as pure
   boolean window compositions, overwriting earlier labels in the same
   order the reference applies them.

Everything is mask-composed: no data-dependent shapes, one jit trace.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_feature_extraction_tpu.config import ExtractionConfig
from lidar_feature_extraction_tpu.core.scan import RangeImage, xy_range

# Label codes — parity with the PointLabel enum
# (extraction/include/lidar_feature_extraction/point_label.hpp:32-42).
DEFAULT = 0
EDGE = 1
EDGE_NEIGHBOR = 2
SURFACE = 3
SURFACE_NEIGHBOR = 4
OUT_OF_RANGE = 5
OCCLUDED = 6
PARALLEL_BEAM = 7


class ExtractionResult(NamedTuple):
    labels: jnp.ndarray        # [R, P] int32 PointLabel codes
    curvature: jnp.ndarray     # [R, P] float
    edge_xyz: jnp.ndarray      # [max_edges, 3]
    edge_valid: jnp.ndarray    # [max_edges] bool
    surface_xyz: jnp.ndarray   # [max_surfaces, 3]
    surface_valid: jnp.ndarray  # [max_surfaces] bool


def _split(a: jnp.ndarray):
    """a = hi + lo exactly, float32, each half with at most 12
    significant bits, so the product of two halves is exact."""
    bits = jax.lax.bitcast_convert_type(a, jnp.int32)
    hi = jax.lax.bitcast_convert_type(bits & ~0xFFF, jnp.float32)
    return hi, a - hi


def _dot2(a, b, c, d):
    """a*b + c*d from exact partial products.

    XLA's CPU backend fuses a multiply into the add that consumes it
    (one rounding); its GPU backend rounds the product first. Labels come
    from comparisons of such sums, so a last-bit difference can flip a
    label. With exact partial products a fused multiply-add rounds
    exactly as a plain add does, so every backend gives the same bits.
    Other dtypes take the plain expression.
    """
    if a.dtype != jnp.float32:
        return a * b + c * d
    ah, al = _split(a)
    bh, bl = _split(b)
    ch, cl = _split(c)
    dh, dl = _split(d)
    return (((ah * bh + ch * dh) + ((ah * bl + al * bh) + (ch * dl + cl * dh)))
            + (al * bl + cl * dl))


def _sqrt_step(s: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Move ``c`` one ulp toward the correctly rounded sqrt(s), float32.

    c = C * 2^f with C a 24-bit integer. Split c = ch + cl at 12 bits
    (bit mask), so ch*ch, 2*ch*cl and cl*cl are exact; s - ch*ch is
    exact (Sterbenz) and so is the next difference, whose exact value
    needs at most 13 bits. In units of 2^(2f) the sign of s - m^2 at
    the midpoints m = c +/- ulp/2 is then an int32 test. Every step is
    exact, so fused multiply-adds cannot change the answer.
    """
    bits = jax.lax.bitcast_convert_type(c, jnp.int32)
    ch = jax.lax.bitcast_convert_type(bits & ~0xFFF, jnp.float32)
    cl = c - ch
    d2 = (s - ch * ch) - (2.0 * ch) * cl           # s - c*c + cl*cl
    f = ((bits >> 23) & 0xFF) - 150                 # c = C * 2^f
    scale = jax.lax.bitcast_convert_type((127 - 2 * f) << 23, jnp.float32)
    n = (d2 * scale).astype(jnp.int32)              # exact integer
    big_c = (bits & 0x7FFFFF) | 0x800000
    cl_i = bits & 0xFFF
    above = n - cl_i * cl_i - big_c >= 1            # sqrt(s) > c + ulp/2
    low_c = jnp.where(big_c == 0x800000, big_c // 2, big_c)
    below = n - cl_i * cl_i + low_c <= 0            # sqrt(s) < c - ulp/2
    step = above.astype(jnp.int32) - below.astype(jnp.int32)
    return jax.lax.bitcast_convert_type(bits + step, jnp.float32)


def sqrt_rn(s: jnp.ndarray) -> jnp.ndarray:
    """Correctly rounded float32 square root on every backend.

    XLA's GPU square root is not correctly rounded (it differs from the
    CPU's in the last bit for about one value in six), and ranges decide
    labels through comparisons. Two exact correction steps from the
    backend's own result give the IEEE value; inputs outside
    [2^-80, 2^100] (zero, for masked lanes) keep the plain result, and
    so do other dtypes.
    """
    r = jnp.sqrt(s)
    if s.dtype != jnp.float32:
        return r
    ok = (s >= 2.0 ** -80) & (s <= 2.0 ** 100)
    c = jnp.where(ok, r, 1.0)
    t = jnp.where(ok, s, 1.0)
    for _ in range(2):
        c = _sqrt_step(t, c)
    return jnp.where(ok, c, r)


def curvature_kernel(rng: jnp.ndarray, count: jnp.ndarray,
                     padding: int) -> jnp.ndarray:
    """Squared range-curvature over each ring, [R, P].

    c[i] = (sum_{|k|<=p} w_k * range[i+k])^2 with w_p = -2p, else 1;
    zero outside [p, n-p). Parity: curvature.cpp:36-51.
    """
    p = padding
    if rng.dtype == jnp.float32:      # exact halves, see _dot2
        hi, lo = _split(rng)
        acc = (-2.0 * p) * hi + (-2.0 * p) * lo
    else:
        acc = -2.0 * p * rng
    for k in range(1, p + 1):
        acc = acc + jnp.roll(rng, k, axis=-1) + jnp.roll(rng, -k, axis=-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, rng.shape, rng.ndim - 1)
    interior = (idx >= p) & (idx < jnp.reshape(count, (-1, 1)) - p)
    return jnp.where(interior, acc * acc, 0.0)


def neighbor_flags_xy(x: jnp.ndarray, y: jnp.ndarray, count: jnp.ndarray,
                      radian_threshold: float) -> jnp.ndarray:
    """Plane-based ``neighbor_flags`` over x/y coordinate planes [R, P]
    (``count`` broadcasts as [R, 1]).

    The reference compares acos(cos) < threshold (math.cpp:34-49); cos
    is strictly decreasing on [0, pi], so this compares
    cos(angle) > cos(threshold) instead — the same predicate without
    the transcendental."""
    import math

    xn, yn = jnp.roll(x, -1, axis=-1), jnp.roll(y, -1, axis=-1)
    dot = _dot2(x, xn, y, yn)
    r = sqrt_rn(_dot2(x, x, y, y))
    norm = jnp.maximum(r * jnp.roll(r, -1, axis=-1), 1e-30)
    idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    has_next = idx < jnp.reshape(count, (-1, 1)) - 1
    # dot / norm > cos(threshold), without the division (not correctly
    # rounded on the GPU).
    return (dot > math.cos(radian_threshold) * norm) & has_next


def neighbor_flags(xyz: jnp.ndarray, count: jnp.ndarray,
                   radian_threshold: float) -> jnp.ndarray:
    """nb[r, i] = points i and i+1 of ring r subtend an XY angle below
    the threshold. Parity: IsNeighborXY (neighbor.hpp:45) with
    CalcRadian = acos(dot / (|a||b|)) on XY (math.cpp:34-49).
    nb is False at i >= count-1 (no successor).
    """
    return neighbor_flags_xy(xyz[..., 0], xyz[..., 1], count,
                             radian_threshold)


def gap_prefix(nb: jnp.ndarray) -> jnp.ndarray:
    """G[r, i] = number of non-neighbor pairs strictly before lane i.
    Two lanes i <= j are connected (every consecutive pair between them
    passes the neighbor check) iff G[i] == G[j]."""
    gaps = (~nb).astype(jnp.int32)
    g = jnp.cumsum(gaps, axis=-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, g.shape, g.ndim - 1)
    return jnp.where(idx >= 1, jnp.roll(g, 1, axis=-1), 0)


def block_ids(count: jnp.ndarray, n_points: int, padding: int,
              n_blocks: int) -> jnp.ndarray:
    """Block index of each lane, or -1 outside all blocks, [R, P].

    Boundary j of a ring with n valid points is
    floor((padding*(B-j) + (n-padding)*j) / B) — the integer-exact form of
    IndexRange::Boundary (index_range.cpp:62-69). Rings with
    n - 2*padding < n_blocks produce no blocks (the reference throws and
    skips the ring, index_range.cpp:35-42 + feature_extraction.cpp:154).
    """
    R = count.shape[0]
    n = jnp.reshape(count, (-1, 1))
    idx = jax.lax.broadcasted_iota(jnp.int32, (R, n_points), 1)
    # Accumulate over the n_blocks+1 boundaries as [R, P] compares (no
    # [R, P, n_blocks+1] temporary).
    blk = jnp.full((R, n_points), -1, jnp.int32)
    for j in range(n_blocks + 1):
        bound_j = (padding * (n_blocks - j) + (n - padding) * j) \
            // n_blocks                                     # [R, 1]
        blk = blk + (idx >= bound_j).astype(jnp.int32)
    active = (n - 2 * padding >= n_blocks)
    in_blocks = (blk >= 0) & (blk < n_blocks) & (idx < n - padding)
    return jnp.where(active & in_blocks, blk, -1)


def _nms_pass(labels, curvature, blk, g, count, *, padding, n_blocks,
              threshold, pick_max, point_code, neighbor_code, n_iter):
    """Multi-select parallel NMS labeling, exactly equivalent to the
    sequential descending/ascending label loops of label.hpp:61-139.

    Per round, EVERY candidate that has no better candidate within its
    connected +/-padding window (same block) is selected simultaneously,
    then all selected windows are suppressed. Equivalence argument: only
    a better candidate within +/-padding can ever suppress a point in
    the sequential order, so a locally-best candidate is guaranteed to
    be selected by the sequential algorithm too; conversely a point with
    a better candidate in its window merely waits — if its suppressor is
    itself suppressed first, the point becomes locally-best in a later
    round (after the suppressor's lanes leave candidacy) exactly when
    the sequential scan would reach it still unlabeled. Ties follow the
    sequential processing order of a stable sort (edges: higher index
    first — the descending pass reverses a stable ascending order;
    surfaces: lower index first). Two mutually-windowed points can never
    both be selected in one round (one must be better under the total
    order).

    Rounds needed: typically a handful; worst case (a monotone chain
    spaced <= padding apart) resolves ~1 selection per round like the
    old argmax version — ``n_iter`` caps it. The loop exits as soon as
    a round selects nothing: selection/suppression depend only on
    ``labels``, so a no-op round is a fixpoint and early exit is exact
    (and the cap can sit far above the typical round count for a hard
    equivalence guarantee at no steady-state cost).
    """
    lane = jax.lax.broadcasted_iota(jnp.int32, curvature.shape,
                                    curvature.ndim - 1)
    P = curvature.shape[-1]
    neg_inf = -jnp.inf

    score = curvature if pick_max else -curvature
    thr_ok = (curvature >= threshold) if pick_max else (curvature <= threshold)
    base_cand = (blk >= 0) & thr_ok

    def body(state):
        labels, it, _ = state
        cand = base_cand & (labels == DEFAULT)
        s = jnp.where(cand, score, neg_inf)                     # [R, P]

        # Safety: no better candidate within the connected +/-padding
        # window of the same block.
        blocked = jnp.zeros_like(cand)
        for d in range(1, padding + 1):
            for sgn in (-1, 1):
                dd = sgn * d
                s_n = jnp.roll(s, -dd, axis=-1)
                g_n = jnp.roll(g, -dd, axis=-1)
                blk_n = jnp.roll(blk, -dd, axis=-1)
                inb = ((lane + dd >= 0) & (lane + dd < P)
                       & (g_n == g) & (blk_n == blk))
                if pick_max:
                    tie_win = dd > 0    # higher index first on ties
                else:
                    tie_win = dd < 0    # lower index first on ties
                better = (s_n > s) | ((s_n == s) & tie_win)
                blocked = blocked | (inb & better & (s_n > neg_inf))
        selected = cand & ~blocked

        # Suppress the connected +/-padding windows of all selections.
        win = selected
        for d in range(1, padding + 1):
            for sgn in (-1, 1):
                dd = sgn * d
                sel_n = jnp.roll(selected, -dd, axis=-1)
                g_n = jnp.roll(g, -dd, axis=-1)
                blk_n = jnp.roll(blk, -dd, axis=-1)
                inb = ((lane + dd >= 0) & (lane + dd < P)
                       & (g_n == g) & (blk_n == blk))
                win = win | (sel_n & inb)

        labels = jnp.where(win, neighbor_code, labels)
        labels = jnp.where(selected, point_code, labels)
        return labels, it + 1, jnp.any(selected)

    def cond(state):
        _, it, changed = state
        return changed & (it < n_iter)

    labels, _, _ = jax.lax.while_loop(
        cond, body, (labels, jnp.asarray(0, jnp.int32),
                     jnp.asarray(True)))
    return labels


def occlusion_mask(rng, nb, g, count, *, padding, distance_diff_threshold):
    """Boolean mask of occluded points, [R, P].

    Left sweep (occlusion.hpp:38-57): a neighbor pair (i, i+1) whose
    range jumps up by more than the threshold marks i+1 .. i+1+padding
    (stopping at gaps) as occluded. Right sweep (occlusion.hpp:60-79)
    mirrors it. Expressed as padding+1 shifted window tests against the
    gap prefix.
    """
    P = rng.shape[-1]
    idx = jax.lax.broadcasted_iota(jnp.int32, rng.shape, rng.ndim - 1)
    n = jnp.reshape(jnp.asarray(count), (-1, 1))

    jump_up = jnp.roll(rng, -1, axis=-1) > rng + distance_diff_threshold
    # Left: trigger at position i+1 for i in [0, n-padding-2].
    trig_l = jnp.roll(nb & jump_up & (idx < n - padding - 1), 1, axis=-1)
    trig_l = trig_l & (idx >= 1)
    # Right: trigger at position m=i-1 for i in [padding+1, n-1]:
    # nb(m, m+1) and range[m] > range[m+1] + thr.
    jump_down = rng > jnp.roll(rng, -1, axis=-1) + distance_diff_threshold
    trig_r = nb & jump_down & (idx >= padding) & (idx <= n - 2)

    occl = trig_l | trig_r                                   # dshift = 0
    for dshift in range(1, padding + 1):
        tl = jnp.roll(trig_l, dshift, axis=-1) & (idx >= dshift)
        gl = jnp.roll(g, dshift, axis=-1)
        occl = occl | (tl & (g == gl))
        tr = jnp.roll(trig_r, -dshift, axis=-1) & (idx + dshift < P)
        gr = jnp.roll(g, -dshift, axis=-1)
        occl = occl | (tr & (g == gr))
    return occl & (idx < n)


def parallel_beam_mask(rng, count, *, range_ratio_threshold):
    """ratio test on both adjacent ranges (parallel_beam.hpp:37-53)."""
    idx = jax.lax.broadcasted_iota(jnp.int32, rng.shape, rng.ndim - 1)
    n = jnp.reshape(jnp.asarray(count), (-1, 1))
    # |dr| / r > threshold, without the division (not correctly rounded
    # on the GPU).
    lim = range_ratio_threshold * jnp.maximum(rng, 1e-30)
    d_prev = jnp.abs(jnp.roll(rng, 1, axis=-1) - rng)
    d_next = jnp.abs(jnp.roll(rng, -1, axis=-1) - rng)
    inner = (idx >= 1) & (idx < n - 1)
    return (d_prev > lim) & (d_next > lim) & inner


def label_planes(x: jnp.ndarray, y: jnp.ndarray, mask: jnp.ndarray,
                 count: jnp.ndarray, cfg: ExtractionConfig
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Plane-based labeling core over x/y coordinate planes [R, P]."""
    rng = jnp.where(mask, sqrt_rn(_dot2(x, x, y, y)), 0.0)

    curv = curvature_kernel(rng, count, cfg.padding)
    nb = neighbor_flags_xy(x, y, count, cfg.radian_threshold)
    g = gap_prefix(nb)
    blk = block_ids(count, x.shape[-1], cfg.padding, cfg.n_blocks)

    labels = jnp.full(rng.shape, DEFAULT, jnp.int32)
    labels = _nms_pass(
        labels, curv, blk, g, count,
        padding=cfg.padding, n_blocks=cfg.n_blocks,
        threshold=cfg.edge_threshold, pick_max=True,
        point_code=EDGE, neighbor_code=EDGE_NEIGHBOR,
        n_iter=cfg.nms_rounds)
    labels = _nms_pass(
        labels, curv, blk, g, count,
        padding=cfg.padding, n_blocks=cfg.n_blocks,
        threshold=cfg.surface_threshold, pick_max=False,
        point_code=SURFACE, neighbor_code=SURFACE_NEIGHBOR,
        n_iter=cfg.nms_rounds)

    # Masking passes overwrite labels in the reference's order
    # (feature_extraction.cpp:137-142).
    ring_active = jnp.reshape(count, (-1, 1)) - 2 * cfg.padding \
        >= cfg.n_blocks
    occl = occlusion_mask(rng, nb, g, count, padding=cfg.padding,
                          distance_diff_threshold=cfg.distance_diff_threshold)
    labels = jnp.where(occl & ring_active, OCCLUDED, labels)

    idx = jax.lax.broadcasted_iota(jnp.int32, rng.shape, rng.ndim - 1)
    in_ring = idx < jnp.reshape(count, (-1, 1))
    oor = ~((rng >= cfg.min_range) & (rng <= cfg.max_range)) & in_ring
    labels = jnp.where(oor & ring_active, OUT_OF_RANGE, labels)

    par = parallel_beam_mask(rng, count,
                             range_ratio_threshold=cfg.parallel_beam_min_range_ratio)
    labels = jnp.where(par & ring_active, PARALLEL_BEAM, labels)

    labels = jnp.where(mask & ring_active, labels, DEFAULT)
    return labels, curv


def label_range_image(image: RangeImage,
                      cfg: ExtractionConfig) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compute per-point labels and curvature for a whole range image."""
    return label_planes(image.xyz[..., 0], image.xyz[..., 1],
                        image.mask, image.count, cfg)


def compact_by_mask(xyz: jnp.ndarray, mask: jnp.ndarray,
                    capacity: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather masked points of a [R, P, 3] tensor into a fixed-capacity
    [capacity, 3] array + validity mask (the fixed-shape replacement for
    the dynamically-sized GetIndicesByValue / GetByIndices extraction,
    lib/include/lidar_feature_library/algorithm.hpp:41-62)."""
    flat = mask.ravel()
    (sel,) = jnp.nonzero(flat, size=capacity, fill_value=flat.shape[0])
    valid = sel < flat.shape[0]
    pts = xyz.reshape(-1, 3)
    gathered = jnp.where(valid[:, None],
                         pts[jnp.minimum(sel, flat.shape[0] - 1)], 0.0)
    return gathered, valid


@partial(jax.jit, static_argnames=("cfg",))
def extract_features(image: RangeImage,
                     cfg: ExtractionConfig) -> ExtractionResult:
    """Full feature-extraction step for one organized scan."""
    labels, curv = label_range_image(image, cfg)
    edge_xyz, edge_valid = compact_by_mask(
        image.xyz, (labels == EDGE) & image.mask, cfg.max_edges)
    surf_xyz, surf_valid = compact_by_mask(
        image.xyz, (labels == SURFACE) & image.mask, cfg.max_surfaces)
    return ExtractionResult(labels, curv, edge_xyz, edge_valid,
                            surf_xyz, surf_valid)


def _voxel_run_key(xyz: jnp.ndarray, leaf: float) -> jnp.ndarray:
    """int32 voxel identity hash of [..., 3] points (equality of ADJACENT
    lanes only — a hash collision merely merges two neighboring runs)."""
    c = jnp.floor(xyz * (1.0 / leaf)).astype(jnp.int32)
    return (c[..., 0] * 73856093) ^ (c[..., 1] * 19349663) \
        ^ (c[..., 2] * 83492791)


def _propagate_from_flag(flag: jnp.ndarray, value: jnp.ndarray,
                         axis: int) -> jnp.ndarray:
    """Per lane: the most recent ``value`` at or before it where ``flag``
    is set (a segmented hold — log-depth associative scan, elementwise)."""

    def combine(a, b):
        af, av = a
        bf, bv = b
        return bf | af, jnp.where(bf[..., None] if bv.ndim > bf.ndim
                                  else bf, bv, av)

    _, out = jax.lax.associative_scan(combine, (flag, value), axis=axis)
    return out


def compact_columns(labels: jnp.ndarray, mask: jnp.ndarray,
                    key: jnp.ndarray, ce: int, cs: int):
    """One-hot column assignment of the compaction matmul, [R, P] int32.

    Edge lanes get their per-ring rank (capped at ``ce``); surface
    voxel-run END lanes get ``ce +`` their stratified run column; all
    other lanes get the dump column ``ce + cs``. Returns (col, edge_mask,
    surf_mask, run_end)."""
    edge_mask = (labels == EDGE) & mask
    surf_mask = (labels == SURFACE) & mask
    idx = jax.lax.broadcasted_iota(jnp.int32, labels.shape,
                                   labels.ndim - 1)
    P = labels.shape[-1]

    # Edge columns: per-ring rank, capped.
    epos = jnp.cumsum(edge_mask.astype(jnp.int32), axis=-1) - 1
    ecol = jnp.where(edge_mask & (epos < ce), epos, -1)

    # Surface runs: adjacent SURFACE lanes sharing a voxel key.
    nxt_key = jnp.roll(key, -1, axis=-1)
    nxt_surf = jnp.roll(surf_mask, -1, axis=-1) & (idx < P - 1)
    run_end = surf_mask & (~nxt_surf | (nxt_key != key))
    rid = jnp.cumsum(run_end.astype(jnp.int32), axis=-1) - 1     # [R, P]
    n_runs = jnp.maximum(rid[:, P - 1:P] + 1, 1)
    # Stratified pick: column floor(rid * cs / max(n_runs, cs)); take
    # the first run that lands on each column.
    denom = jnp.maximum(n_runs, cs)
    scol_all = (rid * cs) // denom
    scol_prev = ((rid - 1) * cs) // denom
    first_on_col = (rid == 0) | (scol_all > scol_prev)
    scol = jnp.where(run_end & first_on_col, scol_all, -1)

    col = jnp.where(ecol >= 0, ecol,
                    jnp.where(scol >= 0, ce + scol, ce + cs))
    return col, edge_mask, surf_mask, run_end


class CompactFeatures(NamedTuple):
    """Feature outputs of the single-matmul compaction path.

    edge_xyz:     [R * edges_per_ring, 3]
    surface_xyz:  [R * surface_runs_per_ring, 3] one point per voxel run
                  (run-end sample, or run centroid when
                  ``surface_centroid=True``)
    """

    labels: jnp.ndarray
    curvature: jnp.ndarray
    edge_xyz: jnp.ndarray
    edge_valid: jnp.ndarray
    surface_xyz: jnp.ndarray
    surface_valid: jnp.ndarray


@partial(jax.jit, static_argnames=("cfg", "surface_leaf",
                                   "edges_per_ring",
                                   "surface_runs_per_ring",
                                   "surface_centroid"))
def extract_features_compact(image: RangeImage, cfg: ExtractionConfig,
                             surface_leaf: float = 1.0,
                             edges_per_ring: int = 32,
                             surface_runs_per_ring: int = 64,
                             surface_centroid: bool = False
                             ) -> CompactFeatures:
    """Feature extraction with ONE irregular op total.

    The reference pipeline compacts labeled features into dynamic
    vectors (GetIndicesByValue, lib/algorithm.hpp:41-62) and voxel-
    downsamples the surface scan at registration time (surface.hpp:111).
    This path reformulates both steps as dense per-ring algebra finished
    by a single one-hot matmul, with no nonzero / sort / scatter:

    - **edges**: per-ring rank by lane order (cumsum of the EDGE mask);
      the first ``edges_per_ring`` per ring keep their rank as the
      one-hot column (identical feature set to ``extract_features``
      whenever no ring overflows the cap — the cap plays the role of
      the global ``max_edges`` capacity truncation);
    - **surfaces**: one point per per-ring voxel RUN. Consecutive
      SURFACE-labeled lanes sharing a ``surface_leaf`` voxel form a run
      (detected by adjacent-lane key equality); runs are selected
      STRATIFIED by azimuth rank — floor(rid * cap / n_runs) — so the
      output keeps even angular coverage when a ring has more runs than
      ``surface_runs_per_ring``. This replaces the global PCL voxel
      centroid (ops/downsample.py) in the registration hot path: the
      same 1-leaf spatial thinning, represented by the run-END measured
      point (``surface_centroid=False``, default — a real surface
      sample, no scan machinery) or the run centroid
      (``surface_centroid=True`` — the PCL-style mean, paid for with a
      masked cumsum + log-depth segmented hold). Voxels revisited by later runs/other rings
      contribute one point per run instead of being merged (documented
      deviation, docs/design.md §8; acceptance is ATE parity).

    Both feature classes ride ONE [R, P, ce+cs] one-hot matmul at
    ``Precision.HIGHEST``: every output sums one feature value and zeros
    in float32, so values are bit-identical to a gather. At a lower
    matmul precision (TF32 on a GPU) the coordinates would be rounded.
    """
    xyz = image.xyz
    R, P = image.mask.shape
    ce, cs = edges_per_ring, surface_runs_per_ring
    dtype = xyz.dtype

    labels, curv = label_range_image(image, cfg)
    key = _voxel_run_key(xyz, surface_leaf)
    col, edge_mask, surf_mask, _ = compact_columns(
        labels, image.mask, key, ce, cs)

    if surface_centroid:
        idx = jax.lax.broadcasted_iota(jnp.int32, (R, P), 1)
        prv_surf = jnp.roll(surf_mask, 1, axis=-1) & (idx >= 1)
        prv_key = jnp.roll(key, 1, axis=-1)
        run_start = surf_mask & (~prv_surf | (prv_key != key))

        cs_xyz = jnp.cumsum(jnp.where(surf_mask[..., None], xyz, 0.0),
                            axis=1)
        cs_cnt = jnp.cumsum(surf_mask.astype(dtype), axis=1)
        csum4 = jnp.concatenate([cs_xyz, cs_cnt[..., None]], axis=-1)
        own4 = jnp.concatenate(
            [jnp.where(surf_mask[..., None], xyz, 0.0),
             surf_mask.astype(dtype)[..., None]], axis=-1)
        base = _propagate_from_flag(run_start, csum4 - own4, axis=1)
        run_sum4 = csum4 - base               # valid at run_end lanes
    else:
        # Run-end representative point: [xyz, 1] — count 1 per run.
        run_sum4 = jnp.concatenate([xyz, jnp.ones((R, P, 1), dtype)],
                                   axis=-1)
    onehot = (col[..., None]
              == jnp.arange(ce + cs)[None, None, :]).astype(dtype)
    if surface_centroid:
        feat = jnp.where(edge_mask[..., None],
                         jnp.concatenate([xyz, jnp.ones((R, P, 1), dtype)],
                                         axis=-1),
                         run_sum4)
    else:
        feat = run_sum4          # [xyz, 1] for edges and surfaces alike
    out = jnp.einsum("rpc,rpf->rcf", onehot, feat,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=dtype)     # [R, ce+cs, 4]

    eblk = out[:, :ce]
    sblk = out[:, ce:]
    edge_valid = eblk[..., 3] > 0.5
    edge_xyz = jnp.where(edge_valid[..., None], eblk[..., :3], 0.0)
    s_cnt = sblk[..., 3]
    surf_valid = s_cnt > 0.5
    surf_xyz = jnp.where(surf_valid[..., None],
                         sblk[..., :3] / jnp.maximum(s_cnt[..., None], 1.0),
                         0.0)
    return CompactFeatures(
        labels=labels, curvature=curv,
        edge_xyz=edge_xyz.reshape(R * ce, 3),
        edge_valid=edge_valid.reshape(R * ce),
        surface_xyz=surf_xyz.reshape(R * cs, 3),
        surface_valid=surf_valid.reshape(R * cs))
