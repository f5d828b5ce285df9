"""Robust statistics kernels: masked median, MAD scale, Huber weights.

Array re-design of the reference's scalar loops:
- ``Median`` (``lib/src/stats.cpp:57-68``) — here a masked, fixed-shape
  sort-based median so it can live inside a jitted Gauss-Newton loop;
- ``MedianAbsoluteDeviation`` / ``Scale`` (``localization/src/robust.cpp:
  37-50``);
- ``Huber`` / ``HuberDerivative`` (``localization/src/robust.cpp:53-68``)
  as elementwise ops (the IRLS weights).

All functions take a validity mask: dynamic-size vectors become
fixed-shape arrays with invalid lanes ignored.
"""

from __future__ import annotations

import jax.numpy as jnp

# 1 / norm.ppf(3/4): consistent-estimator factor for MAD -> stddev.
# Parity: localization/src/robust.cpp:44-48.
MAD_CONSISTENCY = 1.482602218505602


def masked_median(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median over ``values[mask]`` without changing array shape.

    Matches ``Median_`` (``lib/src/stats.cpp:34-55``): for an even count
    the average of the two middle order statistics, for odd the single
    middle one. Invalid lanes sort to +inf; the middle indices are
    computed from the traced valid count.
    """
    n = jnp.sum(mask.astype(jnp.int32))
    big = jnp.asarray(jnp.inf, dtype=values.dtype)
    s = jnp.sort(jnp.where(mask, values, big))
    # Odd n: element (n-1)/2 twice. Even n: elements n/2-1 and n/2.
    lo = jnp.maximum((n - 1) // 2, 0)
    hi = jnp.where(n % 2 == 1, lo, jnp.minimum(jnp.maximum(n // 2, 0),
                                               values.shape[-1] - 1))
    med = 0.5 * (s[lo] + s[hi])
    return jnp.where(n > 0, med, jnp.asarray(jnp.nan, dtype=values.dtype))


def masked_mad(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median absolute deviation over the masked lanes.

    Parity: ``MedianAbsoluteDeviation`` (robust.cpp:37-42).
    """
    med = masked_median(values, mask)
    return masked_median(jnp.abs(values - med), mask)


def masked_scale(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Robust scale estimate ``1.4826 * MAD``. Parity: robust.cpp:44-50."""
    return MAD_CONSISTENCY * masked_mad(values, mask)


def _bisect_median(values: jnp.ndarray, mask: jnp.ndarray,
                   iters: int) -> jnp.ndarray:
    """Median by value-range bisection: ``iters`` halvings of [lo, hi]
    tracking where the rank-n/2 crossing lies. Converges to the exact
    median up to (hi-lo) * 2^-iters — effectively exact in float32 at
    30 iterations — without instantiating a sort."""
    import jax

    big = jnp.asarray(jnp.finfo(values.dtype).max, values.dtype)
    n = jnp.sum(mask.astype(jnp.int32))
    half = (n + 1) // 2  # rank of the lower middle element
    lo = jnp.min(jnp.where(mask, values, big))
    hi = jnp.max(jnp.where(mask, values, -big))

    def body(_, state):
        lo, hi = state
        mid = 0.5 * (lo + hi)
        below = jnp.sum((values <= mid) & mask)
        lo = jnp.where(below >= half, lo, mid)
        hi = jnp.where(below >= half, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    med = 0.5 * (lo + hi)
    return jnp.where(n > 0, med, jnp.asarray(jnp.nan, values.dtype))


def _wide_median(values: jnp.ndarray, mask: jnp.ndarray,
                 branch: int = 256, rounds: int = 3) -> jnp.ndarray:
    """Median by WIDE value-range bisection: each round tests ``branch``
    thresholds simultaneously (one fused compare+count pass over the
    data, one [N, branch] reduction) and
    narrows the interval by ``branch``x. Three rounds reach
    range * 256^-3 = 2^-24 — f32-exact — where the sequential bisection
    needed 30 dependent rounds. Converges to the lower-middle order
    statistic like the sequential version."""
    big = jnp.asarray(jnp.finfo(values.dtype).max, values.dtype)
    n = jnp.sum(mask.astype(jnp.int32))
    half = (n + 1) // 2  # rank of the lower middle element
    lo = jnp.min(jnp.where(mask, values, big))
    hi = jnp.max(jnp.where(mask, values, -big))

    steps = jnp.arange(1, branch + 1, dtype=values.dtype)
    for _ in range(rounds):
        w = (hi - lo) / branch
        t = lo + w * steps                                  # [branch]
        below = jnp.sum(((values[:, None] <= t[None, :])
                         & mask[:, None]).astype(jnp.int32), axis=0)
        j = jnp.minimum(jnp.sum((below < half).astype(jnp.int32)),
                        branch - 1).astype(values.dtype)
        lo, hi = lo + w * j, lo + w * (j + 1)
    med = 0.5 * (lo + hi)
    return jnp.where(n > 0, med, jnp.asarray(jnp.nan, values.dtype))


def masked_scale_bisect(values: jnp.ndarray, mask: jnp.ndarray,
                        iters: int = 30) -> jnp.ndarray:
    """Sort-free ``1.4826 * MAD`` via two wide-bisection medians.

    Each bisection converges to the LOWER-middle order statistic
    (rank ceil(n/2)); for even counts the reference averages the two
    middles (stats.cpp:44-55), so this deviates by up to the middle gap
    (~1/n relative for smooth error distributions). The Huber-IRLS
    weights this scale normalizes are insensitive to percent-level
    scale shifts, and the sort-free form is far cheaper inside the
    Gauss-Newton hot loop. ``iters`` is kept for API
    compatibility; precision is fixed at f32-exact (see _wide_median).
    """
    del iters
    med = _wide_median(values, mask)
    return MAD_CONSISTENCY * _wide_median(jnp.abs(values - med), mask)


def huber(e: jnp.ndarray, k: float = 1.345) -> jnp.ndarray:
    """Huber loss of a *squared* error ``e``. Parity: robust.cpp:53-60."""
    sqrt_e = jnp.sqrt(jnp.maximum(e, 0.0))
    return jnp.where(e < k * k, e, 2.0 * k * sqrt_e - k * k)


def huber_derivative(e: jnp.ndarray, k: float = 1.345) -> jnp.ndarray:
    """IRLS weight: d/de Huber(e) for squared error ``e``.

    Parity: robust.cpp:62-68 — 1 below the elbow, ``k / sqrt(e)`` above.
    """
    safe = jnp.maximum(e, k * k)
    return jnp.where(e < k * k, jnp.ones_like(e), k / jnp.sqrt(safe))
