"""Exact order statistics (median / MAD) via radix bisection — no sorts.

The reference computes per-read medians and MADs with numpy over ragged
signal regions (reference: warpdemux/sig_proc.py:70-96 mad_normalize,
:421-431 outlier clipping; ADAPTed region summary stats, README.md:425-457).
A sort-based masked median costs a full (B, L) row sort per statistic, and
the detect stage needs about 14 of them. This module replaces every sort
with an exact binary search over the monotone integer image of float32:

  key(x) = bits(x) >= 0 ? bits(x) : bits(x) ^ 0x7FFFFFFF   (bits = int32)

maps float ordering onto int32 ordering (total order, -0.0 < +0.0, NaN at
the extremes). The k-th smallest masked key is found by one sign-deciding
count followed by building the low 31 bits from the MSB down: bit b is set
iff count(key < candidate) <= k. Each round is one masked compare + row-sum
over (B, L), and multiple ranks/regions share each round (one fused multi-output reduce)
instead of one sort per statistic.

Median semantics match numpy exactly: the average of the two middle order
statistics for even counts; NaN for empty masks.

`grouped_median_mad` computes med+MAD for R regions of the same rows in one
fused pass stack — the detect stage's adapter/polyA/RNA region statistics
(boundaries.py _region_stats) and the fingerprint outlier clip use it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# int32 order keys throughout: one sign-deciding pass, then every
# comparison is a plain signed int32 compare.
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def order_keys(x: jnp.ndarray) -> jnp.ndarray:
    """Monotone int32 image of float32 values (total order).

    Non-negative floats keep their bit pattern (>= 0 as int32); negative
    floats map onto negative ints in increasing order (-0.0 -> -1).
    """
    i = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    return jnp.where(i >= 0, i, i ^ jnp.int32(0x7FFFFFFF))


def keys_to_float(key: jnp.ndarray) -> jnp.ndarray:
    """Inverse of order_keys."""
    i = jnp.where(key >= 0, key, key ^ jnp.int32(0x7FFFFFFF))
    return jax.lax.bitcast_convert_type(i, jnp.float32)


def masked_rank_keys(
    key: jnp.ndarray, mask: jnp.ndarray, ranks: jnp.ndarray
) -> jnp.ndarray:
    """int32 key of the rank-th smallest masked key per row.

    key/mask: (..., L); ranks: (...) int32 0-based. One sign-deciding count,
    then 31 MSB-first bit-building rounds inside the fixed sign half. Rows
    where ranks >= count(mask) return garbage (caller masks; median handles
    the empty case explicitly).
    """
    ranks = ranks.astype(jnp.int32)
    cnt_neg = jnp.sum(
        jnp.where((key < 0) & mask, 1, 0), axis=-1
    ).astype(jnp.int32)
    res0 = jnp.where(ranks < cnt_neg, jnp.int32(_I32_MIN), jnp.int32(0))

    def body(i, res):
        bit = jnp.left_shift(jnp.int32(1), jnp.int32(30) - i)
        t = res | bit
        cnt = jnp.sum(
            jnp.where((key < t[..., None]) & mask, 1, 0), axis=-1
        ).astype(jnp.int32)
        return jnp.where(cnt <= ranks, t, res)

    return jax.lax.fori_loop(0, 31, body, res0)


def _next_larger(key: jnp.ndarray, mask: jnp.ndarray, lo: jnp.ndarray):
    """Smallest masked key strictly greater than lo (per row); I32_MAX if none."""
    cand = jnp.where((key > lo[..., None]) & mask, key, jnp.int32(_I32_MAX))
    return jnp.min(cand, axis=-1)


def median_from_keys(key, mask, n):
    """Median (numpy semantics) from precomputed keys.

    n: (...) int32 = count of valid lanes. Finds the lower middle with a
    32-round bisection, then the upper middle with two more passes (it is
    either the same value or the next larger one).
    """
    lo_rank = jnp.maximum((n - 1) // 2, 0)
    lo_key = masked_rank_keys(key, mask, lo_rank)
    lo = keys_to_float(lo_key)
    # upper middle: for odd n it's lo; for even n it's lo again iff lo's
    # multiplicity covers rank n//2, else the next larger masked value.
    cnt_le = jnp.sum(
        jnp.where((key <= lo_key[..., None]) & mask, 1, 0), axis=-1
    ).astype(jnp.int32)
    need_next = (n % 2 == 0) & (cnt_le <= n // 2)
    hi = jnp.where(
        need_next, keys_to_float(_next_larger(key, mask, lo_key)), lo
    )
    med = jnp.where((n % 2 == 1), lo, 0.5 * (lo + hi))
    return jnp.where(n > 0, med, jnp.nan)


def masked_median_select(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Exact masked median along the last axis (numpy semantics), sort-free."""
    key = jnp.where(mask, order_keys(x), jnp.int32(_I32_MAX))
    n = jnp.sum(mask, axis=-1).astype(jnp.int32)
    return median_from_keys(key, mask, n)


def masked_mad_select(
    x: jnp.ndarray, mask: jnp.ndarray, med: jnp.ndarray | None = None
) -> jnp.ndarray:
    if med is None:
        med = masked_median_select(x, mask)
    y = jnp.abs(x - med[..., None])
    return masked_median_select(y, mask)


def grouped_median_mad(
    x: jnp.ndarray,
    masks: jnp.ndarray,
    with_mad: bool = True,
):
    """Median (+ MAD) of R regions of the same rows, sharing bisection rounds.

    Args:
      x: (B, L) float32.
      masks: (R, B, L) bool region masks.
    Returns:
      (meds (R, B), mads (R, B) or None). All exact numpy semantics.
    """
    return grouped_median_mad_given(x, masks, with_mad)


def grouped_median_mad_given(
    x: jnp.ndarray,
    masks: jnp.ndarray,
    with_mad: bool = True,
    given_meds: jnp.ndarray | None = None,
    given: tuple = (),
):
    """grouped_median_mad with optional precomputed medians per region.

    given[r]=True regions pass given_meds[r] through (no median search) and
    MAD-bisect |x - given_meds[r]|.
    """
    key = order_keys(x)[None]  # (1, B, L)
    key = jnp.where(masks, key, jnp.int32(_I32_MAX))
    n = jnp.sum(masks, axis=-1).astype(jnp.int32)  # (R, B)
    if given_meds is not None and any(given):
        if all(given):
            meds = given_meds.astype(jnp.float32)
        else:
            searched = median_from_keys(key, masks, n)
            g = jnp.asarray(given, bool)[:, None]
            meds = jnp.where(g, given_meds.astype(jnp.float32), searched)
    else:
        meds = median_from_keys(key, masks, n)
    if not with_mad:
        return meds, None
    y = jnp.abs(x[None] - meds[..., None])
    ykey = jnp.where(masks, order_keys(y), jnp.int32(_I32_MAX))
    mads = median_from_keys(ykey, masks, n)
    return meds, mads


def range_median_mad(
    x: jnp.ndarray,
    starts: jnp.ndarray,
    ends: jnp.ndarray,
    with_mad: bool = True,
    given_meds: jnp.ndarray | None = None,
    given: tuple = (),
):
    """grouped_median_mad for contiguous [start, end) regions.

    Args:
      x: (B, L); starts/ends: (R, B) int32 (clamped to [0, L]).
      given_meds/given: optional (R, B) precomputed medians + per-region
        static flags; flagged regions skip the median search and only the
        MAD is bisected (the given median passes through to the output).
    Returns:
      (meds (R, B), mads (R, B) or None).
    """
    B, L = x.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, None, :]

    def _apply_given(meds):
        if given_meds is None or not any(given):
            return meds
        g = jnp.asarray(given, bool)[:, None]
        return jnp.where(g, given_meds.astype(meds.dtype), meds)

    if x.dtype != jnp.float32:
        # float64 parity mode: keep full precision with a sorted median
        masks = (pos >= starts[..., None]) & (pos < ends[..., None])
        meds = _apply_given(_sorted_median(x[None], masks))
        if not with_mad:
            return meds, None
        return meds, _sorted_median(jnp.abs(x[None] - meds[..., None]), masks)
    masks = (pos >= starts[..., None]) & (pos < ends[..., None])
    meds, mads = grouped_median_mad_given(
        x, masks, with_mad, given_meds=given_meds, given=given
    )
    return meds, mads


def _sorted_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Sort-based masked median (any float dtype; numpy semantics)."""
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    s = jnp.sort(jnp.where(mask, x, big), axis=-1)
    n = jnp.sum(mask, axis=-1)
    lo = jnp.take_along_axis(
        s, jnp.maximum((n - 1) // 2, 0)[..., None], axis=-1
    )[..., 0]
    hi = jnp.take_along_axis(s, jnp.maximum(n // 2, 0)[..., None], axis=-1)[
        ..., 0
    ]
    return jnp.where(n > 0, 0.5 * (lo + hi), jnp.nan)
