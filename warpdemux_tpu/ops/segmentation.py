"""Batched event segmentation for raw nanopore adapter signal.

Capability parity with the reference's Cython segmentation kernel
(reference: warpdemux/segmentation/_c_segmentation.pyx:124-161 `c_windowed_t_test`,
:41-53 `c_new_means`; wrapper warpdemux/segmentation/segmentation.py:32-74), but
engineered as fixed-shape masked JAX ops:

- `windowed_t_test`: the O(n*w) sliding loop becomes `w_max` shifted
  accumulation passes over whole (B, L) minibatches. Accumulation
  order per window matches the reference's left-to-right loop, so in float64
  mode the scores agree with the reference to the last bit for the mean pass
  and to rounding of the same-ordered sum for the variance pass.
- per-read window widths (the reference adapts `running_stat_width` per read,
  sig_proc.py:526-533) are traced scalars masked against a static `w_max`.
- `segment_means`: per-segment means via a centered inclusive cumsum and
  boundary gathers (the reference's `c_new_means` segment reduce).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def windowed_t_test(
    x: jnp.ndarray,
    n_valid: jnp.ndarray,
    w: jnp.ndarray,
    w_max: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Windowed t-statistic scores for every batch row.

    For each position p in [0, n_valid - 2w) compares the two adjacent windows
    [p, p+w) and [p+w, p+2w):  score = |m1 - m2| / sqrt(ssd1 + ssd2)  where ssd
    is the *sum* of squared deviations (the reference's monotone-transform
    t-score, _c_segmentation.pyx:66-68). Windows with ssd1+ssd2 == 0 score 0.

    Args:
      x: (B, L) signal, garbage past n_valid.
      n_valid: (B,) int, valid length per row.
      w: (B,) int, per-row window width (1 <= w <= w_max).
      w_max: static upper bound for w.

    Returns:
      scores: (B, L) with scores in [0, n_valid - 2w) and 0 elsewhere.
      n_scores: (B,) int = max(n_valid - 2w, 0).
    """
    B, L = x.shape
    dtype = x.dtype
    n_valid = n_valid.astype(jnp.int32)
    w = w.astype(jnp.int32)
    wf = w.astype(dtype)[:, None]

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    valid_x = pos < n_valid[:, None]
    xz = jnp.where(valid_x, x, 0.0)

    def shifted(arr, k):
        # arr[:, p + k] with wraparound (wrapped lanes are masked out below).
        return jnp.roll(arr, -k, axis=1)

    # First-window sums/deviations; element order matches the reference's
    # left-to-right accumulation.
    s1 = jnp.zeros((B, L), dtype)
    for idx in range(w_max):
        take = (idx < w)[:, None]
        s1 = s1 + jnp.where(take, shifted(xz, idx), 0.0)
    m1 = s1 / wf

    v1 = jnp.zeros((B, L), dtype)
    for idx in range(w_max):
        take = (idx < w)[:, None]
        d1 = shifted(xz, idx) - m1
        v1 = v1 + jnp.where(take, d1 * d1, 0.0)

    # Second window = first window shifted by w: m2[p] = m1[p+w],
    # v2[p] = v1[p+w]. The per-row dynamic shift is realized as a select
    # over the (small) static shift range of rolls.
    def shift_by_w(arr):
        out = jnp.zeros((B, L), dtype)
        for k in range(1, w_max + 1):
            out = jnp.where((w == k)[:, None], shifted(arr, k), out)
        return out

    m2 = shift_by_w(m1)
    v2 = shift_by_w(v1)

    n_scores = jnp.maximum(n_valid - 2 * w, 0)
    in_range = pos < n_scores[:, None]
    vsum = v1 + v2
    num = jnp.abs(m1 - m2)
    scores = jnp.where(vsum > 0, num / jnp.sqrt(jnp.maximum(vsum, 0.0)), 0.0)
    scores = jnp.where(in_range, scores, 0.0)
    return scores, n_scores


def segment_means(
    x: jnp.ndarray,
    boundaries: jnp.ndarray,
    n_valid: jnp.ndarray,
) -> jnp.ndarray:
    """Mean of x between consecutive boundaries (c_new_means semantics).

    Args:
      x: (B, L) signal.
      boundaries: (B, E+1) int sample indices, ascending, within [0, n_valid].
      n_valid: (B,) valid signal length (used to center for f32 accuracy).

    Returns:
      (B, E) segment means. Zero-length segments yield 0 (the reference would
      divide by zero; callers guarantee strictly increasing boundaries).
    """
    B, L = x.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    valid = pos < n_valid[:, None]
    nf = jnp.maximum(n_valid, 1).astype(x.dtype)
    center = jnp.sum(jnp.where(valid, x, 0.0), axis=1) / nf
    xc = jnp.where(valid, x - center[:, None], 0.0)
    # Exclusive cumsum C[p] = sum(xc[:p]); segment sum = C[b1] - C[b0],
    # from ONE gather of all boundary positions (adjacent-diff after).
    csum = jnp.cumsum(xc, axis=1)
    cpad = jnp.concatenate([jnp.zeros((B, 1), x.dtype), csum], axis=1)  # (B, L+1)
    b = jnp.clip(boundaries, 0, L)
    g = jnp.take_along_axis(cpad, b, axis=1)  # (B, E+1)
    seg_sum = g[:, 1:] - g[:, :-1]
    seg_len = (b[:, 1:] - b[:, :-1]).astype(x.dtype)
    means = jnp.where(seg_len > 0, seg_sum / jnp.maximum(seg_len, 1.0), 0.0)
    return means + center[:, None]


def segment_signal_batch(
    x: jnp.ndarray,
    n_valid: jnp.ndarray,
    num_events: int,
    min_obs_per_base: int,
    running_stat_width: int,
):
    """Full reference segmentation contract for a batch of adapter signals.

    Mirrors reference segment_signal (sig_proc.py:201-254) with the per-read
    parameter adaptation of sig_proc.py:523-535:
      min_obs = min(cfg, round(n/num_events/2)), w = min(cfg, round(n/num_events)).

    Returns (event_means, dwell_times, ok, scores, n_scores, boundaries):
      event_means: (B, num_events+1)  — num_events peaks split the signal into
        num_events+1 segments (boundaries 0 and n are always appended since
        peaks cannot touch the signal edges).
      dwell_times: (B, num_events+1) int32
      ok: (B,) bool — False when fewer than num_events peaks were found.
    """
    from warpdemux_tpu.ops.peaks import find_peaks_batch, select_top_peaks

    B, L = x.shape
    n_valid = n_valid.astype(jnp.int32)
    nf = n_valid.astype(jnp.float64 if x.dtype == jnp.float64 else jnp.float32)
    # np.round (banker's) parity with the reference's int(round(...)).
    min_obs = jnp.minimum(
        min_obs_per_base, jnp.round(nf / num_events / 2.0).astype(jnp.int32)
    )
    w = jnp.minimum(
        running_stat_width, jnp.round(nf / num_events).astype(jnp.int32)
    )
    w = jnp.maximum(w, 1)

    scores, n_scores = windowed_t_test(x, n_valid, w, running_stat_width)

    keep_mask, peak_count = find_peaks_batch(
        scores, n_scores, jnp.maximum(min_obs, 1),
        max_distance=min_obs_per_base + 1,
    )
    sel_pos, ok = select_top_peaks(scores, keep_mask, peak_count, num_events)
    ok = ok & (min_obs >= 1) & (n_scores > 0)

    # cpts = selected peaks + w, plus boundaries 0 and n_valid.
    cpts = jnp.sort(sel_pos, axis=1) + w[:, None]
    boundaries = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), cpts, n_valid[:, None]], axis=1
    )
    event_means = segment_means(x, boundaries, n_valid)
    dwell = boundaries[:, 1:] - boundaries[:, :-1]
    return event_means, dwell, ok, scores, n_scores, boundaries
