"""Batched peak picking with scipy.signal.find_peaks(distance=...) parity.

The reference selects changepoints with
`find_peaks(scores, distance=min_obs_per_base)` followed by keeping the
`num_events` highest-scoring peaks (reference: warpdemux/sig_proc.py:176-198).
That ranking decides which events exist, so we replicate scipy's semantics in
masked, batched JAX form — formulated entirely over (B, L) *position-space
masks*: no compaction buffers, no scatters, no large sorts; element-wise
masks and reductions fuse and compile quickly.

1. local maxima with plateau-midpoint handling (scipy `_local_maxima_1d`):
   a peak is a maximal run x[s..e] of equal values with x[s-1] < v,
   x[e+1] < v, s >= 1, e <= n-2; its position is (s+e)//2. Computed with a
   forward cummax (last differing index) and a reverse cummin (next differing
   index) — position p is a peak iff p == (s+e)//2 for its own run.
2. distance suppression (scipy `_select_by_peak_distance`): peaks are visited
   from highest score to lowest; a still-kept peak suppresses every peak
   strictly within `distance` samples. That greedy process equals the
   priority-greedy maximal independent set of the peak-interval graph, which
   we compute by parallel fixpoint rounds: every peak that is the highest
   priority among still-alive peaks within its own distance window is a
   *definite survivor*; survivors kill their neighborhoods; repeat until no
   peaks remain undecided. Each round is a handful of statically-shifted
   element-wise compares, and the round count is the depth of the domination
   chains (a handful in practice) instead of the peak count.
3. top-k by score via top_k on the reversed row (ties again prefer the later
   position, matching np.argsort(scores)[-k:]).

Tie-order caveat: scipy/numpy use an *unstable* quicksort for the priority
order, so the visiting order of exactly-equal scores is an implementation
detail that cannot be reproduced portably. Our later-position-first order is
deterministic and equivalent to scipy whenever peak scores are unique
(t-scores of real signal are continuous; exact ties essentially only arise
on synthetic/quantized inputs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = 2**30


def peak_mask_batch(
    scores: jnp.ndarray,
    n_scores: jnp.ndarray,
    min_pos: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Plateau-aware local-maxima mask per row.

    Args:
      scores: (B, L); n_scores: (B,) valid length per row.
      min_pos: optional (B,) int32 slice origin. When given, peaks are the
        local maxima of the *sliced* row scores[min_pos:n_scores] mapped back
        to global positions: a plateau run qualifies iff its start s >=
        min_pos + 1 (the slice's first element can never be a peak, matching
        scipy on the sliced array; the tRNA consensus-refinement path
        re-segments scores[sig_barcode_start:], reference sig_proc.py:330-362).

    Returns:
      is_peak: (B, L) bool mask at plateau midpoints.
      peak_count: (B,) int32.
    """
    B, L = scores.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)

    # Gather-free formulation: pack (change position, direction) into one
    # int key and forward/backward-fill with lax.cummax (packed cummax keys
    # + element-wise math instead of scans combined with gathers).
    # A bounded-plateau shifted-compare fast path behind a lax.cond was
    # measured SLOWER here: the conditional's operand materialization and
    # lost cross-boundary fusion cost more than the two cummax scans.)
    #
    # Left side: the most recent change at or before p is the start s of p's
    # plateau run; its direction bit says whether x[s-1] < x[s] (a rise).
    xl = jnp.concatenate([scores[:, :1], scores[:, :-1]], axis=1)
    changed_l = (scores != xl).at[:, 0].set(False)
    key_l = jnp.where(
        changed_l, pos * 2 + (scores > xl).astype(jnp.int32), -1
    )
    kl = jax.lax.cummax(key_l, axis=1)
    s = kl >> 1  # plateau start (valid when kl >= 0)
    rose = (kl >= 0) & ((kl & 1) == 1)

    # Right side: the nearest change at or after p is the end e of the run;
    # its direction bit says whether x[e] > x[e+1] (a fall).
    xr = jnp.concatenate([scores[:, 1:], scores[:, -1:]], axis=1)
    changed_r = (scores != xr).at[:, -1].set(False)
    key_r = jnp.where(
        changed_r, (L - 1 - pos) * 2 + (scores > xr).astype(jnp.int32), -1
    )
    kr = jax.lax.cummax(key_r, axis=1, reverse=True)
    e = (L - 1) - (kr >> 1)  # plateau end (valid when kr >= 0)
    fell = (kr >= 0) & ((kr & 1) == 1)

    is_peak = (
        rose
        & fell
        & (e <= n_scores[:, None] - 2)
        & (pos == (s + e) // 2)
    )
    if min_pos is not None:
        is_peak = is_peak & (s >= (min_pos.astype(jnp.int32) + 1)[:, None])
    return is_peak, jnp.sum(is_peak, axis=1).astype(jnp.int32)


def suppress_by_distance(
    scores: jnp.ndarray,
    is_peak: jnp.ndarray,
    distance: jnp.ndarray,
    max_distance: int,
) -> jnp.ndarray:
    """scipy `_select_by_peak_distance` as a parallel priority-MIS fixpoint.

    A peak p is killed iff some *surviving* peak q with higher priority lies
    strictly within `distance` of it (priority = (score, position), later
    position winning ties — see the module tie-order note). Rounds:

      winner = alive peak with no higher-priority alive peak within distance
      keep  |= winner;  alive -= winner + (alive within distance of a winner)

    which reproduces the sequential greedy exactly (induction over priority
    order). All neighborhood tests are static slices of a padded row, i.e.
    pure fused element-wise ops.

    Args:
      scores: (B, L) score curve.
      is_peak: (B, L) local-maxima mask.
      distance: (B,) per-row suppression distance (>= 1).
      max_distance: static upper bound on distance values.

    Returns:
      keep: (B, L) bool mask of surviving peaks.
    """
    B, L = scores.shape
    W = max(int(max_distance), 1)
    neg_inf = jnp.asarray(-jnp.inf, scores.dtype)
    d_col = distance.astype(jnp.int32)[:, None]
    false_row = jnp.zeros((B, L), bool)

    def round_fn(state):
        alive, keep = state
        s_alive = jnp.where(alive, scores, neg_inf)
        spad = jnp.pad(
            s_alive, ((0, 0), (W, W)), constant_values=-jnp.inf
        )
        dom = false_row
        for o in range(1, W):
            within = o < d_col
            right = spad[:, W + o : W + o + L]  # neighbor at p + o
            left = spad[:, W - o : W - o + L]  # neighbor at p - o
            # later position wins ties -> right dominates on >=, left on >
            dom = dom | (within & (right >= s_alive)) | (
                within & (left > s_alive)
            )
        winner = alive & ~dom
        keep = keep | winner
        wpad = jnp.pad(winner, ((0, 0), (W, W)))
        killed = false_row
        for o in range(1, W):
            within = o < d_col
            killed = killed | (
                within
                & (wpad[:, W + o : W + o + L] | wpad[:, W - o : W - o + L])
            )
        alive = alive & ~winner & ~killed
        return alive, keep

    def cond(state):
        alive, _ = state
        return jnp.any(alive)

    _, keep = jax.lax.while_loop(cond, round_fn, (is_peak, false_row))
    return keep


def find_peaks_batch(
    scores: jnp.ndarray,
    n_scores: jnp.ndarray,
    distance: jnp.ndarray,
    max_distance: int | None = None,
    min_pos: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """scipy.signal.find_peaks(scores_row, distance=distance_row) per row.

    max_distance: static bound on distance (defaults to 32, ample for the
    reference's min_obs_per_base configs).
    min_pos: optional (B,) slice origin — peaks of scores[min_pos:n_scores]
    at global positions (see peak_mask_batch).

    Returns (keep_mask (B, L) bool, peak_count (B,) int32).
    """
    is_peak, _ = peak_mask_batch(scores, n_scores, min_pos)
    keep = suppress_by_distance(
        scores, is_peak, distance, max_distance or 32
    )
    return keep, jnp.sum(keep, axis=1).astype(jnp.int32)


def _topk_rev_indices(mrev, num_events):
    """Top-k indices into an already-reversed (masked) row.

    Segmented two-stage when the row is long: per-segment top-ks then one
    top-k over the nseg*k candidates — a top_k that lowers to a full row
    sort costs ~log^2(width), so several short sorts beat one long one. Tie order is top_k's lowest-index-first at
    both stages, which on a reversed row means the LATER global position
    (matching np.argsort tail selection).
    """
    B, L = mrev.shape
    nseg = 8
    seg = -(-L // nseg)
    if L < nseg * max(num_events, 128) or seg < num_events:
        _, idx = jax.lax.top_k(mrev, num_events)
        return idx.astype(jnp.int32)
    pad = nseg * seg - L
    mrev_p = jnp.pad(mrev, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    segs = mrev_p.reshape(B * nseg, seg)
    v1, i1 = jax.lax.top_k(segs, num_events)  # (B*nseg, k)
    base = (jnp.arange(nseg, dtype=jnp.int32) * seg)[None, :, None]
    gidx = i1.reshape(B, nseg, num_events).astype(jnp.int32) + base
    cand_v = v1.reshape(B, nseg * num_events)
    cand_i = gidx.reshape(B, nseg * num_events)
    _, i2 = jax.lax.top_k(cand_v, num_events)  # (B, k) into candidates
    return jnp.take_along_axis(cand_i, i2.astype(jnp.int32), axis=1)


def _select_top_peaks_segmented(scores, keep_mask, num_events):
    """Two-stage segmented top-k (the general path; see select_top_peaks)."""
    B, L = scores.shape
    neg_inf = jnp.asarray(-jnp.inf, scores.dtype)
    mrev = jnp.where(keep_mask, scores, neg_inf)[:, ::-1]
    rev_idx = _topk_rev_indices(mrev, num_events)
    return (L - 1) - rev_idx


def _select_top_peaks_chunkmax(scores, keep_mask, num_events, C=4):
    """Width-C chunk-max top-k (valid when no chunk holds 2 kept peaks)."""
    B, L = scores.shape
    J = -(-L // C)
    neg_inf = jnp.asarray(-jnp.inf, scores.dtype)
    m = jnp.where(keep_mask, scores, neg_inf)
    mp = jnp.pad(m, ((0, 0), (0, J * C - L)), constant_values=-jnp.inf)
    v4 = mp.reshape(B, J, C)
    # chunk max, later lane winning ties (matches argsort tie order)
    bestv = v4[:, :, 0]
    bestl = jnp.zeros((B, J), jnp.int32)
    for lane in range(1, C):
        upd = v4[:, :, lane] >= bestv
        bestv = jnp.where(upd, v4[:, :, lane], bestv)
        bestl = jnp.where(upd, lane, bestl)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, J), 1) * C + bestl
    # stage 2 on the reversed candidate row: lower index == later global
    # position, so the lowest-index tie break keeps argsort order; the
    # segmented top-k keeps the candidate-row sort short
    i2 = _topk_rev_indices(bestv[:, ::-1], num_events)
    return jnp.take_along_axis(pos[:, ::-1], i2, axis=1)


def select_top_peaks(
    scores: jnp.ndarray,
    keep_mask: jnp.ndarray,
    peak_count: jnp.ndarray,
    num_events: int,
    non_adjacent: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Keep the num_events highest-scoring peaks (reference sig_proc.py:185-188).

    Tie behavior matches np.argsort(scores[peaks])[-num_events:]: equal scores
    prefer the later peak (top_k on the reversed row). Returns
    (sel_pos (B, num_events) int32 positions, ok (B,) = count >= num_events).
    Rows with ok=False contain garbage and must be masked by the caller.

    Selection strategy on long rows (top_k can lower to a full stable
    key-value row sort):

    * width-2 chunk-max (the production path): keep_mask comes out of
      distance suppression of LOCAL MAXIMA, and local maxima are never
      adjacent — a position needs a strict rise on one side and its
      neighbor would need the opposite, and scipy-style plateau handling
      marks only the plateau middle — so no width-2 chunk ever holds two
      kept peaks, at ANY suppression distance (including the distance-1/2
      rows produced by the per-read min_obs adaptation on short
      extracts). The per-chunk best kept peak is therefore an
      unconditionally lossless candidate set of L/2 values; one top_k
      over it replaces the full-row sort (~2x less sort work) with no
      data-dependent fallback (a lax.cond fallback would stage its
      (B, L) operands every call).
      Tie order is preserved: the within-chunk reduction prefers the
      later lane, and stage 2 runs on the reversed candidate row.
    * segmented path (`_select_top_peaks_segmented`, always exact for
      arbitrary masks): kept for callers whose keep_mask does NOT come
      from local-maxima detection — pass non_adjacent=False.
    """
    B, L = scores.shape
    ok = peak_count >= num_events
    if L < 4 * num_events or L < 1024:
        neg_inf = jnp.asarray(-jnp.inf, scores.dtype)
        mrev = jnp.where(keep_mask, scores, neg_inf)[:, ::-1]
        _, idx = jax.lax.top_k(mrev, num_events)
        return (L - 1) - idx.astype(jnp.int32), ok

    if non_adjacent:
        return _select_top_peaks_chunkmax(
            scores, keep_mask, num_events, C=2
        ), ok
    return _select_top_peaks_segmented(scores, keep_mask, num_events), ok
