import numpy as np
import pytest
import jax.numpy as jnp
from scipy.signal import find_peaks

from warpdemux_tpu.ops.peaks import (
    find_peaks_batch,
    peak_mask_batch,
    select_top_peaks,
)


def _run_find_peaks(signals, n_valid, distance):
    signals = np.asarray(signals, np.float64)
    mask, cnt = find_peaks_batch(
        jnp.asarray(signals),
        jnp.asarray(n_valid, np.int32),
        jnp.asarray(distance, np.int32),
    )
    mask, cnt = np.asarray(mask), np.asarray(cnt)
    pos = [np.nonzero(mask[b])[0] for b in range(mask.shape[0])]
    return pos, cnt


def test_simple_peaks_match_scipy():
    rng = np.random.default_rng(0)
    B, L = 16, 200
    x = rng.normal(size=(B, L))
    pos, cnt = _run_find_peaks(x, np.full(B, L), np.full(B, 5))
    for b in range(B):
        want, _ = find_peaks(x[b], distance=5)
        np.testing.assert_array_equal(pos[b], want)
        assert cnt[b] == len(want)


def test_local_maxima_plateaus_match_scipy():
    rng = np.random.default_rng(4)
    B, L = 12, 300
    x = np.empty((B, L))
    for b in range(B):
        row = []
        while sum(len(r) for r in row) < L:
            row.append(np.full(rng.integers(1, 6), rng.normal()))
        x[b] = np.concatenate(row)[:L]
    mask, cnt = peak_mask_batch(
        jnp.asarray(x), jnp.full((B,), L, jnp.int32)
    )
    from scipy.signal._peak_finding_utils import _local_maxima_1d

    for b in range(B):
        want = _local_maxima_1d(x[b])[0]
        np.testing.assert_array_equal(np.nonzero(np.asarray(mask)[b])[0], want)


def test_plateau_peaks_match_scipy():
    # Plateaus (runs of exactly equal values) with *unique* levels so the
    # scipy-vs-deterministic tie-order caveat doesn't apply.
    rng = np.random.default_rng(1)
    B, L = 16, 300
    x = np.empty((B, L))
    for b in range(B):
        row = []
        while sum(len(r) for r in row) < L:
            row.append(np.full(rng.integers(1, 6), rng.normal()))
        x[b] = np.concatenate(row)[:L]
    for dist in (1, 2, 7, 15):
        pos, cnt = _run_find_peaks(x, np.full(B, L), np.full(B, dist))
        for b in range(B):
            want, _ = find_peaks(x[b], distance=dist)
            np.testing.assert_array_equal(pos[b], want)


def test_masked_lengths_match_scipy():
    rng = np.random.default_rng(2)
    B, L = 12, 256
    x = rng.normal(size=(B, L))
    n = rng.integers(10, L + 1, size=B)
    d = rng.integers(1, 12, size=B)
    pos, cnt = _run_find_peaks(x, n, d)
    for b in range(B):
        want, _ = find_peaks(x[b, : n[b]], distance=int(d[b]))
        np.testing.assert_array_equal(pos[b], want)


def test_near_tie_priority_matches_scipy():
    B, L = 1, 64
    x = np.zeros((B, L))
    x[0, [5, 8, 11, 20, 23]] = [1.0, 1.0 + 1e-9, 1.0 - 1e-9, 1.0 + 2e-9, 1.0]
    pos, cnt = _run_find_peaks(x, np.array([L]), np.array([4]))
    want, _ = find_peaks(x[0], distance=4)
    np.testing.assert_array_equal(pos[0], want)


def test_exact_ties_are_deterministic():
    # On exact ties our later-position-first order is the contract:
    # 11 is processed first and suppresses 8; 5 survives (|11-5| >= 4).
    B, L = 1, 64
    x = np.zeros((B, L))
    x[0, [5, 8, 11]] = 1.0
    pos, cnt = _run_find_peaks(x, np.array([L]), np.array([4]))
    np.testing.assert_array_equal(pos[0], [5, 11])


def test_select_top_peaks_tie_behavior():
    # np.argsort(scores[peaks])[-k:]: ties prefer the later peak.
    scores = np.zeros((1, 50))
    keep = np.zeros((1, 50), bool)
    keep[0, [5, 10, 15, 20]] = True
    scores[0, [5, 10, 15, 20]] = [2.0, 1.0, 1.0, 3.0]
    sel, ok = select_top_peaks(
        jnp.asarray(scores), jnp.asarray(keep), jnp.asarray([4], np.int32), 3
    )
    assert bool(ok[0])
    want = {20, 5, 15}  # 3.0, 2.0, then the tie at 1.0 -> later position 15
    assert set(np.asarray(sel[0]).tolist()) == want


def test_random_stress_vs_scipy():
    rng = np.random.default_rng(3)
    for trial in range(5):
        B, L = 8, 400
        x = rng.normal(size=(B, L)).cumsum(axis=1)
        n = rng.integers(50, L + 1, size=B)
        d = rng.integers(1, 18, size=B)
        pos, cnt = _run_find_peaks(x, n, d)
        for b in range(B):
            want, _ = find_peaks(x[b, : n[b]], distance=int(d[b]))
            np.testing.assert_array_equal(pos[b], want)


def test_select_top_peaks_two_stage_matches_single_stage():
    """The segmented two-stage top-k (non_adjacent=False: the exact path
    for arbitrary masks, which may hold adjacent kept positions) must
    reproduce the single-stage selection exactly, including tie order
    (later position first), on rows long enough to trigger it."""
    import jax
    import jax.numpy as jnp
    from warpdemux_tpu.ops.peaks import select_top_peaks

    rng = np.random.default_rng(7)
    B, L, k = 16, 6200, 110
    # quantized scores force plenty of exact ties across segments
    scores = np.round(rng.gamma(2.0, 2.0, (B, L)) * 4) / 4
    keep = rng.random((B, L)) < 0.15
    counts = keep.sum(axis=1).astype(np.int32)
    assert (counts >= k).all()

    sel, ok = select_top_peaks(
        jnp.asarray(scores, jnp.float32), jnp.asarray(keep),
        jnp.asarray(counts), k, non_adjacent=False,
    )
    assert bool(ok.all())

    # single-stage reference: top_k on the reversed masked row
    mrev = jnp.where(jnp.asarray(keep), jnp.asarray(scores, jnp.float32), -jnp.inf)[:, ::-1]
    _, idx = jax.lax.top_k(mrev, k)
    want = (L - 1) - np.asarray(idx, np.int32)
    np.testing.assert_array_equal(np.asarray(sel), want)


def _suppress_greedy_np(scores, is_peak, distance):
    """scipy _select_by_peak_distance: visit peaks by (score, position)
    priority, later position winning ties; a kept peak removes every other
    peak strictly within `distance`."""
    peaks = np.flatnonzero(is_peak)
    order = sorted(peaks, key=lambda p: (scores[p], p), reverse=True)
    keep = np.zeros(scores.shape, bool)
    dead = set()
    for p in order:
        if p in dead:
            continue
        keep[p] = True
        dead.update(q for q in peaks if q != p and abs(q - p) < distance)
    return keep


@pytest.mark.parametrize("tie_rows", [False, True])
def test_suppress_by_distance_matches_sequential_greedy(tie_rows):
    """The parallel priority-MIS fixpoint reproduces the sequential greedy
    suppression exactly, including tie order on quantized scores."""
    import jax.numpy as jnp
    from warpdemux_tpu.ops.peaks import peak_mask_batch, suppress_by_distance

    rng = np.random.default_rng(11)
    B, L = 8, 600
    scores = np.abs(rng.normal(0, 3, (B, L))).astype(np.float32)
    if tie_rows:
        scores = np.round(scores * 2) / 2
    n = np.full(B, L, np.int32)
    n[5] = 300
    is_peak, _ = peak_mask_batch(jnp.asarray(scores), jnp.asarray(n))
    dist = rng.integers(1, 8, B).astype(np.int32)
    got = np.asarray(
        suppress_by_distance(jnp.asarray(scores), is_peak, jnp.asarray(dist), 8)
    )
    is_peak = np.asarray(is_peak)
    for b in range(B):
        want = _suppress_greedy_np(scores[b], is_peak[b], int(dist[b]))
        np.testing.assert_array_equal(got[b], want)


def test_select_top_peaks_chunkmax_matches_single_stage():
    """Sparse kept peaks (>= 4 apart, no width-4 chunk collisions) take the
    chunk-max fast path; its selection must reproduce the single-stage
    top_k exactly, including tie order (quantized scores force ties)."""
    import jax
    import jax.numpy as jnp
    from warpdemux_tpu.ops.peaks import select_top_peaks

    rng = np.random.default_rng(11)
    B, L, k = 16, 6200, 110
    scores = np.round(rng.gamma(2.0, 2.0, (B, L)) * 4) / 4
    # kept peaks on a stride-6 lattice with per-row jitter: >= 6 apart
    keep = np.zeros((B, L), bool)
    for b in range(B):
        p = np.arange(3, L - 3, 6) + rng.integers(0, 2)
        p = p[rng.random(p.size) < 0.35]
        keep[b, p] = True
    counts = keep.sum(axis=1).astype(np.int32)
    assert (counts >= k).all()
    # no collisions -> the fast path is the one being tested
    assert (keep.reshape(B, -1, 4).sum(axis=2) < 2).all()

    sel, ok = select_top_peaks(
        jnp.asarray(scores, jnp.float32),
        jnp.asarray(keep),
        jnp.asarray(counts),
        k,
    )
    assert bool(ok.all())
    mrev = jnp.where(
        jnp.asarray(keep), jnp.asarray(scores, jnp.float32), -jnp.inf
    )[:, ::-1]
    _, idx = jax.lax.top_k(mrev, k)
    want = (L - 1) - np.asarray(idx, np.int32)
    np.testing.assert_array_equal(np.asarray(sel), want)


def test_select_top_peaks_distance2_pair_survives():
    """A pair of kept peaks 2 apart (the tightest spacing local maxima
    allow) lands in different width-2 chunks, so the unconditional
    chunk-max path keeps both — the case the old width-4 design needed a
    data-driven segmented fallback for."""
    import jax.numpy as jnp
    from warpdemux_tpu.ops.peaks import select_top_peaks

    rng = np.random.default_rng(13)
    B, L, k = 4, 6200, 110
    scores = rng.gamma(2.0, 2.0, (B, L))
    keep = np.zeros((B, L), bool)
    for b in range(B):
        keep[b, np.arange(3, L - 3, 6)] = True
    # the colliding pair: positions 4 and 6 share chunk [4..7]
    keep[0, :9] = False
    keep[0, [4, 6]] = True
    # make both colliding peaks top-scoring so dropping one is observable
    scores[0, 4] = scores.max() + 2.0
    scores[0, 6] = scores.max() + 1.0
    counts = keep.sum(axis=1).astype(np.int32)

    sel, ok = select_top_peaks(
        jnp.asarray(scores, jnp.float32),
        jnp.asarray(keep),
        jnp.asarray(counts),
        k,
    )
    assert bool(ok.all())
    got = set(np.asarray(sel)[0].tolist())
    assert {4, 6} <= got


def test_plateau_run_lengths_match_scipy():
    """Plateau handling across run-length regimes: rows whose plateau runs
    are all length <= 3, and rows with runs >= 4, both through the (single)
    cummax plateau path, checked against scipy find_peaks. (A bounded
    shifted-compare fast path for short runs was evaluated and rejected as
    slower — see ops/peaks.py — so both populations exercise the same
    branch; this test keeps the short-run population covered regardless.)"""
    rng = np.random.default_rng(17)
    B, L = 6, 300

    def check(x):
        n = np.full(B, L, np.int64)
        d = np.full(B, 1, np.int64)
        pos, cnt = _run_find_peaks(x, n, d)
        for b in range(B):
            want, _ = find_peaks(x[b], distance=1)
            np.testing.assert_array_equal(pos[b], want)

    # runs of length <= 3: quantize then break up any longer run
    x = np.round(rng.normal(size=(B, L)) * 3) / 3
    for b in range(B):
        run = 1
        for p in range(1, L):
            run = run + 1 if x[b, p] == x[b, p - 1] else 1
            if run > 3:
                x[b, p] += 0.5
                run = 1
    assert not any(
        (x[b, p] == x[b, p + 1] == x[b, p + 2] == x[b, p + 3])
        for b in range(B)
        for p in range(L - 3)
    )
    check(x)

    # coarse quantization: plenty of runs >= 4 (fallback branch)
    y = np.round(rng.normal(size=(B, L)))
    assert any(
        (y[b, p] == y[b, p + 1] == y[b, p + 2] == y[b, p + 3])
        for b in range(B)
        for p in range(L - 3)
    )
    check(y)


def test_select_top_peaks_segmented_for_adjacent_masks():
    """Arbitrary (non-local-maxima) masks CAN hold adjacent kept
    positions; non_adjacent=False must route to the always-exact
    segmented path and keep both members of an adjacent top-scoring
    pair."""
    import jax
    import jax.numpy as jnp
    from warpdemux_tpu.ops.peaks import select_top_peaks

    rng = np.random.default_rng(23)
    B, L, k = 4, 6200, 110
    scores = rng.gamma(2.0, 2.0, (B, L))
    keep = np.zeros((B, L), bool)
    for b in range(B):
        keep[b, np.arange(3, L - 3, 6)] = True
    keep[0, [40, 41]] = True  # adjacent pair, impossible for find_peaks
    scores[0, 40] = scores.max() + 2.0
    scores[0, 41] = scores.max() + 1.0
    counts = keep.sum(axis=1).astype(np.int32)
    sel, ok = select_top_peaks(
        jnp.asarray(scores, jnp.float32),
        jnp.asarray(keep),
        jnp.asarray(counts),
        k,
        non_adjacent=False,
    )
    assert bool(ok.all())
    got = set(np.asarray(sel)[0].tolist())
    assert {40, 41} <= got
    # and the exact selection matches single-stage top_k on every row
    mrev = jnp.where(
        jnp.asarray(keep), jnp.asarray(scores, jnp.float32), -jnp.inf
    )[:, ::-1]
    _, idx = jax.lax.top_k(mrev, k)
    want = (L - 1) - np.asarray(idx, np.int32)
    np.testing.assert_array_equal(np.sort(np.asarray(sel)), np.sort(want))
