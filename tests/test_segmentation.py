import numpy as np
import pytest
import jax.numpy as jnp
from scipy.signal import find_peaks

from warpdemux_tpu.ops.segmentation import (
    windowed_t_test,
    segment_means,
    segment_signal_batch,
)


def ref_windowed_t_test(raw, w):
    """Direct re-statement of the reference Cython loop semantics
    (_c_segmentation.pyx:124-161) for golden comparison."""
    n = raw.shape[0] - 2 * w
    out = np.empty(n)
    for p in range(n):
        w1 = raw[p : p + w]
        w2 = raw[p + w : p + 2 * w]
        m1, m2 = w1.mean(), w2.mean()
        v = ((w1 - m1) ** 2).sum() + ((w2 - m2) ** 2).sum()
        out[p] = 0.0 if v == 0 else abs(m1 - m2) / np.sqrt(v)
    return out


def ref_segment_signal(raw, num_events, min_obs, w):
    """Reference segment_signal semantics (sig_proc.py:176-254)."""
    scores = ref_windowed_t_test(raw, w)
    peaks, _ = find_peaks(scores, distance=min_obs)
    if peaks.size < num_events:
        return None
    cpts = peaks[np.argsort(scores[peaks], kind="stable")[-num_events:]] + w
    cpts.sort()
    L = raw.size
    if cpts[0] != 0:
        cpts = np.insert(cpts, 0, 0)
    if cpts[-1] != L:
        cpts = np.append(cpts, L)
    dwell = np.diff(cpts)
    means = np.array(
        [raw[cpts[i] : cpts[i + 1]].mean() for i in range(len(cpts) - 1)]
    )
    return means, dwell, scores, cpts


def _make_signals(rng, B, L):
    # step-like squiggle: segments of ~20-60 samples with distinct levels
    x = np.empty((B, L))
    for b in range(B):
        levels = []
        while sum(len(s) for s in levels) < L:
            levels.append(np.full(rng.integers(15, 60), rng.normal(90, 15)))
        row = np.concatenate(levels)[:L]
        x[b] = row + rng.normal(0, 1.5, L)
    return x


def test_windowed_t_test_matches_reference():
    rng = np.random.default_rng(0)
    B, L = 6, 500
    x = _make_signals(rng, B, L)
    n = rng.integers(100, L + 1, size=B)
    w = rng.integers(2, 13, size=B)
    scores, n_scores = windowed_t_test(
        jnp.asarray(x), jnp.asarray(n, np.int32), jnp.asarray(w, np.int32), 12
    )
    scores = np.asarray(scores)
    for b in range(B):
        want = ref_windowed_t_test(x[b, : n[b]], int(w[b]))
        assert int(n_scores[b]) == want.size
        np.testing.assert_allclose(scores[b, : want.size], want, rtol=1e-9)


def test_windowed_t_test_zero_variance_windows():
    x = np.zeros((1, 60))
    x[0, 30:] = 5.0  # two constant halves: zero-variance windows everywhere
    scores, n_scores = windowed_t_test(
        jnp.asarray(x), jnp.asarray([60], np.int32), jnp.asarray([5], np.int32), 5
    )
    want = ref_windowed_t_test(x[0], 5)
    np.testing.assert_allclose(np.asarray(scores)[0, : want.size], want)


def test_segment_means():
    rng = np.random.default_rng(1)
    x = rng.normal(80, 10, size=(3, 120))
    bounds = np.array(
        [[0, 10, 30, 75, 120], [0, 5, 40, 90, 110], [0, 60, 61, 100, 118]],
        np.int32,
    )
    n = np.array([120, 110, 118], np.int32)
    got = np.asarray(segment_means(jnp.asarray(x), jnp.asarray(bounds), jnp.asarray(n)))
    for b in range(3):
        for e in range(4):
            want = x[b, bounds[b, e] : bounds[b, e + 1]].mean()
            assert np.isclose(got[b, e], want, rtol=1e-9)


def test_segment_signal_batch_matches_reference():
    rng = np.random.default_rng(2)
    B, L = 5, 2400
    x = _make_signals(rng, B, L)
    n = np.array([2400, 2000, 2200, 1800, 2400], np.int32)
    num_events, cfg_min_obs, cfg_w = 30, 6, 12
    means, dwell, ok, scores, n_scores, boundaries = segment_signal_batch(
        jnp.asarray(x), jnp.asarray(n), num_events, cfg_min_obs, cfg_w
    )
    means, dwell, ok = np.asarray(means), np.asarray(dwell), np.asarray(ok)
    for b in range(B):
        raw = x[b, : n[b]]
        mo = min(cfg_min_obs, int(round(raw.size / num_events / 2)))
        w = min(cfg_w, int(round(raw.size / num_events)))
        ref = ref_segment_signal(raw, num_events, mo, w)
        if ref is None:
            assert not ok[b]
            continue
        rmeans, rdwell, _, rcpts = ref
        assert ok[b]
        np.testing.assert_array_equal(np.asarray(boundaries)[b], rcpts)
        np.testing.assert_array_equal(dwell[b], rdwell)
        np.testing.assert_allclose(means[b], rmeans, rtol=1e-9)


def test_segment_signal_batch_fails_on_flat_signal():
    x = np.full((2, 800), 3.14)
    n = np.array([800, 800], np.int32)
    _, _, ok, _, _, _ = segment_signal_batch(jnp.asarray(x), jnp.asarray(n), 25, 6, 12)
    assert not bool(ok[0]) and not bool(ok[1])


@pytest.mark.parametrize("w", [4, 7, 12])
def test_windowed_t_test_matches_native_scores(w):
    """float64 batch t-test scores equal the reference C kernel's sliding
    scores (native/wdx_native.cpp) at every window width."""
    import jax.numpy as jnp
    from warpdemux_tpu import native
    from warpdemux_tpu.ops.segmentation import windowed_t_test

    rng = np.random.default_rng(23 + w)
    B, L, w_max = 4, 700, 12
    x = rng.normal(70, 12, (B, L))
    n = np.array([L, 650, 300, 2 * w + 1], np.int32)
    got, n_got = windowed_t_test(
        jnp.asarray(x), jnp.asarray(n), jnp.full(B, w, jnp.int32), w_max
    )
    got = np.asarray(got)
    for b in range(B):
        want = native.windowed_t_test(x[b, : n[b]], w)
        assert int(n_got[b]) == want.size
        np.testing.assert_allclose(got[b, : want.size], want, rtol=1e-7)
        assert not got[b, want.size :].any()
