import numpy as np
import pytest
import jax.numpy as jnp

from warpdemux_tpu.detect.boundaries import detect_boundaries_batch, DetectConfig
from warpdemux_tpu.detect.containers import fail_code_to_reason
from tests.synth import synth_batch, synth_read


def test_synthetic_boundaries_recovered():
    rng = np.random.default_rng(0)
    sigs, lens, truths = synth_batch(rng, 24)
    res = detect_boundaries_batch(jnp.asarray(sigs), jnp.asarray(lens), DetectConfig())
    succ = np.asarray(res.success)
    assert succ.mean() > 0.9, fail_code_to_reason(np.asarray(res.fail_code))
    ps = np.asarray(res.polya_start)
    pe = np.asarray(res.polya_end)
    for b in range(len(truths)):
        if not succ[b]:
            continue
        assert abs(ps[b] - truths[b]["polya_start"]) < 150, (
            b, ps[b], truths[b]
        )
        want_pe = min(truths[b]["polya_end"], int(lens[b]))
        assert abs(pe[b] - want_pe) < 400, (b, pe[b], truths[b])


def test_region_stats_sane():
    rng = np.random.default_rng(1)
    sigs, lens, truths = synth_batch(rng, 8)
    res = detect_boundaries_batch(jnp.asarray(sigs), jnp.asarray(lens), DetectConfig())
    succ = np.asarray(res.success)
    for b in np.nonzero(succ)[0]:
        assert 60 < float(res.adapter_med[b]) < 90
        assert 95 < float(res.polya_med[b]) < 115
        assert float(res.polya_std[b]) < 10


def test_no_polya_fails():
    rng = np.random.default_rng(2)
    # pure adapter-like signal, no elevated flat region
    sig, _ = synth_read(rng, adapter_len=9500, polya_len=0, rna_len=0)
    sigs = np.zeros((2, 10000), np.float32)
    sigs[0, : sig.size] = sig[:10000]
    sigs[1] = 75.0  # flat at adapter level
    res = detect_boundaries_batch(
        jnp.asarray(sigs), jnp.asarray([10000, 10000], np.int32), DetectConfig()
    )
    assert not bool(res.success[0])
    assert not bool(res.success[1])
    reasons = fail_code_to_reason(np.asarray(res.fail_code))
    assert reasons[0] == "no polyA found"


def test_short_signal_fails():
    sigs = np.full((1, 10000), 80.0, np.float32)
    res = detect_boundaries_batch(
        jnp.asarray(sigs), jnp.asarray([500], np.int32), DetectConfig()
    )
    assert fail_code_to_reason(np.asarray(res.fail_code)) == ["signal too short"]


def test_adapter_length_gates():
    rng = np.random.default_rng(3)
    # adapter longer than max_obs_adapter
    sig, _ = synth_read(rng, adapter_len=7500, polya_len=2000, rna_len=500)
    sigs = sig[None, :10000].copy()
    res = detect_boundaries_batch(
        jnp.asarray(sigs), jnp.asarray([10000], np.int32), DetectConfig()
    )
    assert fail_code_to_reason(np.asarray(res.fail_code)) == ["adapter too long"]
    # adapter shorter than min_obs_adapter (but long enough that the
    # adapter-level proxy median is still dominated by adapter samples)
    sig2, _ = synth_read(rng, adapter_len=1500, polya_len=2500, rna_len=7000)
    res2 = detect_boundaries_batch(
        jnp.asarray(sig2[None, :10000].copy()),
        jnp.asarray([10000], np.int32),
        DetectConfig(),
    )
    assert fail_code_to_reason(np.asarray(res2.fail_code)) == ["adapter too short"]


def test_med_shift_and_real_range_checks():
    rng = np.random.default_rng(4)
    # real-range bounds are calibrated to real adapter statistics; keep the
    # synthetic adapter's level spread in that regime
    sigs, lens, truths = synth_batch(rng, 6, adapter_spread=8.0)
    cfg = DetectConfig(
        detect_med_shift=True, real_signal_check=True, mvs_detect_check=True
    )
    res = detect_boundaries_batch(jnp.asarray(sigs), jnp.asarray(lens), cfg)
    # synthetic reads are healthy: checks should mostly pass
    assert np.asarray(res.success).mean() > 0.8, fail_code_to_reason(
        np.asarray(res.fail_code)
    )


def test_summary_frame_columns():
    rng = np.random.default_rng(5)
    sigs, lens, _ = synth_batch(rng, 4)
    res = detect_boundaries_batch(jnp.asarray(sigs), jnp.asarray(lens), DetectConfig())
    df = res.to_summary_frame(
        [f"r{i}" for i in range(4)], np.full(4, 20000), np.asarray(lens)
    )
    for col in ["read_id", "adapter_start", "polya_mad", "rna_preloaded_len", "fail_reason"]:
        assert col in df


@pytest.mark.parametrize("w", [1, 150, 300, 2048])
def test_rolling_mean_var_matches_windowed_numpy(w):
    """Forward rolling mean/var over [t, min(t + w, L)) equal the direct
    float64 window statistics (the tail windows shrink at the row end)."""
    import jax.numpy as jnp
    from warpdemux_tpu.detect.boundaries import _rolling_mean_var_fwd

    rng = np.random.default_rng(31)
    B, L = 3, 1024
    x = rng.normal(80, 12, (B, L))
    mean, var = _rolling_mean_var_fwd(jnp.asarray(x), w)
    for t in (0, 1, L // 2, L - w // 2 - 1, L - 1):
        win = x[:, t : min(t + w, L)]
        np.testing.assert_allclose(np.asarray(mean)[:, t], win.mean(1), rtol=1e-9)
        np.testing.assert_allclose(
            np.asarray(var)[:, t], win.var(1), rtol=1e-6, atol=1e-8
        )


@pytest.mark.parametrize("w", [1, 100, 130])
def test_run_sum_counts_window_trues(w):
    """_run_sum is the exact count of True in mask[t : min(t + w, L))."""
    import jax.numpy as jnp
    from warpdemux_tpu.detect.boundaries import _run_sum

    rng = np.random.default_rng(w)
    B, L = 4, 700
    mask = rng.random((B, L)) < 0.4
    got = np.asarray(_run_sum(jnp.asarray(mask), w))
    want = np.stack(
        [[mask[b, t : t + w].sum() for t in range(L)] for b in range(B)]
    )
    np.testing.assert_array_equal(got, want)
