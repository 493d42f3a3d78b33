"""Live-balancing integration: dummy client through the full session loop."""

import numpy as np
import pandas as pd
import pytest

from warpdemux_tpu.detect.streaming import (
    StreamingConfig,
    mean_var_shift_polya_detect,
    real_range_check,
    RealRangeConfig,
)
from warpdemux_tpu.live.balancer import BalancerConfig, BarcodeBalancer, BarcodeBalancers
from warpdemux_tpu.live.caches import AccumulatingCache, LiveRead, ReadCache
from warpdemux_tpu.live.dummy import DummyClient, synth_live_read
from warpdemux_tpu.live.session import (
    ChannelRepeatedUnblockDuration,
    Session,
    SessionConfig,
)


def test_streaming_polya_detect():
    rng = np.random.default_rng(0)
    sig = synth_live_read(rng, adapter_len=4000, polya_len=2000)
    cfg = StreamingConfig()
    # not enough signal yet
    assert mean_var_shift_polya_detect(sig[:2000], cfg) == 0
    # with the polyA visible the detection should land near 4000
    loc = mean_var_shift_polya_detect(sig[:7000], cfg)
    assert abs(loc - 4000) < 400, loc


def test_real_range_check():
    rng = np.random.default_rng(1)
    sig = synth_live_read(rng, adapter_len=4000)
    assert real_range_check(sig[:4000], RealRangeConfig())
    assert not real_range_check(np.full(4000, 80.0), RealRangeConfig())


def test_caches():
    c = ReadCache(size=2)
    r = lambda ch, num: LiveRead(ch, f"id{ch}-{num}", num, np.zeros(10))
    c.set(1, r(1, 0))
    c.set(2, r(2, 0))
    c.set(3, r(3, 0))  # evicts channel 1
    assert len(c) == 2 and c.missed == 1

    a = AccumulatingCache(size=4, max_raw_signal=25)
    a.set(1, LiveRead(1, "x", 0, np.arange(10.0)))
    a.set(1, LiveRead(1, "x", 0, np.arange(10.0)))
    items = dict(a.pop_all())
    assert items[1].signal.size == 20
    a.set(1, LiveRead(1, "y", 1, np.arange(30.0)))
    a.set(1, LiveRead(1, "y", 1, np.arange(30.0)))
    items = dict(a.pop_all())
    assert items[1].signal.size == 25  # capped


def test_unblock_escalation():
    crud = ChannelRepeatedUnblockDuration(durations=(0.1, 0.5, 2.0), window_s=10)
    assert crud.duration(5) == 0.1
    assert crud.duration(5) == 0.5
    assert crud.duration(5) == 2.0
    assert crud.duration(5) == 2.0  # stays at max
    assert crud.duration(6) == 0.1  # other channels independent


def test_balancer_decision_rule():
    cfg = BalancerConfig(balance_type="adapter_count", balance_threshold=0.4, min_stat=5)
    b = BarcodeBalancer(4, cfg)
    # cold start: below min_stat -> accept everything
    assert b.decide(0)
    b.stats[:] = [20, 10, 10, 10]
    # mean 12.5; bc0: 20-12.5 = 7.5 > 0.4*12.5 -> reject
    assert not b.decide(0)
    assert b.decide(1)
    # blacklist and ignore
    cfg2 = BalancerConfig(balance_type="adapter_count", barcodes_blacklist=(2,),
                          barcodes_ignorelist=(3,))
    b2 = BarcodeBalancer(4, cfg2)
    assert not b2.decide(2)
    assert b2.decide(3)
    # per-barcode cap
    cfg3 = BalancerConfig(balance_type="adapter_count", max_stats={1: 5})
    b3 = BarcodeBalancer(4, cfg3)
    b3.stats[1] = 5
    assert not b3.decide(1)


def test_reject_all_and_none():
    assert BarcodeBalancer(4, BalancerConfig(balance_type="none")).decide(0)
    assert not BarcodeBalancer(4, BalancerConfig(balance_type="reject_all")).decide(0)


def test_dummy_session_end_to_end(tmp_path):
    from warpdemux_tpu.live.dummy import synth_barcoded_read
    from warpdemux_tpu.models.registry import load_model

    # Replay reads whose adapters embed actual support-vector fingerprints
    # so classification yields confident barcode calls (the reference's
    # dummy replays real barcoded signals).
    model = load_model("WDX4_rna004_v1_0")
    rng = np.random.default_rng(2)
    X_sv = np.asarray(model.X_sv)
    signals = [synth_barcoded_read(rng, X_sv[i]) for i in range(0, 240, 10)]

    client = DummyClient(n_reads=24, chunk_size=1500, seed=3, signals=signals)
    cfg = SessionConfig(
        model_name="WDX4_rna004_v1_0",
        save_path=str(tmp_path),
        run_id="test",
        check_real_range=False,
        max_batch=8,
    )
    balancers = BarcodeBalancers.from_configs(
        4, [BalancerConfig(balance_type="reject_all")], [1.0], n_channels=126
    )
    session = Session(client, cfg, balancers, model=model)
    session.run(batch_size=32)

    # every read got a decision (stop or unblock)
    assert len(client.stopped) + len(client.unblocked) > 0
    df = pd.read_csv(tmp_path / "barcode_balancing_test.csv")
    assert len(df) > 0
    # with reject_all, every *classified* read must have been unblocked
    classified = df[df.outcome == "classified"]
    assert len(classified) >= len(df) * 0.3, df.outcome.value_counts()
    assert (classified.decision == "reject").all()
    # and unblocked reads were recorded by the client
    assert len(client.unblocked) >= len(classified)
    stats = session.reporter.latency_stats()
    assert "classification" in stats


def test_live_config_parser(tmp_path):
    cfg_file = tmp_path / "live.toml"
    cfg_file.write_text(
        """
[model]
model_name = "WDX4_rna004_v1_0"
[flowcell]
flowcell_type = "flongle"
[[balancers]]
balance_type = "adapter_count"
balance_threshold = 0.3
channel_frac = 1.0
[balancing]
pred_conf_threshold = 0.25
[reporting]
save_path = "%s"
"""
        % tmp_path
    )
    from warpdemux_tpu.live.config_parser import parse_live_config

    scfg, bcfgs, fracs, n_channels = parse_live_config(cfg_file)
    assert scfg.pred_conf_threshold == 0.25
    assert n_channels == 126
    assert bcfgs[0].balance_type == "adapter_count"
    assert fracs == [1.0]


def test_missed_start_gate_uses_start_sample():
    """Reference semantics (session.py:287-312): the gate fires on
    chunk_start_sample - read start_sample (samples missed before the first
    captured chunk), NOT on the absolute chunk_start."""
    from warpdemux_tpu.live.caches import LiveRead
    from warpdemux_tpu.models.registry import load_model

    model = load_model("WDX4_rna004_v1_0")

    class _Client:
        is_running = False

        def __init__(self):
            self.stopped = []

        def stop_receiving_read(self, channel, read_number):
            self.stopped.append((channel, read_number))

    cfg = SessionConfig(
        model_name="WDX4_rna004_v1_0",
        save_path="/tmp",
        run_id="gate",
        max_missed_start_offset=400,
    )
    client = _Client()
    balancers = BarcodeBalancers.from_configs(
        4, [BalancerConfig(balance_type="none")], [1.0], n_channels=4
    )
    session = Session(client, cfg, balancers, model=model)

    sig = np.zeros(1200, np.float32)
    # read started long before the first captured chunk -> gate fires
    late = LiveRead(
        channel=1, read_id="late", read_number=1, signal=sig,
        chunk_start=5000, start_sample=1000,
    )
    session._handle_chunk(1, late)
    assert session.skip_stats["missed_reads"] == 1
    assert session.skip_stats["missed_obs_last"] == 4000
    assert client.stopped == [(1, 1)]

    # large absolute chunk_start but the read started inside the chunk
    # window -> NOT missed (the old chunk_start-only gate would fire)
    ok = LiveRead(
        channel=2, read_id="ok", read_number=2, signal=sig,
        chunk_start=5000, start_sample=4900,
    )
    session._handle_chunk(2, ok)
    assert session.skip_stats["missed_reads"] == 1
    assert session.skip_stats["missed_obs_last"] == 100
    assert client.stopped == [(1, 1)]


def test_negative_missed_obs_trims_leading_samples():
    """When the read starts INSIDE the first captured chunk (missed_obs < 0)
    the leading samples belong to the previous read / open pore and are
    trimmed before any processing (reference session.py:316-317,
    calibrated_signal[-missed_obs:])."""
    from warpdemux_tpu.live.caches import LiveRead
    from warpdemux_tpu.models.registry import load_model

    model = load_model("WDX4_rna004_v1_0")

    class _Client:
        is_running = False
        stopped = []

        def stop_receiving_read(self, channel, read_number):
            self.stopped.append((channel, read_number))

    cfg = SessionConfig(
        model_name="WDX4_rna004_v1_0", save_path="/tmp", run_id="trim",
        # gate configured so the (trimmed) chunk is too long -> deterministic
        # path that exposes which signal length the session acted on
        max_chunk_size=1000,
    )
    balancers = BarcodeBalancers.from_configs(
        4, [BalancerConfig(balance_type="none")], [1.0], n_channels=4
    )
    session = Session(_Client(), cfg, balancers, model=model)

    sig = np.zeros(1500, np.float32)
    # read started 600 samples into the chunk -> missed_obs = -600 and the
    # trimmed signal is 900 samples: NOT over max_chunk_size
    inside = LiveRead(
        channel=1, read_id="in", read_number=1, signal=sig,
        chunk_start=1000, start_sample=1600,
    )
    session._handle_chunk(1, inside)
    assert session.skip_stats["missed_obs_last"] == -600
    assert session.skip_stats["too_long_reads"] == 0

    # untrimmed read of the same physical size IS over max_chunk_size
    flush = LiveRead(
        channel=2, read_id="full", read_number=2, signal=sig,
        chunk_start=1000, start_sample=1000,
    )
    session._handle_chunk(2, flush)
    assert session.skip_stats["too_long_reads"] == 1


@pytest.mark.parametrize("max_batch", [4, 8])
def test_fingerprint_lane_reuses_bucket_program_at_any_fill(
    max_batch, tmp_path, caplog
):
    """A micro-batch filled to n reads runs the program its length bucket
    compiled for a one-read batch (what warmup() runs): cutting the padded
    outputs to n happens on the host, so no compile lands inside the
    decision-latency window."""
    import logging

    import jax

    from warpdemux_tpu.models.registry import load_model

    model = load_model("WDX4_rna004_v1_0")
    cfg = SessionConfig(
        model_name="WDX4_rna004_v1_0",
        save_path=str(tmp_path),
        run_id="fill",
        max_batch=max_batch,
    )
    balancers = BarcodeBalancers.from_configs(
        4, [BalancerConfig(balance_type="none")], [1.0], n_channels=4
    )
    session = Session(DummyClient(n_reads=1), cfg, balancers, model=model)
    rng = np.random.default_rng(11)

    def signals(n):
        return [rng.normal(80, 10, 1500 + 50 * i).astype(np.float32)
                for i in range(n)]

    session._fingerprint_batch(signals(1))
    caplog.clear()
    with jax.log_compiles(), caplog.at_level(logging.DEBUG):
        for n in range(2, max_batch + 1):
            fpts, ok = session._fingerprint_batch(signals(n))
            assert fpts.shape == (n, model.fingerprint_len)
            assert ok.shape == (n,)
    compiles = [r.getMessage() for r in caplog.records
                if "Compiling" in r.getMessage()]
    assert not compiles, compiles[:3]
