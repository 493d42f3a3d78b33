"""Live-lane latency measurement (VERDICT r1 item 8).

Runs the dummy client (real-shaped barcoded reads, 126 channels) through
the full live session on the default backend and prints per-stage
p50/p90/p99 latencies. The decision budget for adaptive sampling is one
MinKNOW chunk period — 100 ms with the shipped protocol fragment
(minknow_config/RNA2_seq_WDX_live_100ms.toml analog; reference
live_balancing/reporting.py:505-535 reports mean+/-std only).

Usage: python tools/live_latency.py [--reads 400]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from warpdemux_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()

import numpy as np


BUDGET_S = 0.100  # one MinKNOW chunk period


def measure(reads, channels, max_batch, batch_wait, save):
    """Run the paced dummy session; returns (per-stage percentiles, wall s)."""
    from warpdemux_tpu.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu.live.dummy import DummyClient, synth_barcoded_read
    from warpdemux_tpu.live.session import Session, SessionConfig
    from warpdemux_tpu.models.registry import load_model

    model = load_model("WDX4_rna004_v1_0")
    rng = np.random.default_rng(5)
    X_sv = np.asarray(model.X_sv)
    signals = [
        synth_barcoded_read(rng, X_sv[rng.integers(0, len(X_sv))])
        for _ in range(48)
    ]
    client = DummyClient(
        n_reads=reads, chunk_size=1500, seed=7, signals=signals,
        n_channels=channels,
        chunk_period_s=0.1,  # MinKNOW 100 ms chunk cadence
        stagger_s=4.0,  # molecules enter pores at random times
    )
    cfg = SessionConfig(
        model_name="WDX4_rna004_v1_0",
        save_path=save,
        run_id="latency",
        check_real_range=False,
        max_batch=max_batch,
        batch_wait_s=batch_wait,
    )
    balancers = BarcodeBalancers.from_configs(
        4, [BalancerConfig(balance_type="read_count")], [1.0], n_channels=126
    )
    session = Session(client, cfg, balancers, model=model)
    t0 = time.time()
    session.run(batch_size=64)
    return session.reporter.latency_percentiles(), time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=400)
    ap.add_argument("--save", default="traces/live_latency")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--batch-wait", type=float, default=0.005)
    ap.add_argument("--channels", type=int, default=126,
                    help="active channel count")
    ap.add_argument(
        "--assert-budget", action="store_true",
        help="exit nonzero unless p99 total latency < one chunk period",
    )
    args = ap.parse_args()

    import jax

    pct, wall = measure(
        args.reads, args.channels, args.max_batch, args.batch_wait, args.save
    )
    print(
        f"# backend={jax.default_backend()} reads={args.reads} "
        f"channels={args.channels} wall={wall:.1f}s"
    )
    print("| stage | n | p50 ms | p90 ms | p99 ms | max ms |")
    print("|---|---|---|---|---|---|")
    for stage, s in pct.items():
        print(
            f"| {stage} | {s['n']} | {s['p50']*1e3:.1f} | {s['p90']*1e3:.1f}"
            f" | {s['p99']*1e3:.1f} | {s['max']*1e3:.1f} |"
        )
    tot = pct.get("total")
    if tot:
        verdict = "PASS" if tot["p99"] < BUDGET_S else "FAIL"
        print(
            f"# p99 decision latency {tot['p99']*1e3:.1f} ms vs one 100 ms "
            f"chunk period: {verdict}"
        )
        if args.assert_budget and verdict == "FAIL":
            sys.exit(1)


if __name__ == "__main__":
    main()
