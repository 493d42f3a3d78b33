"""Live balancing entry point.

Usage (mirrors the reference's live_balancing entry / dummy harness,
entry_point.py:26-52 and dummy.py debug_test):

  python -m warpdemux_tpu.live.entry_point --config_file live.toml [--dummy]

With --dummy (or when no MinKNOW connection is available) the session runs
against the synthetic replay client. A real MinKNOW connection requires the
`minknow_api` package (gRPC), loaded lazily.
"""

from __future__ import annotations

import argparse
import sys


def run(argv=None):
    """Parse the command line, run the session to its end, and return it
    (None when no MinKNOW connection is available)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--dummy", action="store_true",
                    help="replay synthetic reads instead of MinKNOW")
    ap.add_argument("--n_reads", type=int, default=200)
    ap.add_argument("--jax-platform", default=None)
    args = ap.parse_args(argv)

    import jax

    if args.jax_platform:
        jax.config.update("jax_platforms", args.jax_platform)

    from warpdemux_tpu.live.config_parser import build_session

    client = None
    if args.dummy:
        from warpdemux_tpu.live.dummy import DummyClient

        client = DummyClient(n_reads=args.n_reads)
    else:
        # real MinKNOW: gRPC transport + accumulating client with the
        # reference's construction parameters (entry_point.py:26-37:
        # one_chunk=False, AccumulatingCache(5120), calibrated signal,
        # prefilter_classes={'adapter'})
        from warpdemux_tpu.live.caches import AccumulatingCache
        from warpdemux_tpu.live.read_until import (
            ReadUntilClient,
            minknow_transport,
        )

        try:
            transport = minknow_transport()
        except RuntimeError as e:
            print(f"{e}; run with --dummy for the replay harness",
                  file=sys.stderr)
            return None
        client = ReadUntilClient(
            transport,
            cache=AccumulatingCache(size=5120),
            one_chunk=False,
            filter_strands=True,
            prefilter_classes={"adapter"},
            calibrated_signal=True,
        )
        client.run()

    session = build_session(args.config_file, client=client)
    session.run()
    return session


def main(argv=None):
    session = run(argv)
    if session is None:
        return 2
    print("skip stats:", session.skip_stats)
    print("counters:", session.reporter.counters.summary())
    print("latency:", {
        k: f"{m*1000:.1f}+/-{s*1000:.1f}ms"
        for k, (m, s) in session.reporter.latency_stats().items()
    })
    tot = session.reporter.latency_percentiles().get("total")
    if tot:
        print(
            f"decision latency p50 {tot['p50'] * 1e3:.2f} ms, "
            f"p99 {tot['p99'] * 1e3:.2f} ms over {tot['n']} decisions"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
