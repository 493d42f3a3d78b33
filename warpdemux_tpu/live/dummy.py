"""Dummy live client: full-session integration harness without a sequencer.

Capability parity with the reference's DummyClient/DummySession
(warpdemux/live_balancing/dummy.py:27-128) — the de-facto integration test of
the live path. Replays synthetic barcode-structured reads through the client
interface (get_read_chunks / stop_receiving_read / unblock_read /
is_running), delivering the signal chunk-by-chunk so the session's
accumulation + streaming polyA gates are exercised, and records every action
for assertions.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field

import numpy as np

from warpdemux_tpu.live.caches import LiveRead


def synth_live_read(rng, adapter_len=None, polya_len=None, rna_len=20000):
    """Synthetic RNA004-style squiggle (adapter + polyA + RNA)."""
    adapter_len = adapter_len or int(rng.integers(2500, 5500))
    polya_len = polya_len or int(rng.integers(800, 2500))

    def events(total, level, spread):
        seg = []
        while sum(map(len, seg)) < total:
            seg.append(
                np.full(int(rng.integers(15, 60)), level + rng.normal(0, spread))
            )
        return np.concatenate(seg)[:total]

    parts = [
        events(adapter_len, 78.0, 8.0),
        np.full(polya_len, 104.0) + rng.normal(0, 1.0, polya_len),
        events(rna_len, 96.0, 13.0),
    ]
    sig = np.concatenate(parts).astype(np.float32)
    sig += rng.normal(0, 1.8, sig.size).astype(np.float32)
    return sig


def synth_barcoded_read(
    rng,
    sv_fpt: np.ndarray,
    num_events: int = 111,
    samples_per_event: int = 40,
    polya_len: int = 1500,
    rna_len: int = 15000,
    level: float = 78.0,
    spread: float = 8.0,
    noise: float = 1.2,
):
    """Synthetic read whose adapter's last-25-event fingerprint approximates
    a given (normalized) fingerprint, so the classifier produces a
    confident barcode call on replay.

    `noise` is the within-event pore noise sigma in pA; the real fixture
    reads measure 1.76-1.91 pA (MAD of adapter first differences,
    tests/test_demux_accuracy_e2e.py), the 1.2 default predates that
    measurement and is kept for the existing replay fixtures."""
    k = len(sv_fpt)
    ev = rng.normal(level, spread, size=num_events)
    ev[-k:] = level + spread * np.asarray(sv_fpt)
    adapter = np.repeat(ev, samples_per_event)
    parts = [
        adapter,
        np.full(polya_len, level * 1.35) + rng.normal(0, 1.0, polya_len),
        np.repeat(
            rng.normal(96.0, 13.0, size=rna_len // samples_per_event + 1),
            samples_per_event,
        )[:rna_len],
    ]
    sig = np.concatenate(parts).astype(np.float32)
    sig += rng.normal(0, noise, sig.size).astype(np.float32)
    return sig


@dataclass
class _ActiveRead:
    read_id: str
    read_number: int
    channel: int
    signal: np.ndarray
    delivered: int = 0
    done: bool = False
    last_delivery: float = 0.0


class DummyClient:
    """Replays reads chunk-by-chunk through the read-until interface."""

    def __init__(
        self,
        n_reads: int = 100,
        chunk_size: int = 1200,
        n_channels: int = 126,
        seed: int = 0,
        signals: list[np.ndarray] | None = None,
        chunk_period_s: float = 0.0,
        stagger_s: float = 0.0,
    ):
        # chunk_period_s > 0 paces delivery like a real sequencer (MinKNOW
        # emits one chunk per break_reads_after_seconds, 100 ms with the
        # shipped protocol fragment) so measured latencies reflect lane
        # latency rather than replay backlog; 0 = as-fast-as-polled.
        # stagger_s spreads read starts uniformly over that window, like
        # molecules entering pores at random times (without it every
        # channel hits the polyA decision point in the same chunk tick).
        rng = np.random.default_rng(seed)
        self._reads: list[_ActiveRead] = []
        for i in range(n_reads):
            sig = (
                signals[i % len(signals)]
                if signals
                else synth_live_read(rng)
            )
            self._reads.append(
                _ActiveRead(
                    read_id=str(uuid.UUID(bytes=rng.bytes(16))),
                    read_number=i,
                    channel=int(rng.integers(1, n_channels + 1)),
                    signal=np.asarray(sig, np.float32),
                    last_delivery=float(rng.uniform(0, stagger_s))
                    if stagger_s
                    else 0.0,
                )
            )
        self.chunk_size = chunk_size
        self.chunk_period_s = chunk_period_s
        self._t0 = None  # set on the first poll (after session warm-up)
        self._lock = threading.Lock()
        self.stopped: dict[str, int] = {}
        self.unblocked: dict[str, float] = {}
        self._cursor = 0
        self._by_key: dict | None = None

    @property
    def is_running(self) -> bool:
        with self._lock:
            return any(not r.done for r in self._reads)

    def get_read_chunks(self, batch_size=64, min_chunk_length=0):
        out = []
        now = time.time()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            active = [r for r in self._reads if not r.done]
            for r in active[:batch_size]:
                if self.chunk_period_s and r.delivered == 0 and r.last_delivery:
                    # staggered start: last_delivery holds the start offset
                    if now < self._t0 + r.last_delivery:
                        continue
                if (
                    self.chunk_period_s
                    and r.delivered
                    and now - r.last_delivery < self.chunk_period_s
                ):
                    continue
                r.last_delivery = now
                r.delivered = min(r.delivered + self.chunk_size, r.signal.size)
                if r.delivered >= r.signal.size:
                    r.done = True  # read passed through the pore untouched
                chunk = r.signal[: r.delivered]
                if chunk.size < min_chunk_length:
                    continue
                out.append(
                    (
                        r.channel,
                        LiveRead(
                            channel=r.channel,
                            read_id=r.read_id,
                            read_number=r.read_number,
                            signal=chunk,
                            chunk_start=0,
                        ),
                    )
                )
        return out

    def _find(self, channel, read_number):
        if self._by_key is None:  # built lazily: reads list is final then
            self._by_key = {
                (r.channel, r.read_number): r for r in self._reads
            }
        return self._by_key.get((channel, read_number))

    def stop_receiving_read(self, channel, read_number):
        """Stop streaming further chunks (MinKNOW still allows a later
        unblock of the same read — the molecule is still in the pore)."""
        with self._lock:
            r = self._find(channel, read_number)
            if r is not None:
                r.done = True
                if r.read_id not in self.unblocked:
                    self.stopped[r.read_id] = read_number

    def unblock_read(self, channel, read_number, duration=0.1):
        with self._lock:
            r = self._find(channel, read_number)
            if r is not None:
                r.done = True
                self.stopped.pop(r.read_id, None)
                self.unblocked[r.read_id] = duration


def debug_test(n_reads: int = 120, save_path: str = "/tmp/wdx_live_debug"):
    """Run a full session per balancing strategy against the replay client
    (the reference's de-facto live integration test, dummy.py:113-178).

    Usage: python -m warpdemux_tpu.live.dummy [n_reads]
    """
    import dataclasses

    from warpdemux_tpu.live.balancer import BalancerConfig, BarcodeBalancers
    from warpdemux_tpu.live.session import Session, SessionConfig
    from warpdemux_tpu.models.registry import load_model

    model = load_model("WDX4_rna004_v1_0")
    strategies = ["none", "reject_all", "adapter_count", "read_count",
                  "base_normalization"]
    for strat in strategies:
        client = DummyClient(n_reads=n_reads)
        bal_cfg = BalancerConfig(
            balance_type=strat, balance_threshold=0.3, min_stat=2.0
        )
        balancers = BarcodeBalancers.from_configs(
            model.n_classes - 1, [bal_cfg], [1.0], n_channels=126
        )
        scfg = SessionConfig(
            model_name="WDX4_rna004_v1_0",
            save_path=save_path,
            run_id=f"debug_{strat}",
        )
        session = Session(client, scfg, balancers, model=model)
        session.run(batch_size=32)
        c = session.reporter.counters.summary()
        print(f"{strat:<20} accept={c['accept']} reject={c['reject']}")


if __name__ == "__main__":
    import sys as _sys

    n = next((int(a) for a in _sys.argv[1:] if a.isdigit()), 120)
    debug_test(n)
