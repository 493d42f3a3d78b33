"""Live-lane soak (VERDICT r3 next #7): >=10k reads through the dummy
session in one process, asserting flat memory (latency reservoirs, CRUD
map, fingerprint queue, RSS) and end-of-run report completeness.

Runs tools/live_soak.py as a subprocess so RSS reflects the live lane
alone, not the rest of the test session. The latency-budget story on
real hardware lives in STATUS.md (tools/live_latency.py); this test pins
the structural guarantees that hold on any backend.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.slow
def test_live_soak_memory_flat_and_reports_complete():
    out = subprocess.run(
        [
            sys.executable,
            str(REPO / "tools" / "live_soak.py"),
            "--reads",
            "12000",
        ],
        capture_output=True,
        text=True,
        timeout=1200,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])

    # every read reached a decision and a CSV row
    assert rep["reads"] == 12000
    assert rep["decided"] == 12000
    assert rep["csv_rows"] == 12000

    # report completeness: per-stage latency percentiles, balancer stats
    # time series, skip stats with every reference-parity counter
    assert {"segmentation", "classification", "total"} <= set(
        rep["latency_stages"]
    )
    assert rep["balancer_stats_files"]
    for key in (
        "missed_reads",
        "too_long_reads",
        "not_real_read",
        "no_polya_yet",
        "missed_obs_n",
    ):
        assert key in rep["skip_stats"]

    # memory flatness: every run-length-scaling structure is bounded
    assert rep["lat_samples_final"] <= rep["latency_reservoir_cap"] * len(
        rep["latency_stages"]
    )
    assert rep["crud_channels_final"] <= 126
    # RSS past the 1/3 point (compiles done) must be near-flat: < 15%
    # growth while the second 2/3 of the reads stream through
    growth = rep["rss_mb_final"] / rep["rss_mb_third"] - 1.0
    assert growth < 0.15, (rep["rss_mb_third"], rep["rss_mb_final"])


@pytest.mark.gpu
def test_live_decision_budget_on_device(tmp_path):
    """p99 decision latency within one 100 ms MinKNOW chunk period: the
    paced dummy replay (tools/live_latency.py, 120 reads on 24 channels)
    through the live session on the card, in this process."""
    sys.path.insert(0, str(REPO / "tools"))
    import live_latency

    pct, _ = live_latency.measure(
        reads=120, channels=24, max_batch=16, batch_wait=0.005,
        save=str(tmp_path),
    )
    assert pct["total"]["n"] > 0
    assert pct["total"]["p99"] < live_latency.BUDGET_S, pct
