"""The reference-differential parity harness (tools/parity_vs_reference.py).

The upstream environment cannot be installed in this container (no
egress; dtaidistance/cython absent), so the full differential run is
skip-gated on WDX_REFERENCE_PYTHON. The diff logic itself — the part
that turns two run dirs into the parity verdict — is fully exercised
here on synthetic run dirs, and the env probe must degrade gracefully.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

from parity_vs_reference import (  # noqa: E402
    check_reference_env,
    diff_runs,
)


def _write_run(
    root: Path,
    preds: list[tuple[str, int, float]],
    fails: list[tuple[str, str]],
    rid_col: str = "#read_id",
):
    (root / "predictions").mkdir(parents=True)
    (root / "failed_reads").mkdir(parents=True)
    df = pd.DataFrame(
        preds, columns=[rid_col, "predicted_barcode", "confidence_score"]
    )
    df["p03"] = 0.5
    df.to_csv(
        root / "predictions" / "barcode_predictions_0.csv.gz",
        index=False,
        compression="gzip",
    )
    pd.DataFrame(fails, columns=["read_id", "fail_reason"]).to_csv(
        root / "failed_reads" / "failed_reads_0.csv.gz",
        index=False,
        compression="gzip",
    )


def test_diff_runs_identical(tmp_path):
    preds = [("r1", 3, 0.9), ("r2", -1, 0.1), ("r3", 7, 0.55)]
    fails = [("r4", "adapter too long")]
    _write_run(tmp_path / "a", preds, fails)
    _write_run(tmp_path / "b", preds, fails)
    rep = diff_runs(str(tmp_path / "a"), str(tmp_path / "b"))
    assert rep["n_compared"] == 3
    assert rep["barcode_agreement"] == 1.0
    assert rep["conf_max_abs_delta"] == 0.0
    assert rep["prob_max_abs_delta"] == 0.0
    assert rep["pass_only_in_ref"] == []
    assert rep["fail_reason_crosstab"] == {
        "adapter too long -> adapter too long": 1
    }


def test_diff_runs_disagreement(tmp_path):
    _write_run(
        tmp_path / "a",
        [("r1", 3, 0.9), ("r2", -1, 0.1), ("r5", 4, 0.8)],
        [("r4", "no polyA found")],
    )
    _write_run(
        tmp_path / "b",
        [("r1", 5, 0.87), ("r2", -1, 0.1)],
        [("r4", "adapter too long"), ("r5", "mvs polya check failed")],
        rid_col="read_id",  # column-name tolerance
    )
    rep = diff_runs(str(tmp_path / "a"), str(tmp_path / "b"))
    assert rep["n_compared"] == 2
    assert rep["barcode_agreement"] == 0.5
    assert rep["barcode_disagreements"] == [
        {"read_id": "r1", "ref": 3, "ours": 5, "ref_conf": 0.9,
         "ours_conf": 0.87}
    ]
    assert rep["pass_only_in_ref"] == ["r5"]
    assert rep["fail_reason_crosstab"] == {
        "no polyA found -> adapter too long": 1
    }
    assert abs(rep["conf_max_abs_delta"] - 0.03) < 1e-12


def test_check_reference_env_degrades_gracefully():
    """This container has no reference env: the probe must say so (and
    never raise) so the CLI exits 3 with a pointer at the env pins."""
    ok, msg = check_reference_env(sys.executable, "/root/reference")
    assert ok is False
    assert msg  # carries the import error for the operator


def test_harness_cli_diff_only(tmp_path):
    preds = [("r1", 3, 0.9)]
    _write_run(tmp_path / "a", preds, [])
    _write_run(tmp_path / "b", preds, [])
    out = subprocess.run(
        [
            sys.executable,
            str(
                Path(__file__).resolve().parents[1]
                / "tools"
                / "parity_vs_reference.py"
            ),
            "--diff-only",
            str(tmp_path / "a"),
            str(tmp_path / "b"),
        ],
        capture_output=True,
        text=True,
    )
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["barcode_agreement"] == 1.0


@pytest.mark.skipif(
    not os.environ.get("WDX_REFERENCE_PYTHON"),
    reason="reference (WDX conda) env not available in this container; "
    "set WDX_REFERENCE_PYTHON to its interpreter to run the full "
    "differential (env pins: /root/reference/environment.yml:1-24)",
)
def test_full_parity_vs_reference(tmp_path):
    from parity_vs_reference import main

    rc = main(
        [
            "--pod5",
            "/root/reference/test_data/live_balancing/small_pod5_0.pod5",
            "--workdir",
            str(tmp_path),
            "--reference-python",
            os.environ["WDX_REFERENCE_PYTHON"],
        ]
    )
    assert rc == 0  # bit-identical barcode assignments
