"""Resume support: scan a previous run's outputs into an exclude set and the
next shard indices (reference file_proc.py:128-185 scan_processed_reads /
handle_previous_results)."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from warpdemux_tpu.io.writers import read_csv_gz


def _max_bidx(files: list[Path], pattern: str) -> int:
    mx = -1
    for f in files:
        m = re.match(pattern, f.name)
        if m:
            mx = max(mx, int(m.group(1)))
    return mx


def scan_processed_reads(run_dir: str, result_type: str = "predictions"):
    """Returns (processed_ids: set, next_bidx_pass, next_bidx_fail,
    next_bidx_predict)."""
    run = Path(run_dir)
    processed: set[str] = set()

    pred_files = sorted((run / "predictions").glob("barcode_predictions_*.csv.gz"))
    fail_files = sorted((run / "failed_reads").glob("failed_reads_*.csv.gz"))
    fpt_files = sorted((run / "fingerprints").glob("barcode_fpts_*.npz"))
    bound_files = sorted(
        (run / "boundaries").glob("detected_boundaries_*.csv.gz")
    )

    if result_type == "predictions":
        for f in pred_files:
            df = read_csv_gz(f)
            col = "#read_id" if "#read_id" in df else "read_id"
            processed.update(df.get(col, []))
    else:
        for f in fpt_files:
            with np.load(f, allow_pickle=True) as z:
                processed.update(str(r) for r in z["read_ids"])
    for f in fail_files:
        processed.update(read_csv_gz(f).get("read_id", []))

    bidx_pass = (
        max(
            _max_bidx(bound_files, r"detected_boundaries_(?:h\d+_)?(\d+)\.csv\.gz"),
            _max_bidx(fpt_files, r"barcode_fpts_(?:h\d+_)?(\d+)\.npz"),
        )
        + 1
    )
    bidx_fail = _max_bidx(fail_files, r"failed_reads_(?:h\d+_)?(\d+)\.csv\.gz") + 1
    bidx_predict = _max_bidx(pred_files, r"barcode_predictions_(?:h\d+_)?(\d+)\.csv\.gz") + 1
    return processed, bidx_pass, bidx_fail, bidx_predict
