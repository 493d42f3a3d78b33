"""Sharded output writers matching the reference's file contract.

Output layout (reference warpdemux/config/file_proc.py:19-49,
file_proc.py:633-780):
  <run>/predictions/barcode_predictions_<bidx>.csv.gz   (#read_id first col)
  <run>/failed_reads/failed_reads_<bidx>.csv.gz
  <run>/boundaries/detected_boundaries_<bidx>.csv.gz
  <run>/fingerprints/barcode_fpts_<bidx>.npz            (num_reads, read_ids,
                                                         signals[, dwell_times])

Tables are `Frame`s: insertion-ordered {column name: 1-D array}. The csv
text is the reference's pandas `to_csv(index=False)` text: floats in their
shortest round-trip form for their own width, NaN as an empty field,
booleans as True/False.
"""

from __future__ import annotations

import csv
import gzip
from pathlib import Path

import numpy as np

Frame = dict  # {column name: 1-D array}, in column order

# Boundary/failed-read summary columns (the reference's ADAPTed
# save_detected_boundaries contract, README.md:425-457).
BOUNDARY_COLUMNS = [
    "read_id",
    "signal_len",
    "preloaded",
    "adapter_start",
    "adapter_end",
    "adapter_len",
    "adapter_mean",
    "adapter_std",
    "adapter_med",
    "adapter_mad",
    "polya_start",
    "polya_end",
    "polya_len",
    "polya_mean",
    "polya_std",
    "polya_med",
    "polya_mad",
    "polya_candidates",
    "rna_preloaded_start",
    "rna_preloaded_len",
    "rna_preloaded_mean",
    "rna_preloaded_std",
    "rna_preloaded_med",
    "rna_preloaded_mad",
    "adapter_dt_med",
    "adapter_dt_mad",
    "adapter_event_mean",
    "adapter_event_std",
    "adapter_event_med",
    "adapter_event_mad",
]


def frame_len(frame: Frame) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def frame_take(frame: Frame, rows) -> Frame:
    """Rows of a frame by boolean mask, index array or slice."""
    return {k: np.asarray(v)[rows] for k, v in frame.items()}


def frame_concat(frames: list[Frame]) -> Frame:
    return {
        k: np.concatenate([np.asarray(f[k]) for f in frames])
        for k in frames[0]
    }


def _cell_formatter(col: np.ndarray):
    if col.dtype.kind == "f":
        return lambda v: "" if v != v else str(v)
    if col.dtype.kind == "b":
        return lambda v: "True" if v else "False"
    return str


def write_csv_gz(path: str | Path, frame: Frame) -> Path:
    """Write a frame as gzip-compressed csv (header row, no index)."""
    cols = [np.asarray(v) for v in frame.values()]
    fmts = [_cell_formatter(c) for c in cols]
    with gzip.open(path, "wt", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(frame.keys())
        for i in range(frame_len(frame)):
            w.writerow([f(c[i]) for f, c in zip(fmts, cols)])
    return Path(path)


def read_csv_gz(path: str | Path) -> Frame:
    """Columns of a csv(.gz) file as lists of strings."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        return {}
    return {name: [r[i] for r in rows[1:]] for i, name in enumerate(rows[0])}


def save_predictions(
    df: Frame, out_dir: str | Path, bidx: int, tag: str = ""
) -> Path:
    path = Path(out_dir) / f"barcode_predictions_{tag}{bidx}.csv.gz"
    return write_csv_gz(path, df)


def save_boundaries(
    rows: Frame,
    out_dir: str | Path,
    bidx: int,
    failed: bool = False,
    tag: str = "",
) -> Path:
    name = "failed_reads" if failed else "detected_boundaries"
    path = Path(out_dir) / f"{name}_{tag}{bidx}.csv.gz"
    return write_csv_gz(path, rows)


def save_fingerprints(
    read_ids: np.ndarray,
    fpts: np.ndarray,
    out_dir: str | Path,
    bidx: int,
    dwell_times: np.ndarray | None = None,
    tag: str = "",
) -> Path:
    path = Path(out_dir) / f"barcode_fpts_{tag}{bidx}.npz"
    arrays = dict(
        num_reads=len(read_ids),
        read_ids=np.asarray(read_ids),
        signals=np.asarray(fpts),
    )
    if dwell_times is not None:
        arrays["dwell_times"] = np.asarray(dwell_times)
    np.savez(path, **arrays)
    return path
