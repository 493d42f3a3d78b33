"""Target-performance filtering: per-barcode calibrated confidence
thresholds at chosen precision targets.

The reference ships calibration tables (target_accuracy_thresholds/*.csv:
one row per barcode, one column per precision target 95.0..99.9) and
documents the workflow (README.md:351-369): group predictions by barcode,
apply the threshold for the desired target, demote below-threshold
predictions to -1 (unclassified). The in-model `thresholds` arrays are the
99%-precision operating point and are applied automatically at predict
time (ops/svm.process_probs); this module is the post-prediction surface
for other targets.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ASSET_DIR = Path(__file__).parent / "target_accuracy_thresholds"


@dataclass(frozen=True)
class Calibration:
    """Per-barcode confidence thresholds: one row per barcode, one column
    per precision target (95.0, 96.0, ... 99.9)."""

    barcodes: list[int]
    targets: list[float]
    table: np.ndarray  # (len(barcodes), len(targets))

    def threshold(self, barcode: int, target: float) -> float:
        return float(
            self.table[self.barcodes.index(barcode), self.targets.index(target)]
        )


def available_calibrations() -> list[str]:
    return sorted(p.stem for p in ASSET_DIR.glob("*.csv"))


def load_calibration(name: str) -> Calibration:
    """Load a calibration table (true_barcode column, then one column per
    target named like 99_9)."""
    path = ASSET_DIR / f"{name}.csv"
    if not path.exists():
        raise FileNotFoundError(
            f"calibration {name!r} not found; available: "
            f"{available_calibrations()}"
        )
    with open(path, newline="") as fh:
        header, *rows = list(csv.reader(fh))
    return Calibration(
        barcodes=[int(r[0]) for r in rows],
        targets=[float(c.replace("_", ".")) for c in header[1:]],
        table=np.array([[float(v) for v in r[1:]] for r in rows]),
    )


def calibration_for_model(model_name: str) -> Calibration:
    """Find the calibration asset for a model (prefix match on the
    registry naming scheme, e.g. WDX4_rna004_v1_0 ->
    WDX4_rna004__3_4_5_7@v0.4.4)."""
    base = model_name.rsplit("_v", 1)[0]
    for name in available_calibrations():
        if name.startswith(base):
            return load_calibration(name)
    raise FileNotFoundError(
        f"no calibration table for model {model_name!r}; available: "
        f"{available_calibrations()}"
    )


def thresholds_at(calibration: Calibration, target: float) -> dict[int, float]:
    """Per-barcode thresholds for a precision target (exact column match)."""
    if target not in calibration.targets:
        raise KeyError(
            f"target {target} not calibrated; available: "
            f"{calibration.targets}"
        )
    return {bc: calibration.threshold(bc, target) for bc in calibration.barcodes}


def apply_target_performance(
    pred: np.ndarray,
    conf: np.ndarray,
    thresholds: dict[int, float],
) -> np.ndarray:
    """Demote predictions whose confidence is below the per-barcode
    threshold to -1 (README.md:365-369). Barcodes without a calibrated
    threshold are left untouched."""
    pred = np.asarray(pred).copy()
    conf = np.asarray(conf)
    for bc, thr in thresholds.items():
        pred[(pred == bc) & (conf < thr)] = -1
    return pred


def filter_predictions_df(df: dict, model_name: str, target: float) -> dict:
    """Apply target-performance filtering to a predictions table (an
    io.writers Frame, as written to csv.gz by the demux/predict pipelines);
    returns a new table."""
    thr = thresholds_at(calibration_for_model(model_name), target)
    out = dict(df)
    out["predicted_barcode"] = apply_target_performance(
        np.asarray(df["predicted_barcode"]),
        np.asarray(df["confidence_score"], float),
        thr,
    )
    return out
