"""Tests for the target-performance filtering subsystem
(models/target_accuracy.py; reference README.md:351-369 +
target_accuracy_thresholds/WDX4_rna004__3_4_5_7@v0.4.4.csv)."""

import numpy as np
import pytest

from warpdemux_tpu.models import target_accuracy as ta


def test_calibration_loads_and_matches_reference_values():
    cal = ta.load_calibration("WDX4_rna004__3_4_5_7@v0.4.4")
    assert cal.barcodes == [3, 4, 5, 7]
    assert 99.0 in cal.targets and 99.9 in cal.targets
    assert cal.threshold(3, 99.0) == 0.17
    assert cal.threshold(7, 99.9) == 0.99


def test_calibration_for_model_prefix_match():
    cal = ta.calibration_for_model("WDX4_rna004_v1_0")
    assert cal.barcodes == [3, 4, 5, 7]
    with pytest.raises(FileNotFoundError):
        ta.calibration_for_model("WDX99_nope_v1_0")


def test_apply_target_performance():
    pred = np.array([3, 4, 5, 7, 3, -1])
    conf = np.array([0.5, 0.1, 0.9, 0.46, 0.1, 0.99])
    thr = ta.thresholds_at(
        ta.load_calibration("WDX4_rna004__3_4_5_7@v0.4.4"), 99.0
    )
    out = ta.apply_target_performance(pred, conf, thr)
    # 3@0.5 >= 0.17 keep; 4@0.1 < 0.28 -> -1; 5@0.9 keep;
    # 7@0.46 < 0.47 -> -1; 3@0.1 < 0.17 -> -1; -1 untouched
    np.testing.assert_array_equal(out, [3, -1, 5, -1, -1, -1])
    # original untouched
    assert pred[1] == 4


def test_filter_predictions_df():
    df = {
        "#read_id": ["a", "b"],
        "predicted_barcode": [7, 7],
        "confidence_score": [0.99, 0.5],
    }
    out = ta.filter_predictions_df(df, "WDX4_rna004_v1_0", 99.9)
    assert list(out["predicted_barcode"]) == [7, -1]


def test_unknown_target_raises():
    cal = ta.load_calibration("WDX4_rna004__3_4_5_7@v0.4.4")
    with pytest.raises(KeyError):
        ta.thresholds_at(cal, 42.0)
