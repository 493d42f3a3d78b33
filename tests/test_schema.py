"""Packed-output schema: one layout table both sides read (VERDICT r2 #6).

The round-trip test guarantees the device-side pack and host-side unpack
can never drift: both iterate pipeline/schema.PackSchema's spec."""

import numpy as np
import pytest


def test_schema_roundtrip_every_column():
    from warpdemux_tpu.pipeline.schema import (
        FLOAT_COLS, INT_COLS, PackSchema,
    )
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    B, k, kc = 16, 25, 5
    schema = PackSchema(k=k, kc=kc)

    int_vals = {c: rng.integers(0, 10000, B).astype(np.int32) for c in INT_COLS}
    int_vals["dwell"] = rng.integers(0, 300, (B, k)).astype(np.int32)
    float_vals = {c: rng.normal(size=B).astype(np.float32) for c in FLOAT_COLS}
    float_vals["fpt"] = rng.normal(size=(B, k)).astype(np.float32)
    float_vals["probs"] = rng.normal(size=(B, kc)).astype(np.float32)

    big_i = np.asarray(
        schema.pack({c: jnp.asarray(v) for c, v in int_vals.items()}, jnp.int32)
    )
    big_f = np.asarray(
        schema.pack(
            {c: jnp.asarray(v) for c, v in float_vals.items()}, jnp.float32
        )
    )
    assert big_i.shape == (B, schema.int_width)
    assert big_f.shape == (B, schema.float_width)

    # width-derived schema recovery must agree
    rec = PackSchema.from_buffers(big_i, big_f)
    assert (rec.k, rec.kc) == (k, kc)

    out_i = rec.unpack(big_i, np.int32)
    out_f = rec.unpack(big_f, np.float32)
    for c, v in int_vals.items():
        np.testing.assert_array_equal(out_i[c], v, err_msg=c)
    for c, v in float_vals.items():
        np.testing.assert_array_equal(out_f[c], v, err_msg=c)


def test_schema_rejects_wrong_widths():
    from warpdemux_tpu.pipeline.schema import PackSchema
    import jax.numpy as jnp

    schema = PackSchema(k=25, kc=5)
    with pytest.raises(ValueError):
        schema.unpack(np.zeros((4, schema.int_width + 1), np.int32), np.int32)
    bad = {"adapter_start": jnp.zeros((4, 2), jnp.int32)}
    with pytest.raises((ValueError, KeyError)):
        schema.pack(bad, jnp.int32)


def test_summary_frame_has_per_method_columns():
    """Boundary/failed tables expose llr_*/{primary}_*/mvs_* results
    (reference README.md:443-446) when the detect pass recorded them."""
    import jax.numpy as jnp

    from warpdemux_tpu.detect.boundaries import (
        DetectConfig, detect_boundaries_with_fallback,
    )

    rng = np.random.default_rng(0)
    B, L = 4, 8000
    sig = np.concatenate(
        [
            rng.normal(75, 9, 3000),   # adapter
            rng.normal(105, 2, 1500),  # polyA
            rng.normal(90, 7, 3500),   # RNA
        ]
    ).astype(np.float32)
    sigs = np.tile(sig, (B, 1))
    lens = np.full(B, L, np.int32)
    cfg = DetectConfig(method="llr", fallback_to_llr=False)
    res = detect_boundaries_with_fallback(
        jnp.asarray(sigs), jnp.asarray(lens), cfg
    )
    df = res.to_summary_frame(
        [f"r{i}" for i in range(B)], np.full(B, L), lens,
        primary_method="llr",
    )
    for col in [
        "llr_adapter_start", "llr_adapter_end", "llr_polya_start",
        "llr_polya_end", "llr_fail_reason", "mvs_med_shift",
        "mvs_min_polya_var",
    ]:
        assert col in df, col
    # llr IS the primary: per-method results equal the final boundaries
    np.testing.assert_array_equal(df["llr_polya_start"], df["polya_start"])
    # mvs values are real measurements on these boundaries
    assert (df["mvs_med_shift"] > 5.0).all()
    assert (df["mvs_min_polya_var"] < 30.0).all()
