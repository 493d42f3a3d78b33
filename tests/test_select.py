"""Radix-select order statistics vs numpy (the sort-free median engine)."""

import numpy as np
import jax.numpy as jnp
import pytest

from warpdemux_tpu.ops.select import (
    grouped_median_mad,
    masked_median_select,
    masked_mad_select,
    order_keys,
    keys_to_float,
    range_median_mad,
)


def np_median(vals):
    return np.median(vals) if len(vals) else np.nan


def np_mad(vals):
    if not len(vals):
        return np.nan
    return np.median(np.abs(vals - np.median(vals)))


def test_order_keys_roundtrip_and_monotone():
    rng = np.random.default_rng(0)
    x = np.concatenate(
        [
            rng.normal(0, 100, 500).astype(np.float32),
            np.array([0.0, -0.0, 1e-38, -1e-38, 3e38, -3e38], np.float32),
        ]
    )
    k = np.asarray(order_keys(jnp.asarray(x)))
    back = np.asarray(keys_to_float(jnp.asarray(k)))
    # roundtrip is bit-exact
    assert (back.view(np.uint32) == x.view(np.uint32)).all()
    # sorting by key sorts by value (keys refine float order: -0.0 < +0.0)
    o_key = np.argsort(k.astype(np.int64), kind="stable")
    assert (np.diff(x[o_key]) >= 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_median_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    B, L = 16, 257
    x = rng.normal(0, 50, (B, L)).astype(np.float32)
    # inject duplicates and negatives
    x[:, ::7] = np.round(x[:, ::7])
    n = rng.integers(0, L + 1, B)
    mask = np.arange(L)[None, :] < n[:, None]
    med = np.asarray(masked_median_select(jnp.asarray(x), jnp.asarray(mask)))
    mad = np.asarray(masked_mad_select(jnp.asarray(x), jnp.asarray(mask)))
    for b in range(B):
        vals = x[b, : n[b]]
        np.testing.assert_equal(med[b], np.float32(np_median(vals)))
        np.testing.assert_equal(mad[b], np.float32(np_mad(vals)))


def test_masked_median_edge_cases():
    x = jnp.asarray(
        [
            [5.0, 0, 0, 0],
            [3.0, 1.0, 0, 0],
            [-1.0, -5.0, 2.0, 0],
            [-0.0, 0.0, 0, 0],
        ],
        jnp.float32,
    )
    mask = jnp.asarray(
        [
            [1, 0, 0, 0],
            [1, 1, 0, 0],
            [1, 1, 1, 0],
            [1, 1, 0, 0],
        ],
        bool,
    )
    med = np.asarray(masked_median_select(x, mask))
    assert med[0] == 5.0
    assert med[1] == 2.0
    assert med[2] == -1.0
    assert med[3] == 0.0
    # empty mask -> nan
    empty = np.asarray(
        masked_median_select(x, jnp.zeros_like(mask))
    )
    assert np.isnan(empty).all()


@pytest.mark.parametrize("with_mad", [True, False])
def test_grouped_and_range_median_mad(with_mad):
    rng = np.random.default_rng(3)
    B, L, R = 12, 300, 3
    x = rng.normal(70, 15, (B, L)).astype(np.float32)
    starts = rng.integers(0, L // 2, (R, B)).astype(np.int32)
    ends = starts + rng.integers(0, L // 2, (R, B)).astype(np.int32)
    pos = np.arange(L)[None, None, :]
    masks = (pos >= starts[..., None]) & (pos < ends[..., None])

    meds, mads = grouped_median_mad(
        jnp.asarray(x), jnp.asarray(masks), with_mad
    )
    meds2, mads2 = range_median_mad(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(ends), with_mad
    )
    for r in range(R):
        for b in range(B):
            vals = x[b, starts[r, b] : ends[r, b]]
            want = np.float32(np_median(vals))
            np.testing.assert_equal(np.asarray(meds)[r, b], want)
            np.testing.assert_equal(np.asarray(meds2)[r, b], want)
            if with_mad:
                wmad = np.float32(np_mad(vals))
                np.testing.assert_equal(np.asarray(mads)[r, b], wmad)
                np.testing.assert_equal(np.asarray(mads2)[r, b], wmad)


@pytest.mark.parametrize("region", ["full", "prefix", "middle", "empty"])
def test_range_median_mad_tie_heavy_matches_numpy(region):
    """Calibrated ADC signal (heavy ties, even counts) through the ranged
    engine: exact numpy medians and MADs for every region kind."""
    rng = np.random.default_rng(7)
    B, L = 16, 500
    adc = rng.integers(-32768, 32767, (B, L)).astype(np.int16)
    adc[:, :200] = rng.integers(-5, 5, (B, 200))  # heavy ties
    off = rng.uniform(-260, -200, B).astype(np.float32)
    s = rng.uniform(0.1, 0.3, B).astype(np.float32)
    x = (adc.astype(np.float32) + off[:, None]) * s[:, None]
    lo, hi = {
        "full": (np.zeros(B), np.full(B, L)),
        "prefix": (np.zeros(B), rng.integers(1, 250, B)),
        "middle": (rng.integers(0, L // 2, B), rng.integers(L // 2, L, B)),
        "empty": (np.full(B, 10), np.full(B, 10)),
    }[region]
    starts = lo.astype(np.int32)[None]
    ends = hi.astype(np.int32)[None]
    meds, mads = range_median_mad(
        jnp.asarray(x), jnp.asarray(starts), jnp.asarray(ends), True
    )
    for b in range(B):
        vals = x[b, starts[0, b] : ends[0, b]]
        np.testing.assert_equal(
            np.asarray(meds)[0, b], np.float32(np_median(vals))
        )
        np.testing.assert_equal(
            np.asarray(mads)[0, b], np.float32(np_mad(vals))
        )
