"""Tests for the native C++ host kernels (warpdemux_tpu/native): VBZ codec
round-trips and parity with the numpy inner layout, plus the live-lane
scan kernels vs goldens."""

import numpy as np
import pytest

from warpdemux_tpu import native
from warpdemux_tpu.io import vbz

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_vbz_roundtrip_native():
    rng = np.random.default_rng(0)
    sig = np.cumsum(rng.integers(-40, 40, size=5000)).astype(np.int16)
    payload = native.vbz_encode(sig)
    out = native.vbz_decode(payload, sig.size)
    np.testing.assert_array_equal(out, sig)


def test_vbz_native_matches_numpy_codec():
    """The native codec's inner layout (keys || data under zstd) equals the
    numpy reference layout, and the codec round-trips, at every length
    class (partial key byte, one wide sample, many)."""
    from warpdemux_tpu.ops.vbz_device import inner_layout_from_adc

    rng = np.random.default_rng(1)
    for n in (1, 7, 100, 9999):
        sig = np.cumsum(rng.integers(-200, 200, size=n)).astype(np.int16)
        payload = vbz.encode(sig)
        raw = native.zstd_decompress(payload, 4 * n + 16)
        assert raw == inner_layout_from_adc(sig)
        np.testing.assert_array_equal(vbz.decode(payload, n), sig)


def test_windowed_t_test_matches_jax_kernel():
    import jax.numpy as jnp

    from warpdemux_tpu.ops.segmentation import windowed_t_test as jt

    rng = np.random.default_rng(2)
    x = rng.normal(80, 10, size=3000)
    w = 12
    nat = native.windowed_t_test(x, w)
    scores, n_scores = jt(
        jnp.asarray(x[None], jnp.float64),
        jnp.array([x.size], jnp.int32),
        jnp.array([w], jnp.int32),
        w,
    )
    ref = np.asarray(scores)[0, : int(n_scores[0])]
    assert nat.size == ref.size
    np.testing.assert_allclose(nat, ref, rtol=1e-9, atol=1e-12)


def test_segment_means_matches_numpy():
    rng = np.random.default_rng(3)
    x = rng.normal(size=1000)
    cpts = np.array([0, 100, 340, 720, 1000], np.int64)
    nat = native.segment_means(x, cpts)
    ref = np.array(
        [x[a:b].mean() for a, b in zip(cpts[:-1], cpts[1:])]
    )
    np.testing.assert_allclose(nat, ref, rtol=1e-12)


def test_mvs_scan_finds_polya_onset():
    rng = np.random.default_rng(4)
    adapter = rng.normal(75, 8, size=3000).astype(np.float32)
    polya = (104 + rng.normal(0, 1.0, 1200)).astype(np.float32)
    x = np.concatenate([adapter, polya])
    t = native.mvs_scan(x, 200, thr_mean=100.0, thr_var=9.0)
    # first full window inside the polyA: around 3000 + 200
    assert 3000 <= t <= 3450, t
    # no hit on pure adapter
    assert native.mvs_scan(adapter, 200, 100.0, 9.0) == -1
