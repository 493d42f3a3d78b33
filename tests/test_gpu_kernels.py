"""The fused DTW kernel as Triton compiles it for the card (not the
interpreter), against the plain XLA scan, at ragged shapes that need
padding on both axes. Runs on an NVIDIA GPU only (`gpu` marker)."""

import functools

import numpy as np
import pytest

from warpdemux_tpu.models.registry import load_model


@pytest.mark.gpu
def test_dtw_kernel_compiled_matches_xla_scan_ragged():
    import jax
    import jax.numpy as jnp

    from warpdemux_tpu.ops.dtw import dtw_distance_matrix
    from warpdemux_tpu.ops.dtw_triton import dtw_distance_matrix_triton

    model = load_model("WDX4_rna004_v1_0")
    Y = np.asarray(model.X_sv, np.float32)[:843]  # N not a tile multiple
    rng = np.random.default_rng(3)
    X = Y[rng.integers(0, len(Y), 37)] + rng.normal(0, 0.3, (37, 25)).astype(
        np.float32
    )
    kw = dict(window=model.window, penalty=model.penalty)
    got = np.asarray(
        jax.jit(functools.partial(dtw_distance_matrix_triton, **kw))(
            jnp.asarray(X), jnp.asarray(Y)
        )
    )
    want = np.asarray(dtw_distance_matrix(jnp.asarray(X), jnp.asarray(Y), **kw))
    assert got.shape == (37, 843)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
