"""The fused DTW kernel (ops/dtw_triton.py) in interpret mode on the CPU
against the float64 numpy reference and the plain jnp scan."""

import numpy as np
import jax.numpy as jnp
import pytest

from warpdemux_tpu.ops.dtw import dtw_distance_matrix, dtw_distance_matrix_ref
from warpdemux_tpu.ops.dtw_triton import (
    dtw_distance_matrix_kernel,
    dtw_distance_matrix_triton,
)


def _kernel(X, Y, window=15, penalty=0.1, **kw):
    return np.asarray(
        dtw_distance_matrix_triton(
            jnp.asarray(X), jnp.asarray(Y), window, penalty, interpret=True, **kw
        )
    )


@pytest.mark.parametrize("B,N", [(5, 9), (1, 1), (16, 64)])
def test_pallas_matches_reference_small(B, N):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(B, 25)).astype(np.float32)
    Y = rng.normal(size=(N, 25)).astype(np.float32)
    want = dtw_distance_matrix_ref(X.astype(np.float64), Y.astype(np.float64), 15, 0.1)
    np.testing.assert_allclose(_kernel(X, Y), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize(
    "B,N,b_tile,n_tile",
    [(19, 300, 16, 64), (33, 130, 8, 32), (7, 65, 4, 128)],
)
def test_pallas_matches_reference_tiled(B, N, b_tile, n_tile):
    """Ragged B and N that need padding on both axes, several tiles."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(B, 25)).astype(np.float32)
    Y = rng.normal(size=(N, 25)).astype(np.float32)
    want = dtw_distance_matrix_ref(X.astype(np.float64), Y.astype(np.float64), 15, 0.1)
    got = _kernel(X, Y, b_tile=b_tile, n_tile=n_tile)
    assert got.shape == (B, N)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize(
    "window,penalty", [(1, 0.0), (5, 0.5), (15, 0.1), (25, 1.5), (40, 0.1)]
)
def test_pallas_window_and_penalty_variants(window, penalty):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(4, 25)).astype(np.float32)
    Y = rng.normal(size=(17, 25)).astype(np.float32)
    want = dtw_distance_matrix_ref(
        X.astype(np.float64), Y.astype(np.float64), window, penalty
    )
    got = _kernel(X, Y, window, penalty)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    # same float32 arithmetic in the same order as the plain scan
    np.testing.assert_array_equal(
        got, np.asarray(dtw_distance_matrix(X, Y, window, penalty))
    )


@pytest.mark.parametrize("m", [8, 25, 32])
def test_kernel_entry_point_other_fingerprint_lengths(m):
    """The pipeline's entry point (interpreted on the CPU) at fingerprint
    lengths below, at and on the padded row count."""
    rng = np.random.default_rng(m)
    X = rng.normal(size=(6, m)).astype(np.float32)
    Y = rng.normal(size=(11, m)).astype(np.float32)
    got = np.asarray(dtw_distance_matrix_kernel(jnp.asarray(X), jnp.asarray(Y), 15, 0.1))
    want = dtw_distance_matrix_ref(X.astype(np.float64), Y.astype(np.float64), 15, 0.1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
