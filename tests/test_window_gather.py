import numpy as np
import jax.numpy as jnp
import pytest

from warpdemux_tpu.ops.window_gather import shift_rows


def test_shift_rows_auto_cpu_path():
    rng = np.random.default_rng(1)
    B, L, A = 5, 300, 64
    x = rng.normal(size=(B, L)).astype(np.float32)
    starts = rng.integers(0, L - A + 1, size=B).astype(np.int32)
    got = np.asarray(shift_rows(jnp.asarray(x), jnp.asarray(starts), A))
    for b in range(B):
        np.testing.assert_array_equal(got[b], x[b, starts[b] : starts[b] + A])


@pytest.mark.parametrize("start", [-5, 0, 250, 299, 400])
def test_shift_rows_clamps_out_of_range_indices(start):
    """Indices past either end of the row read the nearest edge sample."""
    x = np.arange(3 * 300, dtype=np.float32).reshape(3, 300)
    A = 32
    got = np.asarray(
        shift_rows(jnp.asarray(x), jnp.full(3, start, jnp.int32), A)
    )
    idx = np.clip(start + np.arange(A), 0, 299)
    np.testing.assert_array_equal(got, x[:, idx])
