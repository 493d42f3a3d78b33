"""Banded DTW distance matrices with dtaidistance-2.3.13 semantics.

This is the hot kernel of offline demultiplexing: every read fingerprint
(length 25) is compared against the model's full reference fingerprint set
(851-2601 rows) with `dtw.distance_matrix(..., window=15, penalty=0.1)`
(reference: warpdemux/parallel_distances.py:34-84, models/dtw_svm.py:79-90).

dtaidistance 2.3.13 `dtw.distance` semantics reproduced here:
- local cost d(i,j) = (s1[i] - s2[j])**2
- the penalty argument is squared internally and added to the two
  non-diagonal transitions:
      D[i+1, j+1] = d(i,j) + min(D[i, j], D[i, j+1] + p, D[i+1, j] + p)
  with boundary D[0,0] = 0 and +inf elsewhere (psi = 0).
- Sakoe-Chiba band: j in [max(0, i - max(0, r-c) - w + 1),
                          min(c, i + max(0, c-r) + w))   (half-open)
  i.e. for equal lengths |i - j| <= w - 1.
- result = sqrt(D[r, c]).

This is the plain version: an anti-diagonal wavefront in which all (B x N)
25x25 lattices advance one diagonal per `lax.scan` step, states held as
(B, N, m) element-wise arrays; 2m-1 steps total. `dtw_triton.py` fuses the
same recurrence into one kernel that the pipeline runs; this module is the
reference it is checked against, plus the numpy scalar golden reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def dtw_distance_ref(
    s1: np.ndarray, s2: np.ndarray, window: int, penalty: float
) -> float:
    """Scalar golden-reference banded DTW (numpy, float64)."""
    r, c = len(s1), len(s2)
    p = penalty * penalty
    D = np.full((r + 1, c + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(r):
        j_start = max(0, i - max(0, r - c) - window + 1)
        j_end = min(c, i + max(0, c - r) + window)
        for j in range(j_start, j_end):
            d = (s1[i] - s2[j]) ** 2
            D[i + 1, j + 1] = d + min(
                D[i, j], D[i, j + 1] + p, D[i + 1, j] + p
            )
    return float(np.sqrt(D[r, c]))


def dtw_distance_matrix_ref(
    X: np.ndarray, Y: np.ndarray, window: int, penalty: float
) -> np.ndarray:
    """Golden-reference cross distance matrix (numpy, slow)."""
    out = np.empty((X.shape[0], Y.shape[0]), np.float64)
    for i in range(X.shape[0]):
        for j in range(Y.shape[0]):
            out[i, j] = dtw_distance_ref(X[i], Y[j], window, penalty)
    return out


@functools.partial(jax.jit, static_argnames=("window", "penalty"))
def dtw_distance_matrix(
    X: jnp.ndarray, Y: jnp.ndarray, window: int = 15, penalty: float = 0.1
) -> jnp.ndarray:
    """Cross DTW distance matrix, anti-diagonal wavefront over (B, N) lattices.

    Args:
      X: (B, m) query fingerprints.
      Y: (N, m) reference fingerprints (same length m).
      window: Sakoe-Chiba window (dtaidistance convention: |i-j| <= window-1).
      penalty: off-diagonal transition penalty (squared internally).

    Returns:
      (B, N) float distances.
    """
    B, m = X.shape
    N, m2 = Y.shape
    assert m == m2, "query and reference fingerprints must have equal length"
    dtype = jnp.result_type(X.dtype, Y.dtype)
    p = jnp.asarray(penalty * penalty, dtype)
    inf = jnp.asarray(jnp.inf, dtype)

    iarr = jnp.arange(m, dtype=jnp.int32)  # cell index along a diagonal == i
    band_ok_fn = lambda j: jnp.abs(iarr - j) <= (window - 1)

    Xb = X.astype(dtype)[:, None, :]  # (B, 1, m) — q[i] per diagonal cell
    Yb = Y.astype(dtype)  # (N, m)

    def cost(k):
        # d(i, k-i) over cells i; gather Y at j = k - i, mask invalid.
        j = k - iarr  # (m,)
        j_ok = (j >= 0) & (j < m)
        jc = jnp.clip(j, 0, m - 1)
        yk = Yb[:, jc]  # (N, m)
        d = (Xb - yk[None, :, :]) ** 2  # (B, N, m)
        valid = j_ok & band_ok_fn(jc) & (iarr <= jnp.minimum(k, m - 1))
        return d, valid

    def shift_i(a):
        # a[..., i-1] with +inf shifted into i=0.
        return jnp.concatenate(
            [jnp.full(a.shape[:-1] + (1,), inf, dtype), a[..., :-1]], axis=-1
        )

    def step(carry, k):
        d2, d1 = carry  # diagonals k-2, k-1: (B, N, m)
        d, valid = cost(k)
        diag = jnp.where(k == 0, 0.0, shift_i(d2))  # (i-1, j-1); D[0,0]=0 seed
        up = shift_i(d1) + p  # (i-1, j)
        left = d1 + p  # (i, j-1)
        best = jnp.minimum(diag, jnp.minimum(up, left))
        cur = jnp.where(valid, d + best, inf)
        return (d1, cur), None

    init = (
        jnp.full((B, N, m), inf, dtype),
        jnp.full((B, N, m), inf, dtype),
    )
    (d2, d1), _ = jax.lax.scan(
        step, init, jnp.arange(2 * m - 1, dtype=jnp.int32)
    )
    # Final diagonal k = 2m-2 holds D[m-1, m-1] at cell i = m-1.
    return jnp.sqrt(d1[..., m - 1])
