"""Batched subsequence DTW: locate the consensus adapter in segmented reads.

The reference's tRNA path matches an 84-event consensus adapter signal into
each read's ~121 segmented adapter events with psi-relaxed DTW
(warping_paths_fast(query, series, penalty=1.5, psi=(5, 0, 40, 0),
psi_neg=False) + SubsequenceAlignment best_match; reference
warpdemux/sig_proc.py:288-308). Semantics reproduced:

- full (r+1)x(c+1) DP, cost (q[i]-s[j])^2, penalty^2 on the two
  non-diagonal transitions, no band,
- psi = (psi_1b, psi_1e, psi_2b, psi_2e): D[0, 0:psi_2b+1] = 0 and
  D[0:psi_1b+1, 0] = 0 relax the query/series starts (ends unrelaxed for the
  shipped config),
- matching = sqrt(D[r, 1:]) / r; best end = argmin (first index on ties);
  the matched segment start comes from backtracking — here tracked *forward*
  through the recurrence (each cell carries the row-0 column where its path
  started), so the whole batch resolves without per-read backtracking.

Batched formulation: anti-diagonal wavefront (r+c+1 steps) over (B, r+1) state
lanes carrying (cost, start) pairs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def subsequence_dtw_ref(query, series, penalty, psi):
    """Scalar numpy golden reference. Returns (start, end, dist)."""
    q, s = np.asarray(query, float), np.asarray(series, float)
    r, c = len(q), len(s)
    p = penalty * penalty
    psi_1b, psi_1e, psi_2b, psi_2e = psi
    D = np.full((r + 1, c + 1), np.inf)
    D[0, 0 : psi_2b + 1] = 0.0
    D[0 : psi_1b + 1, 0] = 0.0
    S = np.full((r + 1, c + 1), -1, int)
    S[0, :] = np.arange(c + 1)
    S[:, 0] = 0
    for i in range(1, r + 1):
        for j in range(1, c + 1):
            d = (q[i - 1] - s[j - 1]) ** 2
            opts = (D[i - 1, j - 1], D[i - 1, j] + p, D[i, j - 1] + p)
            k = int(np.argmin(opts))
            D[i, j] = d + opts[k]
            S[i, j] = (S[i - 1, j - 1], S[i - 1, j], S[i, j - 1])[k]
    matching = np.sqrt(D[r, 1:]) / r
    j_star = int(np.argmin(matching)) + 1
    return int(S[r, j_star]), j_star, float(matching[j_star - 1])


@functools.partial(jax.jit, static_argnames=("penalty", "psi"))
def subsequence_dtw_batch(
    query: jnp.ndarray,
    series: jnp.ndarray,
    series_len: jnp.ndarray,
    penalty: float = 1.5,
    psi: tuple = (5, 0, 40, 0),
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched subsequence match.

    Args:
      query: (m,) consensus signal.
      series: (B, C) normalized event means, garbage past series_len.
      series_len: (B,) valid series lengths.
    Returns:
      (start (B,), end (B,), dist (B,)): matched segment [start, end) in
      series element indices and the normalized match distance.
    """
    (m,) = query.shape
    B, C = series.shape
    r, c = m, C
    p = jnp.float32(penalty * penalty)
    psi_1b, _, psi_2b, _ = psi
    inf = jnp.float32(np.float32(np.finfo(np.float32).max / 4))

    q = query.astype(jnp.float32)
    s = series.astype(jnp.float32)
    iarr = jnp.arange(r + 1, dtype=jnp.int32)  # wavefront cell index == i

    # state: D and S for diagonals k-1, k; cell i holds grid point (i, k-i)
    def shift_i(a, fill):
        return jnp.concatenate(
            [jnp.full(a.shape[:-1] + (1,), fill, a.dtype), a[..., :-1]],
            axis=-1,
        )

    def boundary(k):
        """D/S values for boundary cells on diagonal k (i==0 or j==0)."""
        j = k - iarr
        d0 = jnp.where(
            (iarr == 0) & (j <= psi_2b),
            0.0,
            jnp.where((j == 0) & (iarr <= psi_1b), 0.0, inf),
        )
        s0 = jnp.where(iarr == 0, j, 0).astype(jnp.int32)
        return d0, s0

    def step(carry, k):
        D2, S2, D1, S1 = carry  # diagonals k-2 and k-1: (B, r+1)
        j = (k - iarr)[None, :]  # (1, r+1)
        interior = (iarr[None, :] >= 1) & (j >= 1) & (j <= series_len[:, None])
        jc = jnp.clip(j, 1, c)
        sj = jnp.take_along_axis(s, jc - 1, axis=1)  # (B, r+1): s[j-1]
        qi = q[jnp.clip(iarr - 1, 0, r - 1)][None, :]  # (1, r+1): q[i-1]
        d = (qi - sj) ** 2

        diag_D, diag_S = shift_i(D2, inf), shift_i(S2, 0)
        up_D, up_S = shift_i(D1, inf), shift_i(S1, 0)
        left_D, left_S = D1, S1

        o0, o1, o2 = diag_D, up_D + p, left_D + p
        best = jnp.minimum(o0, jnp.minimum(o1, o2))
        S_best = jnp.where(
            o0 <= jnp.minimum(o1, o2),
            diag_S,
            jnp.where(o1 <= o2, up_S, left_S),
        )
        Dk_int = d + best

        bd_D, bd_S = boundary(k)
        is_boundary = (iarr[None, :] == 0) | (j == 0)
        Dk = jnp.where(is_boundary, bd_D[None, :], jnp.where(interior, Dk_int, inf))
        Sk = jnp.where(
            is_boundary, bd_S[None, :], jnp.where(interior, S_best, 0)
        )
        return (D1, S1, Dk, Sk), (Dk, Sk)

    init = (
        jnp.full((B, r + 1), inf),
        jnp.zeros((B, r + 1), jnp.int32),
        jnp.full((B, r + 1), inf),
        jnp.zeros((B, r + 1), jnp.int32),
    )
    ks = jnp.arange(r + c + 1, dtype=jnp.int32)
    _, (Dks, Sks) = jax.lax.scan(step, init, ks)
    # Row r of the grid: D[r, j] lives on diagonal k = r + j at cell i = r.
    # Collect D[r, 1..c]: Dks has shape (K, B, r+1); take cell r for k >= r+1.
    D_last = Dks[r + 1 :, :, r]  # (c, B) -> D[r, 1..c]
    S_last = Sks[r + 1 :, :, r]
    matching = jnp.sqrt(jnp.swapaxes(D_last, 0, 1)) / r  # (B, c)
    valid = jnp.arange(1, c + 1)[None, :] <= series_len[:, None]
    matching = jnp.where(valid, matching, jnp.inf)
    j_star = jnp.argmin(matching, axis=1).astype(jnp.int32) + 1
    dist = jnp.min(matching, axis=1)
    start = jnp.take_along_axis(
        jnp.swapaxes(S_last, 0, 1), (j_star - 1)[:, None], axis=1
    )[:, 0]
    return start, j_star, dist
