"""Banded DTW distance matrices as one fused GPU kernel (Pallas, Triton route).

Same dtaidistance-2.3.13 semantics as `ops/dtw.py` (squared-difference
cost, squared off-diagonal penalty, Sakoe-Chiba band |i - j| <= window - 1,
sqrt at the end). The plain version advances all (B, N) lattices one
anti-diagonal per `lax.scan` step, and each step streams two (B, N, m)
float32 arrays through device memory. Here each program owns a
(b_tile, n_tile) tile of query-by-reference problems and keeps the whole
lattice in registers: it reads only the two fingerprint tiles and writes
only its tile of D.

Layout: both fingerprint sets arrive transposed and padded, X as
(m_pad, B) and Y as (m_pad, N), so row i of the DP reads one contiguous
slice of each. The m rows of the DP are unrolled statically and only band
cells are emitted (515 of 625 for m = 25, window = 15). Row i needs only
row i - 1, so at most one band row of (b_tile, n_tile) tiles is live.

    D[i, j] = d(i, j) + min(D[i-1, j-1], min(D[i-1, j], D[i, j-1]) + p)

which equals the plain recurrence `d + min(diag, up + p, left + p)` bit
for bit, because adding p rounds monotonically.

`dtw_distance_matrix_kernel` is what the pipeline calls. It is lowered for
the platform it is compiled for: Triton compiles it for CUDA devices, and
on the CPU (the test suite, and CPU reference runs) the Pallas interpreter
runs the same kernel body. Both compute the same float32 arithmetic in
the same order as `ops/dtw.dtw_distance_matrix`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Tiles and warps measured fastest on an H100 (WDX4 and WDX10 at B=1000;
# PERF.md). Larger tiles spill registers and compile for minutes.
B_TILE = 8
N_TILE = 64
NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _dtw_tile_kernel(xt_ref, yt_ref, o_ref, *, m, window, p):
    xs = [xt_ref[i, :][:, None] for i in range(m)]  # (b_tile, 1) each
    ys = [yt_ref[j, :][None, :] for j in range(m)]  # (1, n_tile) each
    prev: dict[int, jax.Array] = {}
    for i in range(m):
        cur: dict[int, jax.Array] = {}
        for j in range(max(0, i - window + 1), min(m, i + window)):
            d = xs[i] - ys[j]
            d = d * d
            diag, up, left = prev.get(j - 1), prev.get(j), cur.get(j - 1)
            side = [a for a in (up, left) if a is not None]
            if not side and diag is None:  # D[0, 0]: the seed
                cur[j] = d
                continue
            best = None
            if side:
                best = (side[0] if len(side) == 1 else jnp.minimum(*side)) + p
            if diag is not None:
                best = diag if best is None else jnp.minimum(diag, best)
            cur[j] = d + best
        prev = cur
    o_ref[...] = jnp.sqrt(prev[m - 1])


@functools.partial(
    jax.jit,
    static_argnames=("window", "penalty", "b_tile", "n_tile", "interpret"),
)
def dtw_distance_matrix_triton(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    window: int = 15,
    penalty: float = 0.1,
    b_tile: int = B_TILE,
    n_tile: int = N_TILE,
    interpret: bool = False,
) -> jnp.ndarray:
    """Cross DTW distance matrix, one fused kernel launch.

    Args:
      X: (B, m) query fingerprints.
      Y: (N, m) reference fingerprints (same m).
      window, penalty: as `ops/dtw.dtw_distance_matrix`.
      b_tile, n_tile: powers of two; each program computes one
        (b_tile, n_tile) tile of D.
    Returns:
      (B, N) float32 distances.
    """
    B, m = X.shape
    N, m2 = Y.shape
    assert m == m2, "query and reference fingerprints must have equal length"
    assert window >= 1
    for t in (b_tile, n_tile):
        assert t == _next_pow2(t), "tiles must be powers of two"
    m_pad = _next_pow2(m)
    Bp = -(-B // b_tile) * b_tile
    Np = -(-N // n_tile) * n_tile
    XT = jnp.pad(X.astype(jnp.float32).T, ((0, m_pad - m), (0, Bp - B)))
    YT = jnp.pad(Y.astype(jnp.float32).T, ((0, m_pad - m), (0, Np - N)))

    kernel = functools.partial(
        _dtw_tile_kernel, m=m, window=int(window),
        p=float(penalty) * float(penalty),
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((Bp, Np), jnp.float32),
        grid=(Bp // b_tile, Np // n_tile),
        in_specs=[
            pl.BlockSpec((m_pad, b_tile), lambda i, j: (0, i)),
            pl.BlockSpec((m_pad, n_tile), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((b_tile, n_tile), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="dtw_banded",
    )(XT, YT)
    return out[:B, :N]


def dtw_distance_matrix_kernel(
    X: jnp.ndarray, Y: jnp.ndarray, window: int = 15, penalty: float = 0.1
) -> jnp.ndarray:
    """`dtw_distance_matrix_triton` with the default tiles, compiled by
    Triton on CUDA devices and interpreted on the CPU."""
    call = functools.partial(
        dtw_distance_matrix_triton, window=window, penalty=penalty
    )
    return jax.lax.platform_dependent(
        X, Y,
        cuda=call,
        default=functools.partial(call, interpret=True),
    )
