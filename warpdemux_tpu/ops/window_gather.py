"""Per-row windowed extraction: out[b, :] = x[b, start[b] : start[b] + A].

Used for adapter extraction (ops/fingerprint.py) and the LLR refinement
windows (detect/boundaries.py).
"""

from __future__ import annotations

import jax.numpy as jnp


def shift_rows(x: jnp.ndarray, starts: jnp.ndarray, out_len: int) -> jnp.ndarray:
    """out[b, j] = x[b, starts[b] + j] for j < out_len (indices clamped)."""
    B, L = x.shape
    idx = jnp.clip(
        starts.astype(jnp.int32)[:, None]
        + jnp.arange(out_len, dtype=jnp.int32)[None, :],
        0,
        L - 1,
    )
    return jnp.take_along_axis(x, idx, axis=1)
