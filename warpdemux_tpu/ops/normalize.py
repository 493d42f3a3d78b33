"""Masked, batched normalization primitives.

Capability parity with the reference's normalization layer
(reference: warpdemux/sig_proc.py:70-168 — mad_normalize, mean_normalize,
normalize, normalize_wrt), re-designed for batched devices: instead of
NaN-padded ragged arrays and `np.nanmedian`, every op takes an explicit boolean
validity mask and runs on fixed-shape (B, L) batches so XLA sees static shapes
and processes whole minibatches at once.

Median semantics match numpy: for an even count n the median is the average of
the two middle order statistics; we get order statistics with a full sort along
the last axis after pushing masked-out lanes to +inf.
"""

from __future__ import annotations

import jax.numpy as jnp


def _masked_sort(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Sort x ascending along the last axis with invalid lanes pushed to the end."""
    big = jnp.asarray(jnp.finfo(x.dtype).max, dtype=x.dtype)
    return jnp.sort(jnp.where(mask, x, big), axis=-1)


def masked_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median over valid lanes of the last axis. Shape: x[..., L] -> x[...].

    Matches np.median / np.nanmedian: averages the two middle order statistics
    for even counts. float32 uses the sort-free radix-select engine
    (ops/select.py — one masked compare+sum per bisection round instead of a
    full bitonic sort); other dtypes (the float64 parity mode) keep the sort.
    """
    if x.dtype == jnp.float32 and x.shape[-1] >= 512:
        from warpdemux_tpu.ops.select import masked_median_select

        return masked_median_select(x, mask)
    n = jnp.sum(mask, axis=-1)
    s = _masked_sort(x, mask)
    hi_idx = jnp.maximum(n // 2, 0)
    lo_idx = jnp.maximum((n - 1) // 2, 0)
    lo = jnp.take_along_axis(s, lo_idx[..., None], axis=-1)[..., 0]
    hi = jnp.take_along_axis(s, hi_idx[..., None], axis=-1)[..., 0]
    med = 0.5 * (lo + hi)
    return jnp.where(n > 0, med, jnp.nan)


def masked_mad(x: jnp.ndarray, mask: jnp.ndarray, med: jnp.ndarray | None = None):
    """Median absolute deviation over valid lanes of the last axis."""
    if med is None:
        med = masked_median(x, mask)
    return masked_median(jnp.abs(x - med[..., None]), mask)


def masked_mean_std(x: jnp.ndarray, mask: jnp.ndarray):
    """(mean, population std) over valid lanes of the last axis.

    Uses the two-pass formula (sum, then centered squares) like np.mean/np.std,
    with masked lanes contributing zero.
    """
    n = jnp.sum(mask, axis=-1).astype(x.dtype)
    safe_n = jnp.maximum(n, 1.0)
    xm = jnp.where(mask, x, 0.0)
    mean = jnp.sum(xm, axis=-1) / safe_n
    d = jnp.where(mask, x - mean[..., None], 0.0)
    var = jnp.sum(d * d, axis=-1) / safe_n
    return mean, jnp.sqrt(var)


def mean_normalize(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """(x - mean) / std over valid lanes (reference sig_proc.py:99-111)."""
    mean, std = masked_mean_std(x, mask)
    return (x - mean[..., None]) / std[..., None]


def mad_normalize(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """(x - median) / MAD over valid lanes (reference sig_proc.py:70-96)."""
    med = masked_median(x, mask)
    mad = masked_mad(x, mask, med)
    return (x - med[..., None]) / mad[..., None]


def normalize(x: jnp.ndarray, mask: jnp.ndarray, method: str = "mean") -> jnp.ndarray:
    """Dispatch on method like the reference (sig_proc.py:114-136)."""
    if method == "mean":
        return mean_normalize(x, mask)
    if method == "median":
        return mad_normalize(x, mask)
    if method == "none":
        return x
    raise ValueError(f"Normalization method {method} not recognized.")


def normalize_wrt(
    to_norm: jnp.ndarray,
    ref: jnp.ndarray,
    ref_mask: jnp.ndarray,
    method: str = "mean",
) -> jnp.ndarray:
    """Normalize `to_norm` by statistics of `ref` (sig_proc.py:139-168).

    to_norm: (..., M1); ref/ref_mask: (..., M2). Statistics broadcast over the
    trailing axis of to_norm.
    """
    if method == "mean":
        shift, scale = masked_mean_std(ref, ref_mask)
    elif method == "median":
        shift = masked_median(ref, ref_mask)
        scale = masked_mad(ref, ref_mask, shift)
    else:
        raise ValueError(f"Normalization method {method} not recognized.")
    return (to_norm - shift[..., None]) / scale[..., None]


def clip_outliers(
    x: jnp.ndarray, mask: jnp.ndarray, thresh: float
) -> jnp.ndarray:
    """Clip to median +/- thresh*MAD over valid lanes (sig_proc.py:421-431)."""
    med = masked_median(x, mask)
    mad = masked_mad(x, mask, med)
    lo = med - thresh * mad
    hi = med + thresh * mad
    return jnp.clip(x, lo[..., None], hi[..., None])


def clip_outliers_prefix(
    x: jnp.ndarray, n_valid: jnp.ndarray, thresh: float
) -> jnp.ndarray:
    """clip_outliers where the valid lanes are the prefix [0, n_valid).

    The median+MAD run through the fused ranged radix-select, the hot path
    of the fingerprint stage.
    """
    from warpdemux_tpu.ops.select import range_median_mad

    B = x.shape[0]
    med, mad = range_median_mad(
        x,
        jnp.zeros((1, B), jnp.int32),
        n_valid.astype(jnp.int32)[None],
    )
    lo = med[0] - thresh * mad[0]
    hi = med[0] + thresh * mad[0]
    return jnp.clip(x, lo[..., None], hi[..., None])
