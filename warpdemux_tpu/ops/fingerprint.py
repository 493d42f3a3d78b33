"""Detect-results -> barcode fingerprints, fused and batched.

The reference's per-read `detect_results_to_fpt` (warpdemux/sig_proc.py:394-605)
re-expressed as one fixed-shape device stage:

1. adapter extraction with padding into a fixed (B, A_max) buffer
   (sig_proc.py:382-391; padding from sig_extract.padding),
2. outlier clipping to median +/- thresh*MAD (sig_proc.py:421-431),
3. optional pre-normalization (sig_extract.normalization, "none" in RNA004),
4. event segmentation into num_events changepoints (ops/segmentation.py),
5. mean/std normalization of the event means (segmentation.normalization),
6. barcode fingerprint = last barcode_num_events normalized event means,
   dwell times likewise (sig_proc.py:569-605),
7. adapter event statistics (dt med/mad, event mean/std/med/mad,
   sig_proc.py:562-567).

Failure taxonomy matches the reference: segmentation failure when fewer than
num_events peaks survive (accept_less_cpts=false path).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from warpdemux_tpu.ops.normalize import (
    clip_outliers_prefix,
    masked_mean_std,
    masked_median,
    masked_mad,
    normalize,
)
from warpdemux_tpu.ops.segmentation import segment_means, segment_signal_batch


@dataclass(frozen=True)
class FingerprintConfig:
    # [sig_extract]
    padding: int = 100
    extract_normalization: str = "none"
    # [core]
    sig_norm_outlier_thresh: float = 5.0
    max_obs_adapter: int = 6000
    # [segmentation]
    num_events: int = 110
    min_obs_per_base: int = 6
    running_stat_width: int = 12
    normalization: str = "mean"
    barcode_num_events: int = 25
    accept_less_cpts: bool = False

    @property
    def buffer_len(self) -> int:
        # fixed adapter buffer: max adapter + padding at both ends, rounded
        # up to a lane multiple
        raw = self.max_obs_adapter + 2 * self.padding
        return -(-raw // 128) * 128


class FingerprintArrays(NamedTuple):
    """Batched fingerprint results; (B, ...) arrays."""

    ok: jnp.ndarray  # bool: segmentation + normalization succeeded
    fpt: jnp.ndarray  # (B, barcode_num_events) float
    dwell: jnp.ndarray  # (B, barcode_num_events) int32
    adapter_dt_med: jnp.ndarray
    adapter_dt_mad: jnp.ndarray
    adapter_event_mean: jnp.ndarray
    adapter_event_std: jnp.ndarray
    adapter_event_med: jnp.ndarray
    adapter_event_mad: jnp.ndarray


def extract_adapter_batch(
    signals: jnp.ndarray,
    in_lens: jnp.ndarray,
    adapter_start: jnp.ndarray,
    adapter_end: jnp.ndarray,
    padding: int,
    buffer_len: int,
):
    """Gather [max(0, start-pad), min(len, end+pad)) into a fixed buffer.

    Returns (buffer (B, buffer_len), lengths (B,)).
    """
    from warpdemux_tpu.ops.window_gather import shift_rows

    B, L = signals.shape
    start = jnp.maximum(0, adapter_start - padding)
    end = jnp.minimum(in_lens, adapter_end + padding)
    length = jnp.clip(end - start, 0, buffer_len)
    # right-pad so any start in [0, L] yields a full window; the tail is
    # masked below anyway
    padded = jnp.concatenate(
        [signals, jnp.zeros((B, buffer_len), signals.dtype)], axis=1
    )
    buf = shift_rows(padded, start, buffer_len)
    mask = jnp.arange(buffer_len)[None, :] < length[:, None]
    return jnp.where(mask, buf, 0.0), length


@functools.partial(jax.jit, static_argnames=("cfg",))
def fingerprints_from_boundaries(
    signals: jnp.ndarray,
    in_lens: jnp.ndarray,
    adapter_start: jnp.ndarray,
    adapter_end: jnp.ndarray,
    cfg: FingerprintConfig = FingerprintConfig(),
) -> FingerprintArrays:
    adapter, a_len = extract_adapter_batch(
        signals,
        in_lens.astype(jnp.int32),
        adapter_start.astype(jnp.int32),
        adapter_end.astype(jnp.int32),
        cfg.padding,
        cfg.buffer_len,
    )
    B, A = adapter.shape
    amask = jnp.arange(A)[None, :] < a_len[:, None]

    adapter = clip_outliers_prefix(adapter, a_len, cfg.sig_norm_outlier_thresh)
    adapter = jnp.where(amask, adapter, 0.0)
    if cfg.extract_normalization != "none":
        adapter = jnp.where(
            amask, normalize(adapter, amask, cfg.extract_normalization), 0.0
        )

    means, dwell, seg_ok, _, _, _ = segment_signal_batch(
        adapter,
        a_len,
        cfg.num_events,
        cfg.min_obs_per_base,
        cfg.running_stat_width,
    )
    E = means.shape[1]  # num_events + 1
    all_mask = jnp.ones((B, E), bool)

    # normalize event means over ALL events (sig_proc.py:548), then keep the
    # last barcode_num_events as the fingerprint (sig_proc.py:593)
    ev_mean, ev_std = masked_mean_std(means, all_mask)
    norm_ok = ev_std > 0
    norm_means = (means - ev_mean[:, None]) / jnp.where(
        norm_ok, ev_std, 1.0
    )[:, None]

    k = cfg.barcode_num_events
    fpt = norm_means[:, -k:]
    dwell_k = dwell[:, -k:]

    dt_med = masked_median(dwell.astype(jnp.float32), all_mask)
    dt_mad = masked_mad(dwell.astype(jnp.float32), all_mask, dt_med)
    ev_med = masked_median(means, all_mask)
    ev_mad = masked_mad(means, all_mask, ev_med)

    ok = seg_ok & norm_ok
    return FingerprintArrays(
        ok=ok,
        fpt=fpt,
        dwell=dwell_k,
        adapter_dt_med=dt_med,
        adapter_dt_mad=dt_mad,
        adapter_event_mean=ev_mean,
        adapter_event_std=ev_std,
        adapter_event_med=ev_med,
        adapter_event_mad=ev_mad,
    )


class ConsensusFingerprintArrays(NamedTuple):
    """FingerprintArrays + consensus-match fields (tRNA refinement path)."""

    base: FingerprintArrays
    outlier: jnp.ndarray  # (B,) bool: consensus query outlier
    seg_query_start: jnp.ndarray  # (B,) int32, matched consensus segment
    seg_query_end: jnp.ndarray  # (B,) int32 (inclusive event index)
    sig_barcode_start: jnp.ndarray  # (B,) int32 sample index into adapter


@functools.partial(jax.jit, static_argnames=("cfg", "sx"))
def fingerprints_consensus_refined(
    signals: jnp.ndarray,
    in_lens: jnp.ndarray,
    adapter_start: jnp.ndarray,
    adapter_end: jnp.ndarray,
    consensus_query: jnp.ndarray,
    cfg: FingerprintConfig,
    sx,
) -> ConsensusFingerprintArrays:
    """Consensus-guided barcode-refined fingerprints (the tRNA path).

    Reference contract (warpdemux/sig_proc.py:255-378 +
    detect_results_to_fpt's refinement branch :452-521), batched:

    1. segment the whole adapter into cfg.num_events events (per-read
       adapted min_obs / width as usual),
    2. subsequence-DTW match the mean-normalized consensus query into the
       mean-normalized adapter event means (penalty/psi from config;
       sig_proc.py:288-308),
    3. sig_barcode_start = sum(adapter dwell times before the matched end
       event) = segment boundary at the matched end (sig_proc.py:331),
    4. re-run peak picking on the t-test scores restricted to positions
       >= sig_barcode_start, keep the sx.barcode_seg_num_events highest
       peaks, changepoints = peaks + cfg.running_stat_width (the *config*
       width, not the adapted one — discrepenacy_curve_to_cpts is called
       with the raw config values, sig_proc.py:356-362),
    5. barcode event means between those changepoints, normalized w.r.t.
       the adapter event statistics (normalize_wrt, sig_proc.py:482-484),
    6. fingerprint = last cfg.barcode_num_events of them,
    7. outlier gate: matched start > ub_start or matched (inclusive) end
       outside [lb_end, ub_end] -> "consensus query outlier"
       (sig_proc.py:500-521).

    `sx` is a SegmentationExtra (hashable); `consensus_query` the
    mean-normalized consensus event signal.
    """
    adapter, a_len = extract_adapter_batch(
        signals,
        in_lens.astype(jnp.int32),
        adapter_start.astype(jnp.int32),
        adapter_end.astype(jnp.int32),
        cfg.padding,
        cfg.buffer_len,
    )
    B, A = adapter.shape
    amask = jnp.arange(A)[None, :] < a_len[:, None]

    adapter = clip_outliers_prefix(adapter, a_len, cfg.sig_norm_outlier_thresh)
    adapter = jnp.where(amask, adapter, 0.0)
    if cfg.extract_normalization != "none":
        adapter = jnp.where(
            amask, normalize(adapter, amask, cfg.extract_normalization), 0.0
        )

    means, dwell, seg_ok, scores, n_scores, boundaries = segment_signal_batch(
        adapter,
        a_len,
        cfg.num_events,
        cfg.min_obs_per_base,
        cfg.running_stat_width,
    )
    E = means.shape[1]  # num_events + 1 adapter events
    all_mask = jnp.ones((B, E), bool)

    # adapter event statistics (also the normalize_wrt reference stats)
    ev_mean, ev_std = masked_mean_std(means, all_mask)
    norm_ok = ev_std > 0
    norm_series = (means - ev_mean[:, None]) / jnp.where(
        norm_ok, ev_std, 1.0
    )[:, None]
    dt_med = masked_median(dwell.astype(jnp.float32), all_mask)
    dt_mad = masked_mad(dwell.astype(jnp.float32), all_mask, dt_med)
    ev_med = masked_median(means, all_mask)
    ev_mad = masked_mad(means, all_mask, ev_med)

    from warpdemux_tpu.ops.subsequence import subsequence_dtw_batch

    series_len = jnp.full(B, E, jnp.int32)
    q_start, q_end_excl, _ = subsequence_dtw_batch(
        consensus_query.astype(jnp.float32),
        norm_series,
        series_len,
        penalty=float(sx.consensus_subseq_match_penalty),
        psi=tuple(int(v) for v in sx.consensus_subseq_match_psi),
    )
    # dtaidistance's match end is the inclusive 0-based event index; our
    # wavefront op returns the exclusive end (= inclusive + 1).
    q_end = q_end_excl - 1
    q_end_c = jnp.clip(q_end, 0, E)
    # sum(dwell[:q_end]) == segment boundary at event q_end
    sig_bc_start = jnp.take_along_axis(
        boundaries, q_end_c[:, None], axis=1
    )[:, 0]

    # re-segment scores[sig_bc_start:] into barcode_seg_num_events events;
    # distance and +width offset use the RAW config values
    from warpdemux_tpu.ops.peaks import find_peaks_batch, select_top_peaks

    dist_row = jnp.full(B, max(cfg.min_obs_per_base, 1), jnp.int32)
    keep_mask, cnt = find_peaks_batch(
        scores,
        n_scores,
        dist_row,
        max_distance=cfg.min_obs_per_base + 1,
        min_pos=sig_bc_start,
    )
    k_seg = int(sx.barcode_seg_num_events)
    sel_pos, bc_ok = select_top_peaks(scores, keep_mask, cnt, k_seg)
    # global changepoints: (local peak + cfg.width) + sig_bc_start == peak +
    # cfg.width; last boundary = local "signal length" n_scores -
    # sig_bc_start + 2*width mapped back to global
    cpts = jnp.sort(sel_pos, axis=1) + jnp.int32(cfg.running_stat_width)
    last = (n_scores + 2 * cfg.running_stat_width)[:, None]
    bc_bounds = jnp.concatenate(
        [sig_bc_start[:, None], cpts, last], axis=1
    )  # (B, k_seg + 2)
    bc_means = segment_means(adapter, bc_bounds, a_len)  # (B, k_seg + 1)
    bc_dwell = bc_bounds[:, 1:] - bc_bounds[:, :-1]

    # normalize_wrt(barcode, adapter, "mean"): scalar shift/scale from the
    # adapter event stats (sig_proc.py:139-168)
    norm_bc = (bc_means - ev_mean[:, None]) / jnp.where(
        norm_ok, ev_std, 1.0
    )[:, None]

    k = cfg.barcode_num_events
    fpt = norm_bc[:, -k:]
    dwell_k = bc_dwell[:, -k:]

    outlier = (
        (q_start > sx.consensus_subseq_match_ub_start)
        | (q_end < sx.consensus_subseq_match_lb_end)
        | (q_end > sx.consensus_subseq_match_ub_end)
    )
    ok = seg_ok & bc_ok & norm_ok & ~outlier
    base = FingerprintArrays(
        ok=ok,
        fpt=fpt,
        dwell=dwell_k,
        adapter_dt_med=dt_med,
        adapter_dt_mad=dt_mad,
        adapter_event_mean=ev_mean,
        adapter_event_std=ev_std,
        adapter_event_med=ev_med,
        adapter_event_mad=ev_mad,
    )
    return ConsensusFingerprintArrays(
        base=base,
        outlier=outlier & seg_ok & norm_ok,
        seg_query_start=q_start,
        seg_query_end=q_end,
        sig_barcode_start=sig_bc_start,
    )
