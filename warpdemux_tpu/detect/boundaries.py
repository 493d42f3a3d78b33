"""Batched adapter / poly(A) boundary detection (the ADAPTed capability).

The reference delegates boundary detection to its ADAPTed submodule
(combined_detect_{llr2,cnn,start_peak}, called at file_proc.py:395-416) whose
source is not part of the reference checkout; this module implements the
documented capability from the configuration contract (SURVEY.md 2.4:
[core]/[mvs_polya]/[llr_boundaries]/[real_range]/[med_shift]/[rna_start_peak]
knobs in config_files/rna004_130bps@v1.0*.toml) as one fused, fixed-shape,
masked device function:

RNA004 direct-RNA reads traverse the pore 3'->5': sequencing adapter
(60-90 pA, high variance) -> poly(A) tail (flat, ~1.3-1.5x the adapter
median, low variance) -> RNA body. Detection:

1. forward rolling mean/variance over the calibrated signal (cumsum-based),
2. poly(A) candidate mask: elevated mean (>= adapter_med * polya_scale) and
   low variance (<= polya_var_max), sustained for min_obs_polya samples,
3. first sustained candidate inside the allowed adapter-length range gives
   the coarse adapter->polyA boundary; the run's end gives polyA->RNA,
4. both boundaries are refined to sample precision with an exact two-segment
   Gaussian log-likelihood changepoint scan in a local window (the "LLR"
   method of the reference's llr_boundaries),
5. region statistics (mean/std/median/MAD for adapter, polyA, preloaded RNA)
   and the validation checks ([mvs_polya] median-shift & variance,
   [real_range] local-range and adapter-MAD plausibility, [med_shift],
   open-pore detection) produce the fail taxonomy.

Everything is (B, L) masked math under one jit; no per-read host loops.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp

from warpdemux_tpu.detect.containers import DetectArrays
from warpdemux_tpu.ops.normalize import masked_median, masked_mad, masked_mean_std


@dataclass(frozen=True)
class DetectConfig:
    # primary method: "llr" | "start_peak" | "cnn" (reference
    # spc.primary_method; parser.py:514 update_primary_method)
    method: str = "llr"
    # [core]
    max_obs_trace: int = 10000
    min_obs_adapter: int = 2000
    max_obs_adapter: int = 6000
    min_obs_polya: int = 100
    downscale_factor: int = 10
    # polyA detection ([mvs_polya]-derived)
    polya_scale: float = 1.3  # pA_mean_adapter_med_scale_range lower bound
    mean_window: int = 200
    var_window: int = 500
    polya_var_max: float = 30.0  # pA_var_range upper bound (std^2? ref: pA units)
    median_shift_min: float = 5.0  # median_shift_range lower bound
    # candidate SEARCH thresholds, defaulting to the validation values.
    # They exist as separate knobs because search and validation play
    # different roles ([mvs_polya] validates the exact detected region;
    # the rolling-window search proposes candidates) — but measurement on
    # the 800-read fixture set showed loosening the search HURTS (first
    # loose candidate often lands inside the adapter: llr pass 46% -> 26%),
    # so the shipped configs keep them equal. tools/validate_boundaries.py
    # holds the evidence; the dominant fail buckets are long-adapter reads
    # bounded by the max_obs_adapter/max_obs_trace contract values, not by
    # search strictness.
    search_scale: float = 1.3
    search_var_max: float = 30.0
    llr_refine_window: int = 400
    mvs_detect_check: bool = True
    # [real_range]
    real_signal_check: bool = False
    local_range: tuple = (7.0, 35.0)
    adapter_mad_range: tuple = (3.0, 12.0)
    local_range_window: int = 300
    max_obs_local_range: int = 5000
    detect_open_pores: bool = False
    open_pore_pa: float = 195.0
    # [med_shift]
    detect_med_shift: bool = False
    med_shift_window: int = 10000
    med_shift_min: float = 5.0
    # [rna_start_peak] (tRNA primary; reconstruction of the ADAPTed
    # contract from rna004_130bps@v1.0_tRNA.toml:66-81 — the submodule
    # source is not in the reference checkout)
    start_peak_max_idx: int = 150  # ds units: capture spike search range
    sp_offset1: int = 10  # ds units past the spike -> adapter start
    sp_offset2: int = 100  # ds units past the spike -> earliest polyA/end
    min_start_peak_pa: float = 83.0
    sp_polya_scale: float = 1.3  # adapter_med_polya_mean_scale
    min_len_polya: int = 10  # ds units: required sustained polyA run
    sp_detect_polya: bool = True
    # [cnn_boundaries]
    cnn_polya_cand_k: int = 5
    # The CNN region prior sees only the first cnn_input_cap samples of the
    # read (input zeroed, validity capped, normalization stats computed over
    # the capped window). This makes the CNN mask a pure function of the
    # read PREFIX, which the two-stage wire feed (pipeline/step.py
    # make_twostage_decision_step) relies on for provably-identical stage-1
    # decisions: a 7168-sample prefix covers max_obs_adapter=6000 + the
    # poly(A) window for the bulk of reads, and reads whose poly(A) lies
    # beyond the cap are picked up by the LLR fallback chain
    # (fallback_to_llr, README.md:336-349) exactly like other CNN misses.
    # 0 disables the cap (full-window CNN; not two-stage-compatible).
    cnn_input_cap: int = 7168
    # fallback chain (README.md:336-349: cnn_boundaries.fallback_to_llr /
    # rna_start_peak.fallback_to_llr): reads the primary method fails are
    # re-detected with the LLR method
    fallback_to_llr: bool = False


def _shift_clamp(c, w):
    """c[:, min(i + w, L)] for i in [0, L) where c is (B, L+1).

    Pure slice + broadcast, no gather.
    """
    B, L1 = c.shape
    L = L1 - 1
    w = min(int(w), L)
    if w == 0:
        return c[:, :L]
    tail = jnp.broadcast_to(c[:, -1:], (B, w - 1)) if w > 1 else c[:, :0]
    return jnp.concatenate([c[:, w:], tail], axis=1)


def _rolling_mean_var_fwd(x, w):
    """Forward rolling mean/variance: window [t, t+w) (cumsum-based, O(n))."""
    B, L = x.shape
    z = jnp.zeros((B, 1), x.dtype)
    c1 = jnp.concatenate([z, jnp.cumsum(x, axis=1)], axis=1)
    c2 = jnp.concatenate([z, jnp.cumsum(x * x, axis=1)], axis=1)
    s1 = _shift_clamp(c1, w) - c1[:, :L]
    s2 = _shift_clamp(c2, w) - c2[:, :L]
    idx_hi = jnp.minimum(jnp.arange(L) + w, L)
    n = (idx_hi - jnp.arange(L)).astype(x.dtype)[None, :]
    mean = s1 / n
    var = jnp.maximum(s2 / n - mean * mean, 0.0)
    return mean, var


def _rolling_stats(xz, w_mean, w_var):
    """(mean[w_mean], var[w_mean], var[w_var]) forward rolling stats.

    The prefix sums' rounding depends on how the backend associates the
    cumsum (XLA's GPU and CPU lowerings differ by ~1 ulp of the running
    sum), which can move a marginal boundary.
    """
    mean_f, var_f = _rolling_mean_var_fwd(xz, w_mean)
    _, var_w = _rolling_mean_var_fwd(xz, w_var)
    return mean_f, var_f, var_w


def _run_sum(mask, w):
    """Per-position count of True in mask[t : min(t+w, L)) (int32, exact)."""
    B, L = mask.shape
    z = jnp.zeros((B, 1), jnp.int32)
    cc = jnp.concatenate(
        [z, jnp.cumsum(mask.astype(jnp.int32), axis=1)], axis=1
    )
    return _shift_clamp(cc, w) - cc[:, :L]


def _first_true(mask, default):
    """Per-row index of first True, else `default`."""
    any_ = jnp.any(mask, axis=1)
    idx = jnp.argmax(mask, axis=1).astype(jnp.int32)
    return jnp.where(any_, idx, default), any_


def _llr_refine(x, coarse, radius, lo, hi):
    """Exact two-segment Gaussian changepoint within [coarse-radius, coarse+radius].

    Minimizes n1*log(var1) + n2*log(var2) over split positions; returns the
    refined boundary clamped to [lo, hi].
    """
    from warpdemux_tpu.ops.window_gather import shift_rows

    B, L = x.shape
    W = 2 * radius
    start = jnp.clip(coarse - radius, 0, jnp.maximum(L - W, 0))
    win = shift_rows(x, start, W)  # (B, W)
    z = jnp.zeros((B, 1), x.dtype)
    c1 = jnp.concatenate([z, jnp.cumsum(win, axis=1)], axis=1)
    c2 = jnp.concatenate([z, jnp.cumsum(win * win, axis=1)], axis=1)
    t = jnp.arange(1, W, dtype=x.dtype)  # split at 1..W-1
    n1 = t[None, :]
    n2 = W - n1
    s1, s2 = c1[:, 1:W], c2[:, 1:W]
    v1 = jnp.maximum(s2 / n1 - (s1 / n1) ** 2, 1e-6)
    sT1 = c1[:, W : W + 1] - s1
    sT2 = c2[:, W : W + 1] - s2
    v2 = jnp.maximum(sT2 / n2 - (sT1 / n2) ** 2, 1e-6)
    cost = n1 * jnp.log(v1) + n2 * jnp.log(v2)
    split = jnp.argmin(cost, axis=1).astype(jnp.int32) + 1
    return jnp.clip(start + split, lo, hi)


def _llr_split_window(x, start, W, min_split, n_valid):
    """Two-segment Gaussian split of the fixed window [start, start+W).

    Like _llr_refine but with a lower bound on the split position and
    validity masking for rows whose window extends past n_valid. Returns the
    split as an absolute sample index.
    """
    from warpdemux_tpu.ops.window_gather import shift_rows

    B, L = x.shape
    start = jnp.clip(start, 0, jnp.maximum(L - 1, 0))
    win = shift_rows(
        jnp.concatenate([x, jnp.zeros((B, W), x.dtype)], axis=1), start, W
    )
    z = jnp.zeros((B, 1), x.dtype)
    c1 = jnp.concatenate([z, jnp.cumsum(win, axis=1)], axis=1)
    c2 = jnp.concatenate([z, jnp.cumsum(win * win, axis=1)], axis=1)
    # effective window length: never reach past n_valid (the padding past
    # the read end must not enter the segment statistics)
    weff = jnp.clip(n_valid - start, 1, W)  # (B,)
    t = jnp.arange(1, W, dtype=x.dtype)
    n1 = t[None, :]
    n2 = jnp.maximum(weff.astype(x.dtype)[:, None] - n1, 1.0)
    s1, s2 = c1[:, 1:W], c2[:, 1:W]
    v1 = jnp.maximum(s2 / n1 - (s1 / n1) ** 2, 1e-6)
    cT1 = jnp.take_along_axis(c1, weff[:, None], axis=1)
    cT2 = jnp.take_along_axis(c2, weff[:, None], axis=1)
    sT1 = cT1 - s1
    sT2 = cT2 - s2
    v2 = jnp.maximum(sT2 / n2 - (sT1 / n2) ** 2, 1e-6)
    cost = n1 * jnp.log(v1) + n2 * jnp.log(v2)
    tpos = jnp.arange(1, W, dtype=jnp.int32)[None, :]
    ok = (tpos >= min_split[:, None]) & (tpos < weff[:, None])
    cost = jnp.where(ok, cost, jnp.inf)
    split = jnp.argmin(cost, axis=1).astype(jnp.int32) + 1
    return jnp.clip(start + split, 0, n_valid)


def _region_stats_fused(x, pos, starts, ends, given_meds=None, given=()):
    """mean/std/median/MAD for R contiguous regions of the same rows.

    starts/ends: (R, B). All medians/MADs run through the fused radix-select
    engine (one pass stack for all regions) instead of per-region sorts. given/given_meds: regions whose median an earlier pass
    already computed skip the median bisection (only the MAD is searched).
    Returns four (R, B) arrays; empty regions yield 0.
    """
    from warpdemux_tpu.ops.select import range_median_mad

    meds, mads = range_median_mad(
        x, starts, ends, with_mad=True, given_meds=given_meds, given=given
    )
    means, stds = [], []
    for r in range(starts.shape[0]):
        mask = (pos >= starts[r][:, None]) & (pos < ends[r][:, None])
        mean, std = masked_mean_std(x, mask)
        means.append(mean)
        stds.append(std)
    empty = ends <= starts
    fix = lambda a: jnp.where(empty, 0.0, a)
    return (
        fix(jnp.stack(means)),
        fix(jnp.stack(stds)),
        fix(jnp.nan_to_num(meds)),
        fix(jnp.nan_to_num(mads)),
    )


def _range_medians(x, starts, ends, with_mad=False):
    """Fused exact medians (optionally MADs) of [start, end) row ranges."""
    from warpdemux_tpu.ops.select import range_median_mad

    return range_median_mad(x, starts, ends, with_mad=with_mad)


def _cnn_region_mask(xz, in_lens, cfg, cnn_params, pos, L):
    """CNN region prior as an f32 0/1 (B, L) mask (prefix-causal: input,
    validity and normalization capped at cnn_input_cap; only the capped
    lanes are computed — see DetectConfig.cnn_input_cap)."""
    from warpdemux_tpu.detect import cnn as cnn_mod

    ds = cfg.downscale_factor
    if cfg.cnn_input_cap and cfg.cnn_input_cap < L:
        cap = cfg.cnn_input_cap
        W_cnn = -(-cap // ds) * ds
        x_cnn = jnp.where(pos[:, :W_cnn] < cap, xz[:, :W_cnn], 0.0)
        lens_cnn = jnp.minimum(in_lens, cap)
    else:
        x_cnn, lens_cnn = xz, in_lens
    xn, valid_ds = cnn_mod.preprocess(x_cnn, lens_cnn, ds)
    logits = cnn_mod.apply(cnn_params, xn)
    pa_ds = cnn_mod.polya_mask_from_logits(logits, valid_ds)
    region_mask = jnp.repeat(pa_ds, ds, axis=1)
    if region_mask.shape[1] < L:
        region_mask = jnp.pad(
            region_mask,
            ((0, 0), (0, L - region_mask.shape[1])),
        )
    return region_mask.astype(jnp.float32)


@functools.partial(
    jax.jit, static_argnames=("cfg", "with_stats", "resolve_limit")
)
def detect_boundaries_batch(
    signals: jnp.ndarray,
    in_lens: jnp.ndarray,
    cfg: DetectConfig = DetectConfig(),
    cnn_params: dict | None = None,
    with_stats: bool = True,
    resolve_limit: int = 0,
    cnn_region: jnp.ndarray | None = None,
) -> DetectArrays:
    """Detect adapter/polyA/RNA boundaries for a (B, L) minibatch.

    with_stats=False skips the full region summary statistics (only the
    medians/MADs the fail gates need are computed); the fallback wrapper
    uses it for the two candidate passes and fills the summary stats once
    on the merged boundaries.

    `resolve_limit`: when nonzero, also emit `resolved` (B,) bool — True
    where this result is PROVABLY identical to what the same call would
    return with real signal past sample `resolve_limit` (the caller shipped
    only the first resolve_limit samples and zero-padded the rest, keeping
    the true in_lens). The predicate is conservative:

      - whole read shipped (in_len <= limit): identical program input;
      - llr/cnn pass or prefix-stable fail: the first sustained poly(A)
        candidate, its lapse end, the adapter start, every rolling window
        (var_window), refine window (mean_window/2 + llr_refine_window) and
        gate region they imply all lie inside the prefix, and the CNN
        region prior is prefix-causal by cnn_input_cap <= limit. "No polyA
        found" (code 2) is never prefix-stable (the tail could hold one);
        start_peak and [med_shift] configurations (whose gate reads up to
        in_len) resolve only whole reads.

    The downstream fingerprint/classify stages consult only
    [adapter_start - padding, adapter_end + padding) plus in_lens clamps,
    so a resolved detect row makes the whole decision row resolved
    (pinned end-to-end by tests/test_twostage.py on synthetic and real
    reads).
    """
    x = signals.astype(jnp.float32)
    B, L = x.shape
    in_lens = in_lens.astype(jnp.int32)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    valid = pos < in_lens[:, None]
    xz = jnp.where(valid, x, 0.0)

    sp_fail = jnp.zeros(B, bool)  # "rna start peak not found"

    if cfg.method == "start_peak":
        mean_f, var_f, var_w = _rolling_stats(
            xz, cfg.mean_window, cfg.var_window
        )
        # ---- [rna_start_peak] primary (tRNA): anchor the adapter start on
        # the capture spike at the head of the read, then (optionally)
        # locate a short polyA; without one, place the adapter->RNA
        # boundary with a two-segment Gaussian split.
        ds = cfg.downscale_factor
        Lds = L // ds
        xds = jnp.mean(xz[:, : Lds * ds].reshape(B, Lds, ds), axis=2)
        pds = jax.lax.broadcasted_iota(jnp.int32, (B, Lds), 1)
        left = jnp.concatenate([xds[:, :1], xds[:, :-1]], axis=1)
        right = jnp.concatenate([xds[:, 1:], xds[:, -1:]], axis=1)
        is_pk = (
            (xds >= left)
            & (xds > right)
            & (xds >= cfg.min_start_peak_pa)
            & (xds < cfg.open_pore_pa)
            & (pds >= 1)
            & (pds < cfg.start_peak_max_idx)
            & ((pds + 1) * ds <= in_lens[:, None])
        )
        pk_idx, pk_found = _first_true(is_pk, jnp.int32(0))
        sp_fail = ~pk_found
        adapter_start = jnp.minimum((pk_idx + cfg.sp_offset1) * ds, in_lens)

        # adapter level from the window right after the start
        adapter_proxy_med = _range_medians(
            x,
            adapter_start[None],
            jnp.minimum(adapter_start + cfg.min_obs_adapter, in_lens)[None],
        )[0][0]

        search_from = (pk_idx + cfg.sp_offset2) * ds
        thr = cfg.sp_polya_scale * adapter_proxy_med[:, None]
        Wp = cfg.min_len_polya * ds
        win_ok = (pos + Wp) <= in_lens[:, None]
        cand = (
            (mean_f > thr)
            & (var_w < cfg.polya_var_max)
            & valid
            & win_ok
            & (pos >= search_from[:, None])
        )
        run_sum = _run_sum(cand, Wp)
        sustained = (run_sum == Wp) & cand
        coarse_ps, found = _first_true(sustained, jnp.int32(0))
        sust_prev = jnp.concatenate(
            [jnp.zeros((B, 1), bool), sustained[:, :-1]], axis=1
        )
        polya_candidates = jnp.sum(sustained & ~sust_prev, axis=1).astype(
            jnp.int32
        )

        flat_high = (mean_f > thr) & (var_f <= cfg.polya_var_max) & valid
        lapse = (~flat_high) & (pos >= coarse_ps[:, None] + Wp)
        coarse_pe, has_end = _first_true(lapse, jnp.int32(0))
        coarse_pe = jnp.where(has_end, coarse_pe, in_lens)
        coarse_pe = jnp.minimum(coarse_pe + cfg.mean_window // 2, in_lens)

        polya_start = _llr_refine(
            xz, coarse_ps, cfg.llr_refine_window, jnp.int32(0), in_lens
        )
        polya_end = _llr_refine(
            xz, coarse_pe, cfg.llr_refine_window, polya_start, in_lens
        )

        # no polyA (plain tRNA): adapter ends at the strongest two-segment
        # changepoint within the allowed adapter-length window
        split_end = _llr_split_window(
            xz,
            adapter_start,
            cfg.max_obs_adapter,
            jnp.full(B, cfg.min_obs_adapter, jnp.int32),
            in_lens,
        )
        adapter_end = jnp.where(
            found & cfg.sp_detect_polya, polya_start, split_end
        )
        polya_start = jnp.where(found, polya_start, adapter_end)
        polya_end = jnp.where(found, polya_end, adapter_end)
        # a missing polyA is not a failure in this method (tRNA reads often
        # have none); `found` only selects the boundary source
        found = jnp.ones(B, bool)
        _rl_info = None  # start_peak resolves whole reads only
    else:
        # ---- [llr_boundaries] primary: sustained elevated+flat region ->
        # polyA; adapter = [sub-open-pore start, polyA start).
        # ---- [cnn_boundaries] primary (mRNA) runs the SAME search gated
        # to the CNN's predicted-polyA region: the network is a region
        # PRIOR (where to look), the elevated+flat contract decides, so
        # boundaries agree with LLR by construction wherever the CNN
        # predicts the region LLR would pick. (Validating top-k candidate
        # points instead — the previous design — failed real reads whose
        # var_window hung past a short polyA or whose run start sat on the
        # level ramp.)
        region_mask = None
        if cfg.method == "cnn":
            if cnn_region is not None:
                region_mask = cnn_region > 0
            else:
                if cnn_params is None:
                    raise ValueError(
                        "method='cnn' requires cnn_params "
                        "(load_params(model_name))"
                    )
                cnn_region = _cnn_region_mask(
                    xz, in_lens, cfg, cnn_params, pos, L
                )
                region_mask = cnn_region > 0

        # adapter level proxy: median of the first min_obs_adapter samples
        adapter_proxy_med = _range_medians(
            x,
            jnp.zeros((1, B), jnp.int32),
            jnp.minimum(cfg.min_obs_adapter, in_lens)[None],
        )[0][0]

        # poly(A) candidates: elevated + flat + fully inside the valid
        # region, at the (looser) SEARCH thresholds — the exact region is
        # validated by the mvs gate below at the contract values
        thr = cfg.search_scale * adapter_proxy_med[:, None]
        win_ok = (pos + cfg.min_obs_polya) <= in_lens[:, None]
        W = cfg.min_obs_polya
        mean_f, var_f, var_w = _rolling_stats(
            xz, cfg.mean_window, cfg.var_window
        )
        cand = (
            (mean_f > thr)
            & (var_w < cfg.search_var_max)
            & valid
            & win_ok
        )
        if region_mask is not None:
            cand = cand & region_mask
        run_sum = _run_sum(cand, W)

        # sustained for min_obs_polya samples
        sustained = (run_sum == W) & cand

        coarse_ps, found = _first_true(sustained, jnp.int32(0))

        # count distinct sustained runs (polya_candidates column)
        sust_prev = jnp.concatenate(
            [jnp.zeros((B, 1), bool), sustained[:, :-1]], axis=1
        )
        run_starts = sustained & ~sust_prev
        polya_candidates = jnp.sum(run_starts, axis=1).astype(jnp.int32)

        # poly(A) end: first position >= coarse_ps where the region stops
        # being both elevated and flat (variance catches RNA starts whose
        # level is close to the threshold; LLR refinement pins the sample).
        flat_high = (mean_f > thr) & (var_f <= cfg.search_var_max) & valid
        lapse = (~flat_high) & (pos >= coarse_ps[:, None] + W)
        pe_first, has_end = _first_true(lapse, jnp.int32(0))
        coarse_pe = jnp.where(has_end, pe_first, in_lens)
        coarse_pe = jnp.minimum(coarse_pe + cfg.mean_window // 2, in_lens)

        # LLR sample-precision refinement of both boundaries
        polya_start = _llr_refine(
            xz, coarse_ps, cfg.llr_refine_window, jnp.int32(0), in_lens
        )
        polya_end = _llr_refine(
            xz, coarse_pe, cfg.llr_refine_window, polya_start, in_lens
        )
        polya_start = jnp.where(found, polya_start, 0)
        polya_end = jnp.where(found, polya_end, 0)

        # adapter start: first sub-open-pore sample (usually 0)
        below_pore, _ = _first_true(
            (mean_f < cfg.open_pore_pa) & valid, jnp.int32(0)
        )
        adapter_start = below_pore
        adapter_end = polya_start
        _rl_info = (coarse_ps, pe_first, has_end, adapter_start)

    # ---- region statistics (one fused ranged-median launch for all regions)
    rna_start = polya_end
    rna_end = in_lens
    ms_end = jnp.minimum(rna_start + cfg.med_shift_window, in_lens)
    if with_stats:
        starts = jnp.stack([adapter_start, polya_start, rna_start])
        ends = jnp.stack([adapter_end, polya_end, rna_end])
        if cfg.detect_med_shift:
            starts = jnp.concatenate([starts, rna_start[None]])
            ends = jnp.concatenate([ends, ms_end[None]])
        means, stds, meds, mads = _region_stats_fused(x, pos, starts, ends)
        ad_mean, ad_std, ad_med, ad_mad = means[0], stds[0], meds[0], mads[0]
        pa_mean, pa_std, pa_med, pa_mad = means[1], stds[1], meds[1], mads[1]
        rna_mean, rna_std, rna_med, rna_mad = (
            means[2], stds[2], meds[2], mads[2],
        )
        rna_med_w = meds[3] if cfg.detect_med_shift else None
    else:
        # gate-only statistics: medians for [mvs_polya]/[med_shift], the
        # adapter MAD only when [real_range] needs it
        starts = jnp.stack([adapter_start, polya_start])
        ends = jnp.stack([adapter_end, polya_end])
        if cfg.detect_med_shift:
            starts = jnp.concatenate([starts, rna_start[None]])
            ends = jnp.concatenate([ends, ms_end[None]])
        gmeds, gmads = _range_medians(
            x, starts, ends, with_mad=cfg.real_signal_check
        )
        empty = ends <= starts
        gmeds = jnp.where(empty, 0.0, jnp.nan_to_num(gmeds))
        ad_med, pa_med = gmeds[0], gmeds[1]
        rna_med_w = gmeds[2] if cfg.detect_med_shift else None
        ad_mad = (
            jnp.where(empty[0], 0.0, jnp.nan_to_num(gmads[0]))
            if cfg.real_signal_check
            else jnp.zeros(B, jnp.float32)
        )
        zeros = jnp.zeros(B, jnp.float32)
        ad_mean = ad_std = zeros
        pa_mean = pa_std = pa_mad = zeros
        rna_mean = rna_std = rna_med = rna_mad = zeros

    # ---- fail taxonomy (lower code = earlier gate)
    adapter_len = adapter_end - adapter_start
    too_short_sig = in_lens < (cfg.min_obs_adapter + cfg.min_obs_polya)
    no_polya = ~found
    ad_too_short = found & (adapter_len < cfg.min_obs_adapter)
    ad_too_long = found & (adapter_len > cfg.max_obs_adapter)

    fail = jnp.zeros(B, jnp.int32)

    def set_fail(fail, cond, code):
        return jnp.where((fail == 0) & cond, jnp.int32(code), fail)

    fail = set_fail(fail, too_short_sig, 1)
    fail = set_fail(fail, sp_fail, 9)  # rna start peak not found
    fail = set_fail(fail, no_polya, 2)
    fail = set_fail(fail, ad_too_short, 3)
    fail = set_fail(fail, ad_too_long, 4)

    mvs_shift_val = jnp.zeros(B, jnp.float32)
    mvs_minvar_val = jnp.zeros(B, jnp.float32)
    if cfg.mvs_detect_check:
        # [mvs_polya] validation of the EXACT detected region at the
        # contract values (rna004_130bps@v1.0.toml:29-33): median shift
        # adapter->polyA >= median_shift_range lower bound; the *flattest*
        # var_window inside the polyA region <= pA_var_range upper bound
        # (the region may legitimately extend into noisier territory near
        # the RNA start); polyA mean / adapter median >=
        # pA_mean_adapter_med_scale_range lower bound.
        med_shift = pa_med - ad_med
        pa_var_mask = (pos >= polya_start[:, None]) & (
            pos + cfg.var_window <= polya_end[:, None]
        )
        min_pa_var = jnp.min(
            jnp.where(pa_var_mask, var_w, jnp.inf), axis=1
        )
        min_pa_var = jnp.where(jnp.isfinite(min_pa_var), min_pa_var, 0.0)
        pa_mask = (pos >= polya_start[:, None]) & (pos < polya_end[:, None])
        pa_mean_x = jnp.sum(jnp.where(pa_mask, x, 0.0), axis=1) / jnp.maximum(
            jnp.sum(pa_mask, axis=1), 1
        )
        mvs_bad = (
            (med_shift < cfg.median_shift_min)
            | (min_pa_var > cfg.polya_var_max)
            | (pa_mean_x < cfg.polya_scale * ad_med)
        )
        fail = set_fail(fail, mvs_bad, 5)
        mvs_shift_val, mvs_minvar_val = med_shift, min_pa_var

    if cfg.real_signal_check:
        # local range plausibility on the downsampled adapter region
        ds = cfg.downscale_factor
        Lds = L // ds
        xds = jnp.mean(xz[:, : Lds * ds].reshape(B, Lds, ds), axis=2)
        pds = jax.lax.broadcasted_iota(jnp.int32, (B, Lds), 1)
        lim = jnp.minimum(adapter_end, cfg.max_obs_local_range) // ds
        admask_ds = (pds >= adapter_start[:, None] // ds) & (pds < lim[:, None])
        wds = max(cfg.local_range_window // ds, 2)
        lo_r = -jax.lax.reduce_window(
            jnp.where(admask_ds, -xds, -jnp.inf), -jnp.inf, jax.lax.max,
            (1, wds), (1, 1), "VALID",
        )
        hi_r = jax.lax.reduce_window(
            jnp.where(admask_ds, xds, -jnp.inf), -jnp.inf, jax.lax.max,
            (1, wds), (1, 1), "VALID",
        )
        rng_ok_mask = admask_ds[:, : hi_r.shape[1]] & admask_ds[:, wds - 1 :]
        local_rng = jnp.where(rng_ok_mask, hi_r - lo_r, jnp.nan)
        med_rng = masked_median(
            jnp.nan_to_num(local_rng, nan=0.0), rng_ok_mask
        )
        rr_bad = (
            (med_rng < cfg.local_range[0])
            | (med_rng > cfg.local_range[1])
            | (ad_mad < cfg.adapter_mad_range[0])
            | (ad_mad > cfg.adapter_mad_range[1])
        )
        fail = set_fail(fail, rr_bad, 6)

    if cfg.detect_med_shift:
        fail = set_fail(
            fail, (rna_med_w - ad_med) < cfg.med_shift_min, 7
        )

    if cfg.detect_open_pores:
        op_mask = (pos >= adapter_start[:, None]) & (pos < adapter_end[:, None])
        frac_open = jnp.sum(
            jnp.where(op_mask & (x > cfg.open_pore_pa), 1.0, 0.0), axis=1
        ) / jnp.maximum(jnp.sum(op_mask, axis=1), 1)
        fail = set_fail(fail, frac_open > 0.5, 8)

    resolved = None
    if resolve_limit:
        lim = int(resolve_limit)
        whole = in_lens <= lim
        if _rl_info is None or cfg.detect_med_shift:
            # start_peak boundaries and the [med_shift] gate read up to
            # in_len — only whole reads are provably stable there
            resolved = whole
        else:
            if cfg.method == "cnn" and not (
                0 < cfg.cnn_input_cap <= lim
            ):
                raise ValueError(
                    "resolve_limit with method='cnn' requires a prefix-"
                    f"causal CNN: cnn_input_cap in (0, {lim}], got "
                    f"{cfg.cnn_input_cap}"
                )
            if lim < cfg.min_obs_adapter + cfg.var_window:
                raise ValueError(
                    "resolve_limit must cover the adapter-level proxy "
                    "window plus the rolling margin"
                )
            # Identity horizon of the zero-padded prefix run: rolling
            # stats at q match the full run iff q + var_window <= lim; the
            # poly(A)-end refinement reads up to pe + mean_window/2 +
            # llr_refine_window. One margin covers both.
            margin = max(
                cfg.var_window,
                cfg.mean_window // 2 + cfg.llr_refine_window,
            )
            c_ps, c_pe, c_has_end, a_start = _rl_info
            bound_ok = (
                found
                & c_has_end
                & (c_ps + cfg.min_obs_polya + margin <= lim)
                & (c_pe + margin <= lim)
                & (a_start + margin <= lim)
            )
            # prefix-stable outcomes: a pass, or a fail whose gate only
            # consulted the (prefix-confined) adapter/polyA regions.
            # "no polyA found" (2) and "signal too short" (1, subsumed by
            # whole) are NOT stable: more signal could change them.
            gate_fail = (
                (fail == 3)
                | (fail == 4)
                | (fail == 5)
                | (fail == 6)
                | (fail == 8)
            )
            resolved = whole | (bound_ok & ((fail == 0) | gate_fail))

    success = fail == 0
    return DetectArrays(
        success=success,
        fail_code=fail,
        adapter_start=adapter_start,
        adapter_end=adapter_end,
        polya_start=polya_start,
        polya_end=polya_end,
        polya_candidates=polya_candidates,
        adapter_mean=ad_mean,
        adapter_std=ad_std,
        adapter_med=ad_med,
        adapter_mad=ad_mad,
        polya_mean=pa_mean,
        polya_std=pa_std,
        polya_med=pa_med,
        polya_mad=pa_mad,
        rna_start=rna_start,
        rna_len=rna_end - rna_start,
        rna_mean=rna_mean,
        rna_std=rna_std,
        rna_med=rna_med,
        rna_mad=rna_mad,
        used_llr_fallback=jnp.zeros(B, bool),
        mvs_med_shift=mvs_shift_val,
        mvs_min_polya_var=mvs_minvar_val,
        # single-method pass: its own results double as the per-method
        # columns (the fallback wrapper overwrites these with the per-pass
        # values after merging)
        prim_adapter_start=adapter_start,
        prim_adapter_end=adapter_end,
        prim_polya_start=polya_start,
        prim_polya_end=polya_end,
        prim_fail=fail,
        llr_adapter_start=adapter_start,
        llr_adapter_end=adapter_end,
        llr_polya_start=polya_start,
        llr_polya_end=polya_end,
        llr_fail=fail,
        resolved=resolved,
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "with_stats", "resolve_limit")
)
def detect_boundaries_with_fallback(
    signals: jnp.ndarray,
    in_lens: jnp.ndarray,
    cfg: DetectConfig = DetectConfig(),
    cnn_params: dict | None = None,
    with_stats: bool = True,
    resolve_limit: int = 0,
) -> DetectArrays:
    """Primary detect + per-read LLR fallback (README.md:336-349).

    The reference re-runs failed reads through combined_detect_llr2; here
    the fixed-shape formulation runs the (cheap) LLR detector on the whole
    minibatch alongside the primary and selects it row-wise wherever the
    primary failed — no dynamic re-batching, one compiled program.

    with_stats=False skips the final region-summary statistics entirely
    (mean/std/median/MAD exist only as output columns; every fail gate
    already ran inside the candidate passes) — the decision lane uses it.
    """
    if cfg.method == "llr" or not cfg.fallback_to_llr:
        return detect_boundaries_batch(
            signals, in_lens, cfg, cnn_params, with_stats=with_stats,
            resolve_limit=resolve_limit,
        )
    # Two gate-only candidate passes (no summary statistics), then the full
    # region stats are computed once on the merged boundaries — statistics
    # are a pure function of (signal, start, end), so this equals selecting
    # the per-method stats row-wise while doing a third of the median work.
    # The CNN region prior is computed ONCE here and handed to both passes.
    cnn_region = None
    if cfg.method == "cnn" and cnn_params is not None:
        x32 = signals.astype(jnp.float32)
        B, L = x32.shape
        pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
        lens32 = in_lens.astype(jnp.int32)
        xz = jnp.where(pos < lens32[:, None], x32, 0.0)
        cnn_region = _cnn_region_mask(xz, lens32, cfg, cnn_params, pos, L)
    primary = detect_boundaries_batch(
        signals, in_lens, cfg, cnn_params, with_stats=False,
        resolve_limit=resolve_limit, cnn_region=cnn_region,
    )
    llr = detect_boundaries_batch(
        signals,
        in_lens,
        replace(cfg, method="llr", fallback_to_llr=False),
        with_stats=False,
        resolve_limit=resolve_limit,
        cnn_region=cnn_region,
    )
    use_llr = ~primary.success

    def sel(p, l):
        if p is None or l is None:
            return None
        cond = use_llr
        if p.ndim > 1:
            cond = cond.reshape((-1,) + (1,) * (p.ndim - 1))
        return jnp.where(cond, l, p)

    merged = DetectArrays(*[sel(p, l) for p, l in zip(primary, llr)])
    if resolve_limit:
        # a merged row is stage-1-resolved if the primary pass is provably
        # stable AND (it succeeded — the llr pass never enters the row — or
        # it stably failed and the selected llr row is itself stable)
        merged = merged._replace(
            resolved=primary.resolved
            & (primary.success | llr.resolved)
        )
    if not with_stats:
        return merged._replace(
            used_llr_fallback=use_llr,
            prim_adapter_start=primary.adapter_start,
            prim_adapter_end=primary.adapter_end,
            prim_polya_start=primary.polya_start,
            prim_polya_end=primary.polya_end,
            prim_fail=primary.fail_code,
            llr_adapter_start=llr.adapter_start,
            llr_adapter_end=llr.adapter_end,
            llr_polya_start=llr.polya_start,
            llr_polya_end=llr.polya_end,
            llr_fail=llr.fail_code,
        )
    x = signals.astype(jnp.float32)
    B, L = x.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    rna_end = in_lens.astype(jnp.int32)
    starts = jnp.stack(
        [merged.adapter_start, merged.polya_start, merged.rna_start]
    )
    ends = jnp.stack([merged.adapter_end, merged.polya_end, rna_end])
    # the adapter/polyA medians were already bisected by the gate-only
    # passes over the same [start, end) regions and row-selected into
    # `merged` — reuse them so the final stats launch only searches their
    # MADs plus the RNA region (4 bisections instead of 6)
    given_meds = jnp.stack(
        [merged.adapter_med, merged.polya_med, jnp.zeros(B, jnp.float32)]
    )
    means, stds, meds, mads = _region_stats_fused(
        x, pos, starts, ends, given_meds=given_meds, given=(True, True, False)
    )
    return merged._replace(
        used_llr_fallback=use_llr,
        # per-method results (README.md:443-446): each pass's raw
        # boundaries + fail code, pre-merge
        prim_adapter_start=primary.adapter_start,
        prim_adapter_end=primary.adapter_end,
        prim_polya_start=primary.polya_start,
        prim_polya_end=primary.polya_end,
        prim_fail=primary.fail_code,
        llr_adapter_start=llr.adapter_start,
        llr_adapter_end=llr.adapter_end,
        llr_polya_start=llr.polya_start,
        llr_polya_end=llr.polya_end,
        llr_fail=llr.fail_code,
        adapter_mean=means[0],
        adapter_std=stds[0],
        adapter_med=meds[0],
        adapter_mad=mads[0],
        polya_mean=means[1],
        polya_std=stds[1],
        polya_med=meds[1],
        polya_mad=mads[1],
        rna_mean=means[2],
        rna_std=stds[2],
        rna_med=meds[2],
        rna_mad=mads[2],
    )
