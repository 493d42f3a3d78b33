"""Detection result containers: struct-of-arrays, fixed shapes.

Capability parity with the reference's (absent) ADAPTed submodule contract,
reconstructed from its call sites: per-read DetectResults with success,
fail_reason, adapter/polyA boundaries and region summary statistics
(reference: warpdemux/sig_proc.py:400-418 consumers;
README.md:425-457 output column list).

The reference keeps one DetectResults object per read; here the whole
minibatch is one struct of (B,) arrays. Fail reasons are integer codes on
device, mapped to strings at the host boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# Integer fail codes (0 = success). Codes 10-13 reproduce the reference's
# own strings verbatim (warpdemux/sig_proc.py:476,508,540,556 — "event
# segmentation failed", "consensus query outlier", "signal/segment
# normalization failed"). Codes 1-9 belong to the detect stage, whose
# reference implementation (the ADAPTed submodule) is not present in the
# reference checkout — these strings are this framework's stable taxonomy
# for the same gates (README.md:425-457 documents only the column, not the
# vocabulary).
FAIL_REASONS = [
    "",  # 0: success
    "signal too short",  # 1
    "no polyA found",  # 2
    "adapter too short",  # 3
    "adapter too long",  # 4
    "mvs polya check failed",  # 5
    "real signal check failed",  # 6
    "med shift check failed",  # 7
    "open pore signal",  # 8
    "rna start peak not found",  # 9
    "event segmentation failed",  # 10
    "signal normalization failed",  # 11
    "segment normalization failed",  # 12
    "consensus query outlier",  # 13
]


def fail_code_to_reason(codes: np.ndarray) -> list[str]:
    return [FAIL_REASONS[int(c)] for c in codes]


class DetectArrays(NamedTuple):
    """Batched detection results; every field is a (B,) array."""

    success: jnp.ndarray  # bool
    fail_code: jnp.ndarray  # int32 into FAIL_REASONS
    adapter_start: jnp.ndarray  # int32 sample index
    adapter_end: jnp.ndarray  # int32
    polya_start: jnp.ndarray  # int32
    polya_end: jnp.ndarray  # int32
    polya_candidates: jnp.ndarray  # int32
    adapter_mean: jnp.ndarray
    adapter_std: jnp.ndarray
    adapter_med: jnp.ndarray
    adapter_mad: jnp.ndarray
    polya_mean: jnp.ndarray
    polya_std: jnp.ndarray
    polya_med: jnp.ndarray
    polya_mad: jnp.ndarray
    rna_start: jnp.ndarray  # int32 (rna_preloaded_start)
    rna_len: jnp.ndarray  # int32 (rna_preloaded_len)
    rna_mean: jnp.ndarray
    rna_std: jnp.ndarray
    rna_med: jnp.ndarray
    rna_mad: jnp.ndarray
    # method diagnostics (README.md:443-446 per-method results): True where
    # the final boundaries came from the LLR fallback rather than the
    # primary method
    used_llr_fallback: jnp.ndarray = None
    # [mvs_polya] check values on these boundaries (README.md:443-446 mvs_*
    # results): adapter->polyA median shift and the flattest var_window
    # variance inside the polyA region
    mvs_med_shift: jnp.ndarray = None
    mvs_min_polya_var: jnp.ndarray = None
    # per-method results (README.md:443-446 llr_*/cnn_* columns): the raw
    # boundaries + fail code each detection method produced BEFORE the
    # fallback merge, so method behavior can be compared post-hoc without
    # re-running detection. prim_* = the configured primary method; llr_* =
    # the LLR pass (identical to prim_* when llr IS the primary).
    prim_adapter_start: jnp.ndarray = None
    prim_adapter_end: jnp.ndarray = None
    prim_polya_start: jnp.ndarray = None
    prim_polya_end: jnp.ndarray = None
    prim_fail: jnp.ndarray = None
    llr_adapter_start: jnp.ndarray = None
    llr_adapter_end: jnp.ndarray = None
    llr_polya_start: jnp.ndarray = None
    llr_polya_end: jnp.ndarray = None
    llr_fail: jnp.ndarray = None
    # Stage-1 resolution flag (two-stage wire feed): True where this result
    # is PROVABLY what detection over the full preload would return, because
    # either the whole read fit the stage-1 prefix or every window the
    # decision consulted lies inside it (detect_boundaries_batch
    # resolve_limit; see pipeline/step.py make_twostage_decision_step).
    # None unless a resolve_limit was requested.
    resolved: jnp.ndarray = None

    def to_summary_frame(
        self, read_ids, full_lengths, in_lengths, primary_method: str = "llr"
    ):
        """Rows for detected_boundaries/failed_reads CSVs
        (column contract: README.md:425-457; per-method columns use the
        configured primary method's name as prefix, :443-446), as an
        io.writers Frame."""
        g = lambda a: np.asarray(a)
        B = len(read_ids)
        zf = lambda a: g(a) if a is not None else np.zeros(B, np.float32)
        cols = {
            "read_id": np.asarray(read_ids, object),
            "signal_len": np.asarray(full_lengths),
            "preloaded": np.asarray(in_lengths),
            "adapter_start": g(self.adapter_start),
            "adapter_end": g(self.adapter_end),
            "adapter_len": g(self.adapter_end) - g(self.adapter_start),
            "adapter_mean": g(self.adapter_mean),
            "adapter_std": g(self.adapter_std),
            "adapter_med": g(self.adapter_med),
            "adapter_mad": g(self.adapter_mad),
            "polya_start": g(self.polya_start),
            "polya_end": g(self.polya_end),
            "polya_len": g(self.polya_end) - g(self.polya_start),
            "polya_mean": g(self.polya_mean),
            "polya_std": g(self.polya_std),
            "polya_med": g(self.polya_med),
            "polya_mad": g(self.polya_mad),
            "polya_candidates": g(self.polya_candidates),
            "rna_preloaded_start": g(self.rna_start),
            "rna_preloaded_len": g(self.rna_len),
            "rna_preloaded_mean": g(self.rna_mean),
            "rna_preloaded_std": g(self.rna_std),
            "rna_preloaded_med": g(self.rna_med),
            "rna_preloaded_mad": g(self.rna_mad),
            "used_llr_fallback": (
                g(self.used_llr_fallback)
                if self.used_llr_fallback is not None
                else np.zeros(B, bool)
            ),
            "mvs_med_shift": zf(self.mvs_med_shift),
            "mvs_min_polya_var": zf(self.mvs_min_polya_var),
        }
        # per-method result columns — only when the detect pass recorded them
        if self.llr_fail is not None:
            methods = [
                ("llr", self.llr_adapter_start, self.llr_adapter_end,
                 self.llr_polya_start, self.llr_polya_end, self.llr_fail),
            ]
            if primary_method != "llr" and self.prim_fail is not None:
                methods.insert(0, (
                    primary_method, self.prim_adapter_start,
                    self.prim_adapter_end, self.prim_polya_start,
                    self.prim_polya_end, self.prim_fail,
                ))
            for name, a0, a1, p0, p1, fc in methods:
                cols[f"{name}_adapter_start"] = g(a0)
                cols[f"{name}_adapter_end"] = g(a1)
                cols[f"{name}_polya_start"] = g(p0)
                cols[f"{name}_polya_end"] = g(p1)
                cols[f"{name}_fail_reason"] = fail_code_to_reason(g(fc))
        cols["fail_reason"] = fail_code_to_reason(g(self.fail_code))
        return cols
