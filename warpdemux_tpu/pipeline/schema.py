"""Packed step-output layout: ONE schema table both sides read.

The demux step returns every per-read scalar column stacked into two
(B, C) buffers (one int32, one float32): fewer, larger device-to-host
transfers (see pipeline/step.py PackedStepOutput). Round 2 hand-indexed those column
offsets in two places (pack and unpack), which silently corrupts every
downstream field the moment a column is added. This module is the single
definition: `pack()` and `unpack()` iterate the same ordered spec, so the
layout cannot drift.

A spec entry is (name, width): width 1 for scalar columns, k/kc for the
variable-width blocks (dwell times, fingerprint, class probabilities).
"""

from __future__ import annotations

from typing import Mapping

import jax.numpy as jnp
import numpy as np

# scalar int32 columns, in packed order (widths filled in PackSchema)
INT_COLS = (
    "adapter_start",
    "adapter_end",
    "polya_start",
    "polya_end",
    "polya_candidates",
    "rna_start",
    "rna_len",
    "det_fail",
    "used_llr_fallback",
    "fpt_ok",
    "merged_fail",
    # per-method results (README.md:443-446): primary pass + LLR pass
    "prim_adapter_start",
    "prim_adapter_end",
    "prim_polya_start",
    "prim_polya_end",
    "prim_fail",
    "llr_adapter_start",
    "llr_adapter_end",
    "llr_polya_start",
    "llr_polya_end",
    "llr_fail",
)

FLOAT_COLS = (
    "adapter_mean",
    "adapter_std",
    "adapter_med",
    "adapter_mad",
    "polya_mean",
    "polya_std",
    "polya_med",
    "polya_mad",
    "rna_mean",
    "rna_std",
    "rna_med",
    "rna_mad",
    "mvs_med_shift",
    "mvs_min_polya_var",
    "adapter_dt_med",
    "adapter_dt_mad",
    "adapter_event_mean",
    "adapter_event_std",
    "adapter_event_med",
    "adapter_event_mad",
)


class PackSchema:
    """Column layout for a (k = barcode_num_events, kc = n_classes) step."""

    def __init__(self, k: int, kc: int):
        self.k, self.kc = int(k), int(kc)
        self.int_spec = [(c, 1) for c in INT_COLS] + [("dwell", self.k)]
        self.float_spec = [(c, 1) for c in FLOAT_COLS] + [
            ("fpt", self.k),
            ("probs", self.kc),
        ]
        self.int_slices = self._slices(self.int_spec)
        self.float_slices = self._slices(self.float_spec)
        self.int_width = sum(w for _, w in self.int_spec)
        self.float_width = sum(w for _, w in self.float_spec)

    @classmethod
    def from_buffers(cls, big_i, big_f) -> "PackSchema":
        """Recover the schema from packed buffer widths: the scalar column
        counts are fixed by the spec, so k and kc fall out of the shapes."""
        k = big_i.shape[1] - len(INT_COLS)
        kc = big_f.shape[1] - len(FLOAT_COLS) - k
        if k < 0 or kc < 0:
            raise ValueError(
                f"buffer widths {big_i.shape[1]}/{big_f.shape[1]} are too "
                "small for the packed schema"
            )
        return cls(k, kc)

    @staticmethod
    def _slices(spec):
        out, off = {}, 0
        for name, w in spec:
            out[name] = slice(off, off + w)
            off += w
        return out

    # ---- device side ----------------------------------------------------
    def pack(self, values: Mapping[str, jnp.ndarray], dtype) -> jnp.ndarray:
        """Concatenate `values` into one (B, C) buffer in spec order.

        Every spec name must be present; scalars may be (B,) or (B, 1)."""
        spec = self.int_spec if dtype == jnp.int32 else self.float_spec
        parts = []
        for name, w in spec:
            a = values[name].astype(dtype)
            if a.ndim == 1:
                a = a[:, None]
            if a.shape[1] != w:
                raise ValueError(
                    f"column {name!r}: got width {a.shape[1]}, schema says {w}"
                )
            parts.append(a)
        return jnp.concatenate(parts, axis=1)

    # ---- host side --------------------------------------------------------
    def unpack(self, big: np.ndarray, dtype) -> dict[str, np.ndarray]:
        """Split one fetched buffer back into named columns (scalars as
        (B,), blocks as (B, w))."""
        spec = self.int_spec if dtype == np.int32 else self.float_spec
        slices = self.int_slices if dtype == np.int32 else self.float_slices
        width = self.int_width if dtype == np.int32 else self.float_width
        if big.shape[1] != width:
            raise ValueError(
                f"buffer width {big.shape[1]} != schema width {width}"
            )
        out = {}
        for name, w in spec:
            col = big[:, slices[name]]
            out[name] = col[:, 0] if w == 1 else col
        return out
