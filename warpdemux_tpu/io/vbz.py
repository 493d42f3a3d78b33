"""VBZ signal codec (the pod5 signal compression): zstd over
streamvbyte-16 with zig-zag delta encoding.

Decode layout (n = sample count):
  raw = zstd_decompress(payload)
  keys = raw[: ceil(n/8)]          1 bit per value (LSB-first): 0 -> 1 byte,
                                   1 -> 2 bytes (little-endian)
  data = raw[ceil(n/8):]           variable-width values
  value -> zig-zag decode -> cumulative sum -> int16 ADC counts

Both directions run in the native library (warpdemux_tpu/native, one pass,
no temporaries); `ops/vbz_device.inner_layout_from_adc` is the numpy
reference of the inner layout.
"""

from __future__ import annotations

import numpy as np

from warpdemux_tpu import native


def decode(payload: bytes, n: int) -> np.ndarray:
    """Decode a VBZ-compressed signal chunk into int16 ADC counts."""
    if n == 0:
        return np.zeros(0, np.int16)
    return native.vbz_decode(payload, n)


def encode(signal: np.ndarray) -> bytes:
    """Inverse of decode (synthetic pod5 files, tests)."""
    return native.vbz_encode(signal)
