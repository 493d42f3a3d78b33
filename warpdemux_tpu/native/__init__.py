"""ctypes bindings for the native host kernels (wdx_native.cpp).

The shared library is built on demand with `make` (g++, links the zstd
runtime libzstd.so.1) the first time it is requested. The pod5 ingest
needs it: a failed build raises, with the compiler's message. Exposes:

- vbz_decode / vbz_encode: the pod5 signal codec (zstd over
  streamvbyte-16 zig-zag deltas) — the ingest hot path,
- zstd_decompress: plain zstd frames (the compressed-wire feed),
- windowed_t_test, segment_means: the reference Cython segmentation
  kernels (_c_segmentation.pyx) for the live lane's single-read host path,
- mvs_scan: streaming mean-variance-shift polyA scan for live chunks.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_LIB_PATH = _DIR / "libwdx_native.so"
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> None:
    try:
        subprocess.run(
            ["make", "-s"], cwd=_DIR, check=True, capture_output=True,
            text=True, timeout=120,
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {_LIB_PATH.name} failed:\n{e.stderr}") from e
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {_LIB_PATH.name} failed: {e}") from e


def _load():
    """The loaded library; builds it on first use. Raises if it cannot."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            if not _LIB_PATH.exists():
                _build()
            lib = ctypes.CDLL(str(_LIB_PATH))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            raise RuntimeError(_build_error) from e
        lib.zstd_decompress.restype = ctypes.c_int64
        lib.zstd_decompress.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.vbz_decode.restype = ctypes.c_int
        lib.vbz_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.vbz_encode_bound.restype = ctypes.c_int64
        lib.vbz_encode_bound.argtypes = [ctypes.c_int64]
        lib.vbz_encode.restype = ctypes.c_int64
        lib.vbz_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.windowed_t_test.restype = None
        lib.windowed_t_test.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.segment_means.restype = None
        lib.segment_means.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.mvs_scan.restype = ctypes.c_int64
        lib.mvs_scan.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_double,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        _load()
    except RuntimeError:
        return False
    return True


def zstd_decompress(payload: bytes, max_output_size: int) -> bytes:
    """Decompress one zstd frame of at most max_output_size bytes."""
    out = np.empty(max_output_size, np.uint8)
    n = _load().zstd_decompress(
        payload, len(payload),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
    )
    if n < 0:
        raise ValueError("zstd_decompress failed")
    return out[:n].tobytes()


def vbz_decode(payload: bytes, n: int) -> np.ndarray:
    """Decode a VBZ payload to int16 ADC."""
    lib = _load()
    out = np.empty(n, np.int16)
    scratch = np.empty(4 * n + 64, np.uint8)
    rc = lib.vbz_decode(
        payload,
        len(payload),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scratch.size,
    )
    if rc != 0:
        raise ValueError(f"vbz_decode failed (rc={rc})")
    return out


def vbz_encode(signal: np.ndarray) -> bytes:
    lib = _load()
    sig = np.ascontiguousarray(signal, np.int16)
    n = sig.size
    bound = lib.vbz_encode_bound(n)
    out = np.empty(bound, np.uint8)
    scratch = np.empty((n + 7) // 8 + 2 * n + 64, np.uint8)
    size = lib.vbz_encode(
        sig.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.size,
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scratch.size,
    )
    if size < 0:
        raise ValueError(f"vbz_encode failed (rc={size})")
    return out[:size].tobytes()


def windowed_t_test(x: np.ndarray, w: int) -> np.ndarray:
    """Reference Cython t-test scores for one read."""
    lib = _load()
    xd = np.ascontiguousarray(x, np.float64)
    n = xd.size
    out = np.zeros(max(n - 2 * w, 0), np.float64)
    if out.size:
        lib.windowed_t_test(
            xd.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n,
            w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    return out


def segment_means(x: np.ndarray, cpts: np.ndarray) -> np.ndarray:
    lib = _load()
    xd = np.ascontiguousarray(x, np.float64)
    cp = np.ascontiguousarray(cpts, np.int64)
    out = np.zeros(max(cp.size - 1, 0), np.float64)
    if out.size:
        lib.segment_means(
            xd.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            xd.size,
            cp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cp.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    return out


def mvs_scan(x: np.ndarray, w: int, thr_mean: float, thr_var: float) -> int:
    lib = _load()
    xf = np.ascontiguousarray(x, np.float32)
    return int(
        lib.mvs_scan(
            xf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            xf.size,
            w,
            thr_mean,
            thr_var,
        )
    )
