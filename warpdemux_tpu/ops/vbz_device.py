"""On-device VBZ inner-layout decode: the compressed wire format.

pod5 signal payloads are zstd( keys || data ) where `keys` has one bit per
sample (0 -> 1 byte, 1 -> 2 bytes little-endian) and `data` holds the
zig-zag-coded int16 deltas at variable width (io/vbz.py). The host must
zstd-decompress anyway — but the *inner* layout (keys + data, typically
~11.5 KB per 10k-sample read vs 20 KB of raw int16) can cross the
host->device link as-is and be decoded by the device:

    bits    = unpack(keys)                  (B, L)   shifts/masks
    offsets = exclusive_cumsum(bits + 1)    (B, L)   i32
    lo, hi  = data[offsets], data[offsets+1]         row gathers
    value   = lo | (hi << 8) where wide
    delta   = zigzag^-1(value);  adc = cumsum(delta)

This shrinks the transfer by ~1.7x on top of the int16 halving — the
pipeline's dominant cost on bandwidth-limited links — for ~one gather and
two cumsums of device work. Bit-exact with io/vbz.decode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n_samples",))
def vbz_decode_batch(
    keys: jnp.ndarray,  # (B, ceil(n/8)) uint8
    data: jnp.ndarray,  # (B, D) uint8, zero-padded
    n_samples: int,
) -> jnp.ndarray:
    """Decode a batch of VBZ inner layouts to int32 ADC counts (B, n)."""
    B = keys.shape[0]
    n = n_samples
    # unpack bits LSB-first: bit i of byte i//8
    byte = jnp.repeat(keys, 8, axis=1)[:, :n].astype(jnp.int32)
    shift = jnp.tile(jnp.arange(8, dtype=jnp.int32), (n + 7) // 8)[:n]
    bits = (byte >> shift[None, :]) & 1  # (B, n)

    nbytes = bits + 1
    offs = jnp.cumsum(nbytes, axis=1) - nbytes  # exclusive cumsum
    D = data.shape[1]
    lo = jnp.take_along_axis(
        data, jnp.clip(offs, 0, D - 1), axis=1
    ).astype(jnp.int32)
    hi = jnp.take_along_axis(
        data, jnp.clip(offs + 1, 0, D - 1), axis=1
    ).astype(jnp.int32)
    val = jnp.where(bits == 1, lo | (hi << 8), lo)
    delta = (val >> 1) ^ -(val & 1)
    return jnp.cumsum(delta, axis=1)


def inner_layout_from_adc(sig: np.ndarray) -> bytes:
    """Build the VBZ inner layout (keys || data) for int16 samples on the
    host (numpy; used for synthetic benches and the multi-chunk slow path
    where pod5 rows must be re-based)."""
    sig = np.asarray(sig, np.int32)
    deltas = np.diff(sig, prepend=np.int32(0))
    zz = ((deltas << 1) ^ (deltas >> 31)).astype(np.uint32)
    if np.any(zz > 0xFFFF):
        raise ValueError("delta out of int16 zig-zag range")
    zz = zz.astype(np.uint16)
    n = len(zz)
    bits = (zz > 0xFF).astype(np.uint8)
    keys = np.packbits(bits, bitorder="little")
    nbytes = bits.astype(np.int64) + 1
    offs = np.concatenate([[0], np.cumsum(nbytes)[:-1]])
    data = np.zeros(int(nbytes.sum()), np.uint8)
    data[offs] = zz & 0xFF
    wide = bits == 1
    data[offs[wide] + 1] = zz[wide] >> 8
    return keys.tobytes() + data.tobytes()


# bytes-per-uint8 popcount LUT (wide samples carry 2 data bytes; counting
# key bits gives the data-stream offset of any sample prefix in O(klen))
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)

# fine 128-byte rungs near the observed sizes (measured stage-1 off1 max:
# ~7240 synthetic, ~7420 real at stage1_len=7168 — wide-sample rate ~1-3%),
# coarser above; each rung is one compile variant of the (tiny) decode
# program only, the fused chain is fixed-shape
_D1_LADDER = (
    7168, 7296, 7424, 7552, 7680, 7936, 8192, 8704, 9216, 10240, 12288,
    14336,
)
_DT_LADDER = (2048, 2560, 2816, 2944, 3072, 3584, 4096, 5120, 5888)
_ROW_LADDER = (64, 128, 256, 512)


def _ladder_pick(ladder, need):
    for v in ladder:
        if v >= need:
            return v
    return -(-need // 256) * 256


def split_wire_host(
    keys: np.ndarray,  # (B, klen) u8 full-wire keys
    data: np.ndarray,  # (B, D) u8 full-wire data
    in_lens: np.ndarray,
    stage1_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stage-1 slice of a full-wire VBZ batch (two-stage preload).

    The inner layout is a prefix-closed stream: the first `stage1_len`
    samples occupy keys[:, :stage1_len/8] and data[:, :off1) where
    off1 = min(in_len, stage1_len) + popcount(stage-1 keys). Returns
    (keys1, data1, off1) with data1 width from a fixed ladder — no
    per-row repacking, just slices of the arrays the zstd step already
    produced. (Reference preload contract: file_proc.py:227-279; this is
    the wire-thinning the reference cannot do because its preload ships
    decoded float32.)
    """
    if stage1_len % 8:
        raise ValueError("stage1_len must be a multiple of 8")
    klen1 = stage1_len // 8
    keys1 = np.ascontiguousarray(keys[:, :klen1])
    n_wide1 = _POPCOUNT[keys1].sum(axis=1, dtype=np.int64)
    off1 = np.minimum(in_lens.astype(np.int64), stage1_len) + n_wide1
    d1 = _ladder_pick(_D1_LADDER, int(off1.max(initial=1)))
    data1 = np.ascontiguousarray(data[:, :d1])
    return keys1, data1, off1


def pack_tails_host(
    keys: np.ndarray,
    data: np.ndarray,
    in_lens: np.ndarray,
    off1: np.ndarray,  # from split_wire_host
    rows: np.ndarray,  # unresolved row indices (host order preserved)
    stage1_len: int,
    n_samples: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tail wire for the unresolved rows: samples [stage1_len, in_len).

    Returns (rows_padded, keys_t, data_t): row count padded to a fixed
    ladder with the sentinel B (scatter mode='drop' discards it on
    device), data width from a fixed ladder. The tail deltas are the
    original stream bytes — decode restores absolute ADC by adding the
    stage-1 row's last sample (pipeline/step.py _assemble).
    """
    B = keys.shape[0]
    klen1 = stage1_len // 8
    klen = (n_samples + 7) // 8
    rows = np.asarray(rows, np.int64)
    bu = _ladder_pick(_ROW_LADDER, max(len(rows), 1)) if len(rows) <= 512 else B
    bu = min(bu, B)
    keys_sel = keys[rows, klen1:klen]
    n_wide = _POPCOUNT[keys[rows, :klen]].sum(axis=1, dtype=np.int64)
    end = np.minimum(in_lens[rows].astype(np.int64), n_samples) + n_wide
    sizes = end - off1[rows]
    dt = _ladder_pick(_DT_LADDER, int(sizes.max(initial=1)))
    keys_t = np.zeros((bu, klen - klen1), np.uint8)
    data_t = np.zeros((bu, dt), np.uint8)
    rows_out = np.full(bu, B, np.int32)
    for j, r in enumerate(rows):
        keys_t[j] = keys_sel[j]
        seg = data[r, off1[r] : end[j]]
        data_t[j, : seg.size] = seg
        rows_out[j] = r
    return rows_out, keys_t, data_t


def pack_inner_host(
    payloads: list[bytes | None],
    n_samples: int,
    data_width: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack zstd-decompressed VBZ payload bodies into fixed (B, k) keys and
    (B, data_width) data arrays (host side; zero padding past each read).

    `payloads` entries are the raw `keys || data` bytes for exactly
    n_samples samples (or None for empty rows)."""
    B = len(payloads)
    klen = (n_samples + 7) // 8
    keys = np.zeros((B, klen), np.uint8)
    data = np.zeros((B, data_width), np.uint8)
    for i, body in enumerate(payloads):
        if body is None:
            continue
        kb = np.frombuffer(body, np.uint8, count=klen)
        db = np.frombuffer(body, np.uint8, offset=klen)
        keys[i] = kb
        m = min(db.size, data_width)
        data[i, :m] = db[:m]
    return keys, data
