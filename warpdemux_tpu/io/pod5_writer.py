"""Minimal pod5 writer: VBZ-compressed signal in embedded Arrow tables.

Produces the same container shape our reader consumes (signature +
embedded Arrow IPC files for the signal / reads / run-info tables with
VBZ-compressed signal chunks). Used for synthetic test fixtures and the
live pod5-watcher integration tests — the upstream test pod5s are
missing-blob assets in the reference checkout, so the framework generates
its own.
"""

from __future__ import annotations

import uuid as uuid_mod
from pathlib import Path

import numpy as np

from warpdemux_tpu.io import arrow_ipc, vbz

_POD5_SIGNATURE = b"\x8bPOD\r\n\x1a\n"
SIGNAL_CHUNK = 102400  # samples per signal row (pod5 default scale)
_U8, _U16, _U32, _U64 = (("int", b, False) for b in (8, 16, 32, 64))


def write_pod5(path: str | Path, reads: list[dict], sample_rate: float = 4000.0):
    """Write reads to a pod5 container.

    Each read dict: read_id (uuid str; generated if absent), signal (int16
    ADC), calibration_offset (float), calibration_scale (float), channel,
    well, end_reason, num_minknow_events.
    """
    sig_ids, sig_payloads, sig_samples = [], [], []
    r_ids, r_rows, r_nsamp, r_chan, r_well = [], [], [], [], []
    r_off, r_scale, r_endr, r_mk = [], [], [], []

    row_idx = 0
    for rd in reads:
        rid = rd.get("read_id") or str(uuid_mod.uuid4())
        sig = np.asarray(rd["signal"], np.int16)
        rows = []
        for s in range(0, max(sig.size, 1), SIGNAL_CHUNK):
            chunk = sig[s : s + SIGNAL_CHUNK]
            sig_ids.append(uuid_mod.UUID(rid).bytes)
            sig_payloads.append(vbz.encode(chunk))
            sig_samples.append(len(chunk))
            rows.append(row_idx)
            row_idx += 1
        r_ids.append(uuid_mod.UUID(rid).bytes)
        r_rows.append(rows)
        r_nsamp.append(int(sig.size))
        r_chan.append(int(rd.get("channel", 1)))
        r_well.append(int(rd.get("well", 1)))
        r_off.append(float(rd.get("calibration_offset", -240.0)))
        r_scale.append(float(rd.get("calibration_scale", 0.1755)))
        r_endr.append(str(rd.get("end_reason", "signal_positive")))
        r_mk.append(int(rd.get("num_minknow_events", sig.size // 10)))

    signal_t = [
        ("read_id", ("fixed_size_binary", 16), sig_ids),
        ("signal", ("large_binary",), sig_payloads),
        ("samples", _U32, sig_samples),
    ]
    reads_t = [
        ("read_id", ("fixed_size_binary", 16), r_ids),
        ("signal", ("list", _U64), r_rows),
        ("num_samples", _U64, r_nsamp),
        ("channel", _U16, r_chan),
        ("well", _U8, r_well),
        ("calibration_offset", ("float", 32), r_off),
        ("calibration_scale", ("float", 32), r_scale),
        ("end_reason", ("utf8",), r_endr),
        ("num_minknow_events", _U64, r_mk),
    ]
    runinfo_t = [("sample_rate", ("float", 64), [sample_rate])]

    blob = _POD5_SIGNATURE + b"".join(
        arrow_ipc.write_file(t) for t in (signal_t, reads_t, runinfo_t)
    )
    Path(path).write_bytes(blob)
    return path
