"""The in-repo Arrow IPC file reader/writer (io/arrow_ipc.py) against
pyarrow, which is a test-only dependency."""

import uuid

import numpy as np
import pytest

from warpdemux_tpu.io import arrow_ipc

pa = pytest.importorskip("pyarrow")
ipc = pytest.importorskip("pyarrow.ipc")


def _pyarrow_file(table, **options) -> bytes:
    sink = pa.BufferOutputStream()
    opts = ipc.IpcWriteOptions(**options)
    with ipc.new_file(sink, table.schema, options=opts) as w:
        w.write_table(table, max_chunksize=3)  # several record batches
    return sink.getvalue().to_pybytes()


def _as_python(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


_N = 7
_RNG = np.random.default_rng(0)
COLUMNS = {
    "uint8": pa.array(_RNG.integers(0, 255, _N), pa.uint8()),
    "uint16": pa.array(_RNG.integers(0, 65535, _N), pa.uint16()),
    "uint32": pa.array(_RNG.integers(0, 2**32 - 1, _N), pa.uint32()),
    "uint64": pa.array(_RNG.integers(0, 2**62, _N), pa.uint64()),
    "int16": pa.array(_RNG.integers(-3000, 3000, _N), pa.int16()),
    "int64": pa.array(_RNG.integers(-(2**40), 2**40, _N), pa.int64()),
    "float32": pa.array(_RNG.normal(size=_N), pa.float32()),
    "float64": pa.array(_RNG.normal(size=_N), pa.float64()),
    "bool": pa.array(_RNG.random(_N) < 0.5, pa.bool_()),
    "utf8": pa.array([f"read_{i}" * (i % 3) for i in range(_N)], pa.string()),
    "binary": pa.array([bytes([i]) * i for i in range(_N)], pa.binary()),
    "large_binary": pa.array([bytes(range(i)) for i in range(_N)], pa.large_binary()),
    "uuid": pa.array([uuid.UUID(int=i).bytes for i in range(_N)], pa.binary(16)),
    "list_uint64": pa.array([list(range(i)) for i in range(_N)], pa.list_(pa.uint64())),
    "large_list_int32": pa.array(
        [[i, -i] for i in range(_N)], pa.large_list(pa.int32())
    ),
    # MinKNOW dictionary-encodes end_reason / pore_type / run_info
    "dict_end_reason": pa.array(
        ["signal_positive", "unblock_mux_change", "signal_positive", "unknown",
         "data_service_unblock_mux_change", "signal_positive", "unknown"]
    ).dictionary_encode().cast(pa.dictionary(pa.int16(), pa.string())),
    "dict_int8": pa.array(list("abacaba")).dictionary_encode().cast(
        pa.dictionary(pa.int8(), pa.string())
    ),
    "timestamp_ms": pa.array(
        _RNG.integers(0, 2**40, _N), pa.timestamp("ms", tz="UTC")
    ),
}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_reader_matches_pyarrow_column(name):
    """Each column type decodes to pyarrow's values, with a struct and a map
    column (skipped, never decoded) placed before it."""
    arr = COLUMNS[name]
    table = pa.table(
        {
            "struct": pa.array([{"a": i, "b": str(i)} for i in range(_N)]),
            "map": pa.array(
                [[("k", str(i))] for i in range(_N)],
                pa.map_(pa.string(), pa.string()),
            ),
            name: arr,
            "after": pa.array(np.arange(_N), pa.uint16()),
        }
    )
    t = arrow_ipc.read_file(_pyarrow_file(table))
    assert t.names == table.schema.names
    assert len(t) == _N
    want = table.column(name)
    if pa.types.is_dictionary(arr.type):
        want = want.cast(pa.string())
    if pa.types.is_timestamp(arr.type):
        want = want.cast(pa.int64())
    got = [_as_python(v) for v in t.column(name)]
    assert got == want.to_pylist()
    assert list(t.column("after")) == list(range(_N))


def test_compressed_bodies_are_refused():
    table = pa.table({"x": pa.array(np.arange(10), pa.int32())})
    data = _pyarrow_file(table, compression="zstd")
    with pytest.raises(ValueError, match="compress"):
        arrow_ipc.read_file(data).column("x")


def test_nulls_in_a_decoded_column_are_refused():
    table = pa.table({"x": pa.array([1, None, 3], pa.int32())})
    with pytest.raises(ValueError, match="nulls"):
        arrow_ipc.read_file(_pyarrow_file(table)).column("x")


SPECS = [
    ("u8", ("int", 8, False), [0, 1, 255]),
    ("i64", ("int", 64, True), [-(2**60), 0, 5]),
    ("f32", ("float", 32), [1.5, -2.25, 0.0]),
    ("f64", ("float", 64), [4000.0, 1e-300, -7.0]),
    ("s", ("utf8",), ["signal_positive", "", "naïve"]),
    ("lb", ("large_binary",), [b"\x00\x01", b"", b"xyz"]),
    ("id", ("fixed_size_binary", 16), [uuid.UUID(int=i).bytes for i in range(3)]),
    ("rows", ("list", ("int", 64, False)), [[0, 1], [], [2]]),
]


@pytest.mark.parametrize("reader", ["in_repo", "pyarrow"])
def test_writer_round_trip(reader):
    """A file from the in-repo writer reads back identically through the
    in-repo reader and through pyarrow."""
    data = arrow_ipc.write_file(SPECS)
    if reader == "in_repo":
        t = arrow_ipc.read_file(data)
        got = {n: [_as_python(v) for v in t.column(n)] for n, _, _ in SPECS}
    else:
        got = ipc.open_file(pa.BufferReader(data)).read_all().to_pydict()
    for name, spec, values in SPECS:
        want = values
        if spec == ("float", 32):
            want = np.asarray(values, np.float32).tolist()
        assert got[name] == want, name


def test_pod5_round_trip_through_the_in_repo_container(tmp_path):
    from warpdemux_tpu.io.pod5 import Pod5Reader
    from warpdemux_tpu.io.pod5_writer import SIGNAL_CHUNK, write_pod5

    rng = np.random.default_rng(5)
    reads = [
        dict(
            read_id=str(uuid.UUID(int=7 + i)),
            signal=(500 + rng.normal(0, 40, n)).astype(np.int16),
            calibration_offset=-240.0 + i,
            calibration_scale=0.17,
            channel=3 + i,
            end_reason="signal_positive" if i else "unblock_mux_change",
        )
        for i, n in enumerate([5000, SIGNAL_CHUNK + 123, 1])
    ]
    path = write_pod5(tmp_path / "x.pod5", reads, sample_rate=5000.0)
    with Pod5Reader(path) as r:
        assert r.sample_rate == 5000.0
        got = list(r.reads())
    assert [g.read_id for g in got] == [rd["read_id"] for rd in reads]
    for g, rd in zip(got, reads):
        np.testing.assert_array_equal(g.signal_adc(), rd["signal"])
        assert g.num_samples == rd["signal"].size
        assert g.channel == rd["channel"]
        assert g.end_reason == rd["end_reason"]
        assert g.calibration_offset == np.float32(rd["calibration_offset"])
