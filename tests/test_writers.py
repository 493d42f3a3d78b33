"""csv.gz table writers (io/writers.py) and the run pipeline's helpers that
replaced pandas: text identical to pandas' to_csv, shard re-chunking, the
device-count rule and the compile-cache directory rule."""

import gzip
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from warpdemux_tpu.io import writers

REPO = Path(__file__).resolve().parents[1]

COLUMNS = {
    "float32": np.array([0.1, 1e-5, 123456789.123, np.nan, 1.0, -0.0], np.float32),
    "float64": np.array([0.1, 1e-5, 123456789.123, np.nan, np.inf, 1e20]),
    "rounded": np.round(np.array([0.12345, 0.5, 0.99999, 1, 0, 0.25], np.float32), 3),
    "int32": np.array([1, -2, 3, 4, 5, 2**31 - 1], np.int32),
    "int64": np.array([0, 1, -(2**40), 4, 5, 6], np.int64),
    "bool": np.array([True, False, True, True, False, False]),
    "str": np.array(["x", "a,b", 'q"t', "", "nan", "adapter too long"], object),
}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_csv_text_matches_pandas(tmp_path, name):
    pd = pytest.importorskip("pandas")
    frame = {"#read_id": np.array([f"r{i}" for i in range(6)], object),
             name: COLUMNS[name]}
    path = writers.write_csv_gz(tmp_path / "t.csv.gz", frame)
    want = io.StringIO()
    pd.DataFrame(frame).to_csv(want, index=False)
    with gzip.open(path, "rt", newline="") as fh:
        assert fh.read() == want.getvalue()


def test_read_csv_gz_round_trip(tmp_path):
    frame = {"read_id": np.array(["a", "b"], object), "n": np.array([3, 4])}
    path = writers.write_csv_gz(tmp_path / "x.csv.gz", frame)
    assert writers.read_csv_gz(path) == {"read_id": ["a", "b"], "n": ["3", "4"]}


def test_frame_helpers():
    a = {"id": np.array(["a", "b", "c"], object), "v": np.array([1, 2, 3])}
    b = {"id": np.array(["d"], object), "v": np.array([4])}
    cat = writers.frame_concat([a, b])
    assert writers.frame_len(cat) == 4
    assert list(writers.frame_take(cat, cat["v"] % 2 == 0)["id"]) == ["b", "d"]
    assert list(writers.frame_take(cat, slice(1, 3))["v"]) == [2, 3]


def test_shard_accumulator_rechunks_rows():
    from warpdemux_tpu.pipeline.run import _ShardAccumulator

    shards = []
    acc = _ShardAccumulator(lambda f, b: shards.append((b, list(f["v"]))), 3, 5)
    for chunk in ([0, 1], [2, 3, 4, 5, 6], [], [7]):
        acc.add({"v": np.array(chunk, int)})
    acc.close()
    assert shards == [(5, [0, 1, 2]), (6, [3, 4, 5]), (7, [6, 7])]


@pytest.mark.parametrize("requested,want", [(0, 8), (None, 8), (1, 1), (8, 8)])
def test_device_count_rule(requested, want):
    from warpdemux_tpu.pipeline.run import resolve_device_count

    assert resolve_device_count(requested) == want


def test_asking_for_more_devices_than_exist_is_an_error():
    from warpdemux_tpu.pipeline.run import resolve_device_count

    with pytest.raises(ValueError, match="only 8"):
        resolve_device_count(9)


@pytest.mark.parametrize("env", [None, "/some/cache"])
def test_compile_cache_directory_rule(monkeypatch, env):
    from warpdemux_tpu.utils import jaxcache

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = jaxcache.cache_dir()
        assert d == REPO / ".jax_cache"
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert jaxcache.cache_dir() is None


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """On the CPU (and in a directory holding nothing but the script)
    chip_smoke.py exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, cwd=script.parent,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
