#!/usr/bin/env python3
"""Smoke run of the demultiplexer on one NVIDIA GPU, every phase in one process.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: `demux -j 4` vs `-j 1`

Phases (any failure exits non-zero; none is skipped or passed over):

1. device: the first JAX device must be a GPU (the script never falls back
   to the CPU); prints the card's name and power limit (nvidia-smi) and
   which optional host packages are importable.
2. kernel: the fused DTW kernel (ops/dtw_triton.py, compiled by Triton)
   against the plain XLA scan (ops/dtw.py) at B=1000 queries against the
   WDX4 (851) and WDX10 (2601) support-vector sets: max relative error
   <= 1e-6 in float32, and a 64x64 subset against the float64 numpy
   reference at rtol 1e-5. Prints the median time of both paths.
3. offline: 1,000 seeded reads with planted barcodes written as a pod5
   file, demultiplexed by CLI `demux -m WDX4_rna004_v1_0` at the defaults
   (B=1000, preload 10,000). The same fused step then runs on the GPU and
   on the CPU backend of this process, read by read. XLA's GPU reductions
   associate differently from the CPU's: the rolling cumsums and t-test
   sums can move a marginal boundary or event by a sample, and the
   segment-mean cumsum moves fingerprint values by ~1e-4. So: fail_code
   and pred agree on >= 99.5% of reads; the segmentation (detect
   boundaries and event dwells) of reads passing on both agrees on
   >= 97%; where decision and segmentation agree, conf agrees within 1e-3.
4. live: the live entry point's dummy replay (200 reads); prints the
   decision latency p50 and p99.
5. card-only tests: `pytest -m gpu` in this process.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODEL = "WDX4_rna004_v1_0"
N_READS = 1000
SEED = 0
ADC_SCALE, ADC_OFFSET = 0.1755, -240.0
# GPU against CPU (PERF.md section 2 gives the measurements behind these)
AGREE_MIN = 0.995  # fail_code+pred, and the CLI against the GPU step
SEG_AGREE_MIN = 0.97  # detect boundaries + event dwells, reads passing on both
CONF_ATOL = 1e-3  # where decision and segmentation agree
OPTIONAL_PACKAGES = ("pandas", "pyarrow", "zstandard", "tqdm")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def median_seconds(fn, *args, reps: int = 20) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import jax

    devs = jax.devices()
    check(
        devs[0].platform == "gpu",
        f"no GPU: JAX found {devs[0].platform} devices only",
    )
    card = card_line()
    print(card)
    status = {
        name: importlib.util.find_spec(name) is not None
        for name in OPTIONAL_PACKAGES
    }
    print("optional packages: " + ", ".join(
        f"{k}={'yes' if v else 'no'}" for k, v in status.items()
    ))
    return devs, card


def phase_kernel(card: str, batch: int = 1000):
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from warpdemux_tpu.models.registry import load_model
    from warpdemux_tpu.ops.dtw import dtw_distance_matrix, dtw_distance_matrix_ref
    from warpdemux_tpu.ops.dtw_triton import dtw_distance_matrix_triton

    rng = np.random.default_rng(SEED)
    for name in ("WDX4_rna004_v1_0", "WDX10_rna004_v1_0"):
        model = load_model(name)
        Y = np.asarray(model.X_sv, np.float32)
        X = Y[rng.integers(0, len(Y), batch)] + rng.normal(
            0, 0.3, (batch, Y.shape[1])
        ).astype(np.float32)
        kw = dict(window=model.window, penalty=model.penalty)
        kern = jax.jit(functools.partial(dtw_distance_matrix_triton, **kw))
        scan = jax.jit(functools.partial(dtw_distance_matrix, **kw))
        Xd, Yd = jnp.asarray(X), jnp.asarray(Y)
        got = np.asarray(kern(Xd, Yd))
        want = np.asarray(scan(Xd, Yd))
        check(got.shape == (batch, len(Y)), f"{name}: kernel shape {got.shape}")
        check(np.isfinite(got).all(), f"{name}: kernel output not finite")
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
        check(rel <= 1e-6, f"{name}: kernel vs XLA scan max rel err {rel:.3e}")
        ref64 = dtw_distance_matrix_ref(
            X[:64].astype(np.float64), Y[:64].astype(np.float64),
            model.window, model.penalty,
        )
        np.testing.assert_allclose(got[:64, :64], ref64, rtol=1e-5)
        t_k = median_seconds(kern, Xd, Yd)
        t_s = median_seconds(scan, Xd, Yd)
        print(
            f"kernel {name} B={batch} N={len(Y)}: triton {t_k * 1e3:.4f} ms, "
            f"xla scan {t_s * 1e3:.4f} ms (median of 20), max rel err "
            f"{rel:.2e}, float64 64x64 ok [{card}]"
        )


def synth_population(n_reads: int, seed: int = SEED):
    """Reads whose adapters carry WDX4 support-vector fingerprints
    (live/dummy.synth_barcoded_read, as in tests/test_bench_population.py),
    as pod5 read dicts. Returns (reads, planted barcode per read)."""
    import uuid

    import numpy as np

    from warpdemux_tpu.live.dummy import synth_barcoded_read
    from warpdemux_tpu.models.registry import load_model_arrays

    arrays = load_model_arrays(MODEL)
    X = np.asarray(arrays["X_sv"], np.float32)
    labels = np.asarray(arrays["label_map"])
    bounds = np.concatenate([[0], np.cumsum(arrays["n_support"])])
    rng = np.random.default_rng(seed)
    reads, truth = [], []
    for _ in range(n_reads):
        ci = int(rng.integers(0, len(labels) - 1))  # barcodes, not noise
        sv = X[rng.integers(bounds[ci], bounds[ci + 1])]
        sig = synth_barcoded_read(rng, sv)
        adc = np.clip(np.rint(sig / ADC_SCALE - ADC_OFFSET), -32768, 32767)
        reads.append(
            dict(
                read_id=str(uuid.UUID(bytes=rng.bytes(16))),
                signal=adc.astype(np.int16),
                calibration_offset=ADC_OFFSET,
                calibration_scale=ADC_SCALE,
            )
        )
        truth.append(int(labels[ci]))
    return reads, np.asarray(truth)


def write_population(workdir: Path):
    """(pod5 path, {read_id: planted barcode})."""
    from warpdemux_tpu.io.pod5_writer import write_pod5

    reads, truth = synth_population(N_READS)
    path = workdir / "population.pod5"
    write_pod5(path, reads)
    return path, {r["read_id"]: int(t) for r, t in zip(reads, truth)}


def run_cli_demux(pod5: Path, out: Path, *extra: str) -> dict:
    """CLI `demux` at its defaults; returns {read_id: (pred, conf)}."""
    from warpdemux_tpu import cli
    from warpdemux_tpu.io.writers import read_csv_gz

    rc = cli.main(
        ["demux", "-i", str(pod5), "-o", str(out), "-m", MODEL, *extra]
    )
    check(rc == 0, f"cli demux {' '.join(extra)} returned {rc}")
    files = sorted(glob.glob(str(out / "**" / "predictions" / "*.csv.gz"), recursive=True))
    check(bool(files), f"no predictions written under {out}")
    calls = {}
    for f in files:
        t = read_csv_gz(f)
        head = list(t)
        check(
            head[:3] == ["#read_id", "predicted_barcode", "confidence_score"]
            and "p-1" in head,
            f"{f}: unexpected columns {head}",
        )
        for rid, p, c in zip(t["#read_id"], t["predicted_barcode"], t["confidence_score"]):
            calls[rid] = (int(p), float(c))
    failed = 0
    for f in glob.glob(str(out / "**" / "failed_reads" / "*.csv.gz"), recursive=True):
        failed += len(read_csv_gz(f).get("read_id", []))
    check(
        len(calls) + failed == N_READS,
        f"{len(calls)} predictions + {failed} failed != {N_READS} reads",
    )
    logging.basicConfig(stream=sys.stderr, level=logging.INFO, force=True)
    return calls


def run_full_step(pod5: Path, device):
    """The fused step (full outputs) over the whole pod5 on `device`."""
    import jax

    from warpdemux_tpu.config.utils import get_model_spc_config
    from warpdemux_tpu.io.pod5 import yield_adc_batches
    from warpdemux_tpu.models.registry import load_model
    from warpdemux_tpu.pipeline.step import make_demux_step

    # CPU executables stay out of the persistent compile cache: it may be
    # reloaded on a host with other CPU features
    cache_on = jax.config.jax_enable_compilation_cache
    jax.config.update(
        "jax_enable_compilation_cache", cache_on and device.platform != "cpu"
    )
    try:
        with jax.default_device(device):
            model = load_model(MODEL)
            spc = get_model_spc_config(MODEL)
            step = make_demux_step(model, spc, input_format="adc", outputs="full")
            (adc, off, sc, lens, _full, ids), = list(
                yield_adc_batches([pod5], None, None, N_READS, spc.sig_preload_size)
            )
            res = jax.device_get(step(adc, off, sc, lens)).unpack()
    finally:
        jax.config.update("jax_enable_compilation_cache", cache_on)
    return ids, res


def phase_offline(workdir: Path, card: str):
    import jax
    import numpy as np

    pod5, truth = write_population(workdir)
    t0 = time.perf_counter()
    calls = run_cli_demux(pod5, workdir / "out_gpu")
    called = [rid for rid, (p, _) in calls.items() if p != -1]
    recovered = np.mean([calls[rid][0] == truth[rid] for rid in called])
    print(
        f"offline: cli demux -m {MODEL} over {N_READS} reads: "
        f"{len(calls)} predicted, {len(called)} called, planted barcode "
        f"recovered on {recovered * 100:.2f}% of called reads, "
        f"{time.perf_counter() - t0:.1f} s including compilation [{card}]"
    )
    check(len(called) >= 0.6 * N_READS, f"only {len(called)} reads called")
    check(recovered >= 0.9, f"planted barcodes recovered on {recovered:.3f}")

    ids, gpu = run_full_step(pod5, jax.devices()[0])
    _, cpu = run_full_step(pod5, jax.devices("cpu")[0])
    for name, r in (("gpu", gpu), ("cpu", cpu)):
        check(np.isfinite(r.conf).all(), f"{name} step: non-finite conf")
        check(r.pred.shape == (N_READS,), f"{name} step: pred shape {r.pred.shape}")
    same = (gpu.fail_code == cpu.fail_code) & (gpu.pred == cpu.pred)
    # segmentation: detect boundaries and the adapter's event dwells
    seg_same = (gpu.fpt.dwell == cpu.fpt.dwell).all(axis=1)
    for k in ("adapter_start", "adapter_end", "polya_start", "polya_end"):
        seg_same &= getattr(gpu.detect, k) == getattr(cpu.detect, k)
    conf_diff = np.abs(gpu.conf - cpu.conf)

    def show(r, i):
        return (
            f"fail={r.fail_code[i]} pred={r.pred[i]} conf={r.conf[i]:.4f} "
            f"adapter=[{r.detect.adapter_start[i]}, {r.detect.adapter_end[i]}) "
            f"polya=[{r.detect.polya_start[i]}, {r.detect.polya_end[i]})"
        )

    for i in np.flatnonzero(~same | (conf_diff > CONF_ATOL))[:20]:
        print(
            f"  differs {ids[i]} (segmentation {'same' if seg_same[i] else 'differs'}, "
            f"max |fpt diff| {np.max(np.abs(gpu.fpt.fpt[i] - cpu.fpt.fpt[i])):.2e}): "
            f"gpu {show(gpu, i)} | cpu {show(cpu, i)}"
        )
    agree = float(same.mean())
    passed = gpu.success & cpu.success
    seg_agree = float(seg_same[passed].mean())
    # reads whose decision and segmentation agree carry the same float32
    # fingerprint up to reduction order, so their conf must agree closely
    stable = passed & same & seg_same
    conf_err = float(np.max(conf_diff[stable], initial=0.0))
    cli_same = np.mean([
        calls[rid][0] == int(p)
        for rid, p, ok in zip(ids, gpu.pred, gpu.success) if ok and rid in calls
    ])
    print(
        f"offline: gpu vs cpu fused step: fail_code+pred agree on "
        f"{agree * 100:.2f}% of {N_READS} reads, segmentation on "
        f"{seg_agree * 100:.2f}% of reads passing on both, max |conf diff| "
        f"{conf_err:.2e} where both agree; cli predictions equal the gpu step "
        f"on {cli_same * 100:.2f}% of called reads"
    )
    check(agree >= AGREE_MIN, f"gpu/cpu decisions agree on only {agree:.4f}")
    check(seg_agree >= SEG_AGREE_MIN, f"gpu/cpu segmentation agrees on only {seg_agree:.4f}")
    check(conf_err <= CONF_ATOL, f"gpu/cpu conf differ by {conf_err:.3e}")
    check(cli_same >= AGREE_MIN, f"cli vs gpu step agree on only {cli_same:.4f}")
    return pod5


def phase_live(workdir: Path, card: str):
    from warpdemux_tpu.live import entry_point

    cfg = workdir / "live.toml"
    cfg.write_text(
        f'[model]\nmodel_name = "{MODEL}"\n\n[flowcell]\nflowcell_type = '
        f'"flongle"\n\n[reporting]\nsave_path = "{workdir / "live"}"\n'
    )
    session = entry_point.run(
        ["--config_file", str(cfg), "--dummy", "--n_reads", "200"]
    )
    check(session is not None, "live session did not start")
    tot = session.reporter.latency_percentiles().get("total")
    check(tot is not None and tot["n"] > 0, "live session made no decisions")
    print(
        f"live: dummy replay of 200 reads, {tot['n']} decisions, decision "
        f"latency p50 {tot['p50'] * 1e3:.3f} ms, p99 {tot['p99'] * 1e3:.3f} ms [{card}]"
    )


class _FailuresToStderr:
    """pytest plugin: each failing test's report also goes to stderr, so a
    failure shows in the error stream beside the script's FAIL line."""

    def pytest_runtest_logreport(self, report):
        if report.failed:
            print(
                f"chip_smoke: test {report.nodeid} failed ({report.when}):\n"
                f"{report.longreprtext[-4000:]}",
                file=sys.stderr,
            )


def phase_gpu_tests():
    import pytest

    # collect only the files that hold `gpu` tests: the other test modules
    # import the repo's `tests` directory as a namespace package, which an
    # installed package named `tests` would shadow
    files = sorted(
        str(f) for f in (REPO / "tests").glob("test_*.py")
        if "pytest.mark.gpu" in f.read_text()
    )
    check(bool(files), "no gpu-marked tests found")
    os.environ["WDX_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
         "--rootdir", str(REPO), *files],
        plugins=[_FailuresToStderr()],
    )
    check(rc == 0, f"pytest -m gpu exited {rc}")


def phase_four_cards(workdir: Path, card: str):
    import jax

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    pod5, _ = write_population(workdir)
    one = run_cli_demux(pod5, workdir / "out_j1", "-j", "1")
    t0 = time.perf_counter()
    four = run_cli_demux(pod5, workdir / "out_j4", "-j", "4")
    print(
        f"four cards: cli demux -j 4 over {N_READS} reads, {len(four)} "
        f"predicted, {time.perf_counter() - t0:.1f} s including compilation; "
        f"-j 1 predicted {len(one)} [{card}]"
    )
    check(one.keys() == four.keys(), "-j 4 and -j 1 predicted different reads")
    diff = [r for r in one if one[r] != four[r]]
    check(not diff, f"-j 4 and -j 1 differ on {len(diff)} reads, e.g. {diff[:3]}")
    print("four cards: predictions identical to the one-card run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only `demux -j 4` against a one-card run (needs 4 GPUs)",
    )
    args = ap.parse_args(argv)
    if not (REPO / "warpdemux_tpu" / "__init__.py").is_file():
        print("chip_smoke: FAIL: run from the root of a warpdemux_tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        devs, card = phase_device()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            workdir = Path(tmp)
            if args.four_cards:
                phase_four_cards(workdir, card)
            else:
                phase_kernel(card)
                phase_offline(workdir, card)
                phase_live(workdir, card)
                phase_gpu_tests()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
