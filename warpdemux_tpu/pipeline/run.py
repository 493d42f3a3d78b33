"""Offline batch pipeline orchestration.

Mirrors the reference's run_demux (warpdemux/file_proc.py:1011-1300) with a
device-shaped execution model: a producer thread preloads fixed-shape pod5
minibatches into a bounded queue (I/O-compute overlap + backpressure, like
file_proc.py:333-354), the main loop issues one fused device step per
minibatch (instead of a process pool), and writer logic re-chunks results
into bidx-sharded output files of batch_size_output rows
(file_proc.py:500-630). `continue` support scans prior outputs into an
exclude set (file_proc.py:128-185).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field

import jax
import numpy as np

from warpdemux_tpu.config.config import Config
from warpdemux_tpu.detect.containers import fail_code_to_reason
from warpdemux_tpu.io.pod5 import yield_vbz_batches
from warpdemux_tpu.io import writers
from warpdemux_tpu.io.writers import Frame, frame_concat, frame_len, frame_take
from warpdemux_tpu.pipeline.step import PackedStepOutput, make_demux_step


class _ShardAccumulator:
    """Accumulates frames and flushes batch_size_output-row shards."""

    def __init__(self, flush_fn, rows_per_shard: int, bidx0: int = 0):
        self.flush_fn = flush_fn
        self.rows_per_shard = rows_per_shard
        self.bidx = bidx0
        self.frames: list[Frame] = []
        self.count = 0

    def add(self, df: Frame | None):
        if df is None or not frame_len(df):
            return
        self.frames.append(df)
        self.count += frame_len(df)
        while self.count >= self.rows_per_shard:
            big = frame_concat(self.frames)
            self.flush_fn(frame_take(big, slice(0, self.rows_per_shard)), self.bidx)
            rest = frame_take(big, slice(self.rows_per_shard, None))
            self.count = frame_len(rest)
            self.frames = [rest] if self.count else []
            self.bidx += 1

    def close(self):
        if self.count:
            big = frame_concat(self.frames)
            self.flush_fn(big, self.bidx)
            self.bidx += 1
            self.frames, self.count = [], 0


@dataclass
class RunStats:
    total: int = 0
    passed: int = 0
    failed: int = 0
    predicted: int = 0
    elapsed_s: float = 0.0
    # per-class prediction counts aligned with the model's label_map
    # (noise/-1 last); None for prep-only runs
    class_counts: np.ndarray | None = None


class _Progress:
    """Total / failed / pass progress (the reference's three tqdm bars with
    an asynchronously-computed total, file_proc.py:783-964): the expected
    total is counted in a background thread so the run starts immediately,
    and a log line reports the counters on a fixed cadence."""

    LOG_EVERY_S = 15.0

    def __init__(self, stats: RunStats, total_fn, label: str):
        self.stats = stats
        self.total = None
        self._label = label
        self._last_log = time.monotonic()
        threading.Thread(
            target=self._count_total, args=(total_fn,), daemon=True
        ).start()

    def _count_total(self, total_fn):
        try:
            self.total = total_fn()
        except Exception:
            pass

    def update(self):
        s = self.stats
        if time.monotonic() - self._last_log >= self.LOG_EVERY_S:
            self._last_log = time.monotonic()
            tot = f"/{self.total}" if self.total else ""
            logging.info(
                "progress: %d%s reads (%d %s, %d failed)",
                s.total, tot, s.passed, self._label, s.failed,
            )


def select_outputs_mode(config: Config) -> str:
    """"decision" when the run only needs barcode calls (no boundary or
    fingerprint output requested), else "full"."""
    if (
        config.task.predict
        and not config.output.save_boundaries
        and not config.output.save_fpts
    ):
        return "decision"
    return "full"


def resolve_device_count(requested: int | None) -> int:
    """Devices to shard over: 0/None means all; asking for more devices than
    exist is an error, never a silent shrink."""
    avail = len(jax.devices())
    if requested in (0, None):
        return avail
    if requested > avail:
        raise ValueError(
            f"--devices {requested} requested but only {avail} "
            f"{jax.devices()[0].platform} device(s) are visible"
        )
    return int(requested)


def run_demux(config: Config, model=None) -> RunStats:
    """Demux/prep over pod5 inputs. `model` may be preloaded; otherwise it is
    resolved from config.classif.model_name when predicting."""
    t0 = time.time()
    spc = config.sig_proc
    do_predict = config.task.predict
    if do_predict and model is None:
        from warpdemux_tpu.models.registry import load_model

        model = load_model(config.classif.model_name)

    # multi-chip: shard each minibatch over a data-parallel device mesh
    # (the reference's only scaling axis is reads-parallelism over a
    # process pool, file_proc.py:1197-1245; here the batch axis is sharded
    # and model arrays replicated). devices=1 -> single-device step.
    mesh = None
    batch_sharding = None
    n_dev = config.batch.devices
    if n_dev != 1:
        n_dev = resolve_device_count(n_dev)
        if n_dev > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from warpdemux_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(n_dev)
            batch_sharding = NamedSharding(mesh, P("data"))
            logging.info("sharding minibatches over %d devices", n_dev)

    wire = config.batch.wire
    # predictions-only runs use the decision lane: only pred/conf/probs/fail
    # cross the device->host link (~13+4k B/read instead of ~370) and XLA
    # strips the unused boundary/fingerprint outputs from the program — the
    # analog of the reference's predict-only worker that skips
    # boundary/fpt output entirely (file_proc.py:457-497).
    outputs_mode = select_outputs_mode(config)

    B = config.batch.minibatch_size
    if mesh is not None and B % n_dev:
        B = -(-B // n_dev) * n_dev
        logging.info(
            "minibatch_size rounded up to %d (multiple of %d devices)",
            B, n_dev,
        )
    L = spc.sig_preload_size

    # Two-stage adaptive preload (pipeline/step.py): predictions-only vbz
    # runs ship each read's first stage1_preload samples and re-ship tails
    # only where the decision provably needs them — decisions bit-identical
    # to the full preload (tests/test_twostage.py). start_peak resolves
    # whole reads only (its boundaries read up to in_len), so two-stage
    # would re-ship nearly every tail there; keep the one-shot wire.
    S1 = int(config.batch.stage1_preload or 0)
    two_stage = bool(
        S1
        and 0 < S1 < L
        and S1 % 8 == 0
        and outputs_mode == "decision"
        and wire == "vbz"
        and mesh is None
        and do_predict
        and spc.detect.method in ("cnn", "llr")
        and not spc.detect.detect_med_shift
        and (
            spc.detect.method != "cnn"
            or 0 < spc.detect.cnn_input_cap <= S1
        )
    )
    if two_stage:
        from warpdemux_tpu.ops.vbz_device import (
            pack_tails_host,
            split_wire_host,
        )
        from warpdemux_tpu.pipeline.step import make_twostage_decision_step

        stage1_fn, stage2_fn = make_twostage_decision_step(model, spc, S1)
        step = None
        logging.info(
            "two-stage wire: stage-1 preload %d of %d samples", S1, L
        )
    else:
        step = make_demux_step(
            model, spc, with_predict=do_predict, input_format=wire,
            mesh=mesh, outputs=outputs_mode,
        )

    feed: queue.Queue = queue.Queue(maxsize=4)

    def producer():
        """pod5 -> wire-format minibatches (VBZ inner layout decoded on
        device, or raw int16 ADC), padded to the compiled batch shape, with
        the host->device transfer started here so it overlaps the main
        loop's compute (the reference's preloader thread + bounded queue,
        file_proc.py:333-354, with device_put as the 'preload')."""
        import jax

        put = (
            (lambda a: jax.device_put(a, batch_sharding))
            if batch_sharding is not None
            else jax.device_put
        )

        def pad_rows(a, pad):
            shape = (pad,) + a.shape[1:]
            return np.concatenate([a, np.zeros(shape, a.dtype)])

        try:
            if wire == "adc":
                from warpdemux_tpu.io.pod5 import yield_adc_batches

                gen = yield_adc_batches(
                    config.input.files,
                    config.input.read_ids_incl,
                    config.input.read_ids_excl,
                    batch_size=B,
                    preload_size=L,
                )
            else:
                gen = yield_vbz_batches(
                    config.input.files,
                    config.input.read_ids_incl,
                    config.input.read_ids_excl,
                    batch_size=B,
                    preload_size=L,
                )
            for batch in gen:
                *arrays, full_lens, read_ids = batch
                in_lens = arrays[-1]
                n = arrays[0].shape[0]
                if n < B:
                    arrays = [pad_rows(a, B - n) for a in arrays]
                if two_stage:
                    keys, data, offset, scale, lens = arrays
                    keys1, data1, off1 = split_wire_host(
                        keys, data, lens, S1
                    )
                    dev = tuple(
                        put(a) for a in (keys1, data1, offset, scale, lens)
                    )
                    host_wire = (keys, data, lens, off1)
                else:
                    dev = tuple(put(a) for a in arrays)
                    host_wire = None
                feed.put((dev, host_wire, n, full_lens, read_ids))
        except Exception:
            logging.exception("pod5 producer failed; stopping feed")
        finally:
            feed.put(None)

    threading.Thread(target=producer, daemon=True).start()

    out = config.output
    tag = out.shard_tag
    pred_acc = _ShardAccumulator(
        lambda df, b: writers.save_predictions(
            df, out.output_dir_pred, b, tag=tag
        ),
        config.batch.batch_size_output,
        config.batch.bidx_predict,
    )
    fail_acc = _ShardAccumulator(
        lambda df, b: writers.save_boundaries(
            df, out.output_dir_fail, b, failed=True, tag=tag
        ),
        config.batch.batch_size_output,
        config.batch.bidx_fail,
    )
    bound_acc = _ShardAccumulator(
        lambda df, b: writers.save_boundaries(
            df, out.output_dir_boundaries, b, tag=tag
        ),
        config.batch.batch_size_output,
        config.batch.bidx_pass,
    )

    # fingerprints are written one npz per pass-shard, aligned with bound_acc
    fpt_rows: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    fpt_count = 0
    fpt_bidx = config.batch.bidx_pass

    def flush_fpts(force=False):
        nonlocal fpt_rows, fpt_count, fpt_bidx
        rows_per = config.batch.batch_size_output
        while fpt_count >= rows_per or (force and fpt_count > 0):
            take, taken, rest = [], 0, []
            for ids, fp, dw in fpt_rows:
                if taken >= rows_per:
                    rest.append((ids, fp, dw))
                    continue
                n = min(len(ids), rows_per - taken)
                take.append((ids[:n], fp[:n], dw[:n]))
                taken += n
                if n < len(ids):
                    rest.append((ids[n:], fp[n:], dw[n:]))
            ids = np.concatenate([t[0] for t in take])
            fp = np.concatenate([t[1] for t in take])
            dw = np.concatenate([t[2] for t in take])
            writers.save_fingerprints(
                ids,
                fp,
                out.output_dir_fpts,
                fpt_bidx,
                dwell_times=dw if config.output.save_dwell_time else None,
                tag=config.output.shard_tag,
            )
            fpt_bidx += 1
            fpt_rows = rest
            fpt_count = sum(len(r[0]) for r in fpt_rows)
            if force and fpt_count == 0:
                break

    stats = RunStats()
    label_vals = None
    if do_predict and model is not None:
        label_vals = np.asarray(model.label_map)
        stats.class_counts = np.zeros(len(label_vals), np.int64)

    def acc_classes(pred):
        if label_vals is not None:
            stats.class_counts += (
                pred[:, None] == label_vals[None, :]
            ).sum(axis=0)

    progress = _Progress(
        stats,
        total_fn=lambda: __import__(
            "warpdemux_tpu.io.pod5", fromlist=["count_reads"]
        ).count_reads(config.input.files),
        label="pass" if not do_predict else "predicted",
    )
    def postprocess_decision(res, n, read_ids):
        """Decision-lane postprocess: predictions + a minimal failed-reads
        table (read_id + fail_reason; the boundary columns were never
        fetched — request --save_boundaries for the full failure table)."""
        success = np.asarray(res.success)[:n]
        fail_code = np.asarray(res.fail_code)[:n]
        stats.total += n
        stats.passed += int(success.sum())
        stats.failed += int((~success).sum())
        if not success.all():
            ids = np.asarray(read_ids)
            fail_acc.add(
                {
                    "read_id": ids[~success],
                    "fail_reason": np.asarray(
                        fail_code_to_reason(fail_code[~success]), object
                    ),
                }
            )
        if success.any():
            pred = np.asarray(res.pred)[:n][success]
            conf = np.asarray(res.conf)[:n][success]
            probs = np.asarray(res.probs)[:n][success]
            df = model.predictions_to_df(
                np.asarray(read_ids)[success], pred, conf, probs
            )
            pred_acc.add(df)
            stats.predicted += frame_len(df)
            acc_classes(pred)
        progress.update()

    def postprocess(res, n, full_lens, read_ids, in_lens):
        nonlocal fpt_count
        success = np.asarray(res.success)[:n]
        fail_code = np.asarray(res.fail_code)[:n]
        stats.total += n
        stats.passed += int(success.sum())
        stats.failed += int((~success).sum())

        from warpdemux_tpu.detect.containers import DetectArrays

        det_n = DetectArrays(
            *[
                np.asarray(a)[:n] if a is not None else None
                for a in res.detect
            ]
        )
        det_df = det_n.to_summary_frame(
            read_ids,
            full_lens,
            np.asarray(in_lens)[:n],
            primary_method=spc.detect.method,
        )
        fptA = res.fpt
        for col, arr in [
            ("adapter_dt_med", fptA.adapter_dt_med),
            ("adapter_dt_mad", fptA.adapter_dt_mad),
            ("adapter_event_mean", fptA.adapter_event_mean),
            ("adapter_event_std", fptA.adapter_event_std),
            ("adapter_event_med", fptA.adapter_event_med),
            ("adapter_event_mad", fptA.adapter_event_mad),
        ]:
            det_df[col] = np.asarray(arr)[:n]
        if res.consensus is not None:
            # tRNA refinement extras (reference ReadResult.to_summary_dict:
            # seg_cons_query_start/end, sig_barcode_start; sig_proc.py:26-62)
            cons = res.consensus
            det_df["seg_cons_query_start"] = np.asarray(cons.seg_query_start)[:n]
            det_df["seg_cons_query_end"] = np.asarray(cons.seg_query_end)[:n]
            det_df["sig_barcode_start"] = np.asarray(cons.sig_barcode_start)[:n]
        det_df["fail_reason"] = np.asarray(fail_code_to_reason(fail_code), object)

        if config.output.save_boundaries:
            bound_acc.add(
                frame_take(
                    {k: v for k, v in det_df.items() if k != "fail_reason"},
                    success,
                )
            )
        fail_acc.add(frame_take(det_df, ~success))

        if config.output.save_fpts and success.any():
            fpt_rows.append(
                (
                    np.asarray(read_ids)[success],
                    np.asarray(fptA.fpt)[:n][success],
                    np.asarray(fptA.dwell)[:n][success],
                )
            )
            fpt_count += int(success.sum())
            flush_fpts()

        if do_predict and success.any():
            pred = np.asarray(res.pred)[:n][success]
            conf = np.asarray(res.conf)[:n][success]
            probs = np.asarray(res.probs)[:n][success]
            df = model.predictions_to_df(
                np.asarray(read_ids)[success], pred, conf, probs
            )
            pred_acc.add(df)
            stats.predicted += frame_len(df)
            acc_classes(pred)
        progress.update()

    # The main loop only dispatches device steps; a postprocessing thread
    # fetches results and does all csv work. With `maxsize` results in
    # flight the device computes minibatch N+1 while N's outputs are
    # fetched and the host re-chunks the tables (the reference overlaps the
    # same way with saver threads, file_proc.py:1100-1153).
    results: queue.Queue = queue.Queue(maxsize=3)

    def postproc_worker():
        # ALL RunStats mutation happens on this thread (dispatch failures
        # arrive as res=None sentinels), so the counters need no lock.
        while True:
            item = results.get()
            if item is None:
                return
            res, host_wire, n, full_lens, read_ids, in_lens = item
            try:
                if res is None:
                    raise RuntimeError("minibatch dispatch failed")
                if two_stage:
                    # res is a TwoStageHandle: fetch the resolved bits,
                    # ship + run the unresolved tails, merge on device
                    h = res
                    resolved = np.asarray(jax.device_get(h.resolved))
                    rows = np.where(~resolved[:n])[0]
                    if rows.size:
                        keys, data, lens, off1 = host_wire
                        rows_p, keys_t, data_t = pack_tails_host(
                            keys, data, lens, off1, rows, S1, L
                        )
                        res = stage2_fn(h, rows_p, keys_t, data_t)
                    else:
                        res = h.out1
                res = jax.device_get(res)
                if isinstance(res, PackedStepOutput):
                    postprocess(res.unpack(), n, full_lens, read_ids, in_lens)
                else:
                    postprocess_decision(res, n, read_ids)
            except Exception:
                # a poisoned minibatch must not kill the run (reference
                # file_proc.py:1179-1184); its reads are dropped and logged
                logging.exception(
                    "minibatch failed (%d reads dropped): %s...",
                    n,
                    read_ids[0] if len(read_ids) else "-",
                )
                stats.total += n
                stats.failed += n

    pp_thread = threading.Thread(target=postproc_worker, daemon=True)
    pp_thread.start()
    while True:
        item = feed.get()
        if item is None:
            break
        dev, host_wire, n, full_lens, read_ids = item
        in_lens = dev[-1]
        try:
            res = stage1_fn(*dev) if two_stage else step(*dev)
        except Exception:
            logging.exception(
                "minibatch dispatch failed (%d reads dropped): %s...",
                n,
                read_ids[0] if len(read_ids) else "-",
            )
            res = None  # accounted on the postproc thread
        results.put((res, host_wire, n, full_lens, read_ids, in_lens))
    results.put(None)
    pp_thread.join()

    pred_acc.close()
    fail_acc.close()
    bound_acc.close()
    flush_fpts(force=True)
    stats.elapsed_s = time.time() - t0
    logging.info(
        "demux done: %d reads (%d pass / %d fail / %d predicted) in %.1fs "
        "(%.0f reads/s)",
        stats.total,
        stats.passed,
        stats.failed,
        stats.predicted,
        stats.elapsed_s,
        stats.total / max(stats.elapsed_s, 1e-9),
    )
    if stats.class_counts is not None:
        logging.info(
            "class counts (%s): %s",
            "/".join(str(v) for v in label_vals),
            "/".join(str(int(c)) for c in stats.class_counts),
        )
    if jax.process_count() > 1:
        # pod-slice runs: all-reduce the per-host counters into one global
        # end-of-run summary (the reference's Manager-shared ridx counters,
        # file_proc.py:1055-1071, as a psum over hosts)
        from warpdemux_tpu.parallel.multihost import global_class_counts

        vec = np.array(
            [stats.total, stats.passed, stats.failed, stats.predicted],
            np.int32,
        )
        if stats.class_counts is not None:
            vec = np.concatenate([vec, stats.class_counts.astype(np.int32)])
        g = global_class_counts(vec)
        logging.info(
            "GLOBAL (%d hosts): %d reads (%d pass / %d fail / %d predicted)"
            "%s",
            jax.process_count(), g[0], g[1], g[2], g[3],
            (
                " class counts "
                + "/".join(str(int(c)) for c in g[4:])
                if len(g) > 4
                else ""
            ),
        )
    return stats


def run_predict_from_fpts(config: Config, model=None) -> RunStats:
    """predict mode: classify previously saved fingerprints
    (reference file_proc.py:282-330, 457-497)."""
    t0 = time.time()
    if model is None:
        from warpdemux_tpu.models.registry import load_model

        model = load_model(config.classif.model_name)
    out = config.output
    pred_acc = _ShardAccumulator(
        lambda df, b: writers.save_predictions(df, out.output_dir_pred, b),
        config.batch.batch_size_output,
        config.batch.bidx_predict,
    )
    fail_acc = _ShardAccumulator(
        lambda df, b: writers.save_boundaries(
            df, out.output_dir_fail, b, failed=True
        ),
        config.batch.batch_size_output,
        config.batch.bidx_fail,
    )
    stats = RunStats()
    excl = config.input.read_ids_excl
    for npz_file in config.input.files:
        with np.load(npz_file, allow_pickle=True) as z:
            ids = z["read_ids"]
            fpts = z["signals"]
        if excl:
            keep = np.array([rid not in excl for rid in ids])
            ids, fpts = ids[keep], fpts[keep]
        if not len(ids):
            continue
        finite = np.isfinite(fpts).all(axis=1)
        if finite.any():
            pred, conf, probs = model.predict(
                np.nan_to_num(fpts[finite].astype(np.float32))
            )
            df = model.predictions_to_df(ids[finite], pred, conf, probs)
            pred_acc.add(df)
            stats.predicted += frame_len(df)
        if not finite.all():
            # every read lands in predictions or failed_reads — never
            # silently dropped (reference routes every read one way or the
            # other, file_proc.py:457-497)
            n_bad = int((~finite).sum())
            fail_acc.add(
                {
                    "read_id": ids[~finite],
                    "fail_reason": np.full(n_bad, "non-finite fingerprint", object),
                }
            )
            stats.failed += int((~finite).sum())
        stats.total += len(ids)
    pred_acc.close()
    fail_acc.close()
    stats.elapsed_s = time.time() - t0
    return stats
