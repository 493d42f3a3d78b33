"""Command-line interface: demux / prep / predict / continue.

Same command surface as the reference (warpdemux/main.py + parser.py:
4 subcommands, run-dir layout, command.json resume manifest, --export
config overrides) on the fused accelerator pipeline.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import sys
from pathlib import Path


def _str2bool(v) -> bool:
    """Reference parser.py:38-46 boolean argument convention."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _collect_inputs(paths: list[str], suffix: str) -> list[str]:
    out = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(str(f) for f in sorted(path.rglob(f"*{suffix}")))
        elif path.suffix and str(path).endswith(suffix):
            out.append(str(path))
    return out


def _read_id_file(path: str | None) -> set[str]:
    if not path:
        return set()
    return {l.strip() for l in Path(path).read_text().splitlines() if l.strip()}


def _add_common(p):
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="pod5 file(s) or dir(s)")
    p.add_argument("-o", "--output", required=True, help="output dir root")
    p.add_argument("-m", "--model_name", required=True)
    p.add_argument("-b", "--minibatch_size", type=int, default=1000)
    p.add_argument("--batch_size_output", type=int, default=40000)
    p.add_argument("--read_id_csv", default=None,
                   help="file with read ids to include (one per line)")
    p.add_argument("--export", nargs="*", default=[],
                   help="config overrides, e.g. core.max_obs_trace=8000")
    # reference-compatible boolean flags: both bare (--save_boundaries)
    # and valued (--save_boundaries true) forms work — the reference's
    # README commands use the valued form (parser.py str2bool)
    p.add_argument("--save_dwell_time", type=_str2bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--save_boundaries", type=_str2bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--save_fpts", type=_str2bool, nargs="?",
                   const=True, default=False)
    p.add_argument("--create_subdir", action="store_true", default=True)
    p.add_argument("--no-create_subdir", dest="create_subdir", action="store_false")
    p.add_argument("--wire", choices=("vbz", "adc"), default="vbz",
                   help="host->device wire: compressed VBZ inner layout "
                        "(thin links) or raw int16 ADC (local accelerators)")
    p.add_argument("--stage1_preload", type=int, default=7168,
                   help="two-stage wire: stage-1 prefix samples per read "
                        "for predictions-only vbz runs (tails shipped only "
                        "for reads whose decision provably needs them; "
                        "decisions bit-identical). 0 disables")
    p.add_argument("-j", "--devices", type=int, default=1,
                   help="devices to shard each minibatch over "
                        "(0 = all local devices; more than exist is an "
                        "error; the reference's -j reads-parallelism "
                        "mapped onto a jax Mesh)")
    p.add_argument("--jax-platform", default=None,
                   help="force a jax backend (e.g. cpu) before init")
    p.add_argument("--profile-dir", default=None,
                   help="write a JAX/XLA profiler trace for the run "
                        "(view with tensorboard / xprof)")
    # multi-host data parallelism (SURVEY 2.2: the reference scales by
    # reads-parallelism over cores, file_proc.py:1197-1245; several hosts
    # scale by disjoint pod5 file shards per host, host-tagged output
    # shards, psum'd global counters)
    p.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator address (host:port); "
                        "omit on single-host runs")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for --coordinator runs")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index for --coordinator runs")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="warpdemux-tpu",
        description="raw-signal barcode demultiplexing on an accelerator",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    d = sub.add_parser("demux", help="detect + fingerprint + classify")
    _add_common(d)

    pr = sub.add_parser("prep", help="detect + fingerprint only")
    _add_common(pr)

    # reference surface: `warpdemux predict PREDICT_FROM_DIR` /
    # `warpdemux continue CONTINUE_FROM_DIR` (positional run dir,
    # README.md:318-333); -i kept as an alias
    pd_ = sub.add_parser("predict", help="classify fingerprints from a prep run")
    pd_.add_argument("input_dir", nargs="?", default=None,
                     help="previous prep run dir (with command.json)")
    pd_.add_argument("-i", "--input", default=None)
    pd_.add_argument("-m", "--model_name", default=None)
    pd_.add_argument("--batch_size_output", type=int, default=40000)
    pd_.add_argument("--jax-platform", default=None)

    c = sub.add_parser("continue", help="resume a previous run")
    c.add_argument("input_dir", nargs="?", default=None,
                   help="previous run dir")
    c.add_argument("-i", "--input", default=None)
    c.add_argument("-m", "--model_name", default=None)
    c.add_argument("-b", "--minibatch_size", type=int, default=None)
    c.add_argument("--jax-platform", default=None)
    return ap


def _init_jax(platform: str | None, coordinator: str | None = None,
              num_processes: int | None = None, process_id: int | None = None):
    import jax

    from warpdemux_tpu.utils.jaxcache import enable_compilation_cache

    if platform:
        jax.config.update("jax_platforms", platform)
    if coordinator:
        # must run before the backend is first queried
        from warpdemux_tpu.parallel.multihost import init_distributed

        init_distributed(coordinator, num_processes, process_id)
    enable_compilation_cache()
    return jax


def _make_run_dir(root: str, command: str, create_subdir: bool) -> str:
    if not create_subdir:
        os.makedirs(root, exist_ok=True)
        return root
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M")
    run_dir = os.path.join(root, f"warpdemux_tpu_{command}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def _setup_logging(run_dir: str):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[
            logging.StreamHandler(sys.stdout),
            logging.FileHandler(os.path.join(run_dir, "warpdemux.log")),
        ],
        force=True,
    )


def _run_batch_command(args, command: str, read_ids_excl=None, run_dir=None,
                       bidx=None):
    from warpdemux_tpu.config.config import (
        BatchConfig, ClassifConfig, Config, InputConfig, OutputConfig,
        TaskConfig,
    )
    from warpdemux_tpu.config.utils import (
        get_model_spc_config, parse_export_overrides,
    )
    from warpdemux_tpu.pipeline.run import run_demux

    files = _collect_inputs(args.input, ".pod5")
    if not files:
        raise SystemExit(f"no pod5 inputs found under {args.input}")

    # multi-host: each process takes a disjoint file shard and tags its
    # output shards (the pod-slice analog of the reference's per-process
    # bidx shards, file_proc.py:1197-1245)
    import jax

    pi, pc = jax.process_index(), jax.process_count()
    shard_tag = ""
    if pc > 1:
        from warpdemux_tpu.parallel.multihost import host_shard_tag, shard_files

        files = shard_files(files, pi, pc)
        shard_tag = host_shard_tag(pi) + "_"

    run_dir = run_dir or _make_run_dir(args.output, command, args.create_subdir)
    _setup_logging(run_dir)
    logging.info(
        "run dir: %s (%d pod5 files%s)", run_dir, len(files),
        f", host {pi}/{pc}" if pc > 1 else "",
    )

    overrides = parse_export_overrides(args.export)
    spc = get_model_spc_config(args.model_name, overrides)

    do_predict = command == "demux"
    save_fpts = args.save_fpts or command == "prep"
    bidx = bidx or (0, 0, 0)
    config = Config(
        input=InputConfig(
            files=files,
            read_ids_incl=_read_id_file(args.read_id_csv),
            read_ids_excl=read_ids_excl or set(),
        ),
        output=OutputConfig(
            output_dir=run_dir,
            save_fpts=save_fpts,
            save_dwell_time=args.save_dwell_time,
            save_boundaries=args.save_boundaries or command == "prep",
            save_predictions=do_predict,
            shard_tag=shard_tag,
        ),
        batch=BatchConfig(
            minibatch_size=args.minibatch_size,
            batch_size_output=args.batch_size_output,
            bidx_pass=bidx[0],
            bidx_fail=bidx[1],
            bidx_predict=bidx[2],
            devices=getattr(args, "devices", 1),
            wire=getattr(args, "wire", "vbz"),
            stage1_preload=getattr(args, "stage1_preload", 7168),
        ),
        task=TaskConfig(command=command, preprocess=True, predict=do_predict),
        classif=ClassifConfig(model_name=args.model_name),
        sig_proc=spc,
    )
    if pi == 0:  # one manifest per run, even when hosts share a filesystem
        config.write_command_json(sys.argv[1:])
        # snapshot the resolved chemistry config into the run dir (reference
        # main.py:69-71)
        from warpdemux_tpu.config.utils import (
            dump_toml, resolve_model_chemistry_dict,
        )

        (Path(run_dir) / "config.toml").write_text(
            dump_toml(resolve_model_chemistry_dict(args.model_name, overrides))
        )
    if getattr(args, "profile_dir", None):
        import contextlib

        import jax

        profile_ctx = jax.profiler.trace(args.profile_dir)
        logging.info("profiling to %s", args.profile_dir)
    else:
        import contextlib

        profile_ctx = contextlib.nullcontext()
    with profile_ctx:
        stats = run_demux(config)
    print(
        f"done: {stats.total} reads, {stats.passed} pass, {stats.failed} fail,"
        f" {stats.predicted} predicted, {stats.elapsed_s:.1f}s"
        f" ({stats.total / max(stats.elapsed_s, 1e-9):.0f} reads/s)"
    )
    return 0


def _cmd_predict(args):
    from warpdemux_tpu.config.config import (
        BatchConfig, ClassifConfig, Config, InputConfig, OutputConfig,
        TaskConfig,
    )
    from warpdemux_tpu.config.utils import get_model_spc_config
    from warpdemux_tpu.pipeline.run import run_predict_from_fpts

    manifest = Config.read_command_json(args.input)
    if manifest["command"] not in ("prep",):
        raise SystemExit(
            f"predict requires a prep run dir; {args.input} was a "
            f"{manifest['command']} run"
        )
    model_name = args.model_name or manifest["model_name"]
    fpt_files = sorted(
        str(p) for p in (Path(args.input) / "fingerprints").glob("*.npz")
    )
    if not fpt_files:
        raise SystemExit(f"no fingerprints found in {args.input}/fingerprints")
    _setup_logging(args.input)
    spc = get_model_spc_config(model_name)
    # failed_reads shards from the prep run already occupy bidx 0..N; the
    # predict pass (non-finite fingerprints) continues the numbering
    from warpdemux_tpu.pipeline.resume import scan_processed_reads

    _, _, bidx_fail, _ = scan_processed_reads(args.input, "fingerprints")
    config = Config(
        input=InputConfig(files=fpt_files),
        output=OutputConfig(output_dir=args.input, save_predictions=True),
        batch=BatchConfig(
            batch_size_output=args.batch_size_output, bidx_fail=bidx_fail
        ),
        task=TaskConfig(command="predict", preprocess=False, predict=True),
        classif=ClassifConfig(model_name=model_name),
        sig_proc=spc,
    )
    stats = run_predict_from_fpts(config)
    print(
        f"done: {stats.predicted} predicted of {stats.total} fingerprints "
        f"in {stats.elapsed_s:.1f}s"
    )
    return 0


def _cmd_continue(args):
    from warpdemux_tpu.config.config import Config
    from warpdemux_tpu.pipeline.resume import scan_processed_reads

    manifest = Config.read_command_json(args.input)
    processed, bp, bf, bpr = scan_processed_reads(
        args.input,
        "predictions" if manifest["command"] == "demux" else "fingerprints",
    )
    logging.info("continue: %d reads already processed", len(processed))

    ns = argparse.Namespace(
        input=manifest["input_files"],
        output=args.input,
        model_name=args.model_name or manifest["model_name"],
        minibatch_size=args.minibatch_size
        or manifest["batch"]["minibatch_size"],
        batch_size_output=manifest["batch"]["batch_size_output"],
        read_id_csv=None,
        export=[],
        save_dwell_time=manifest["output"]["save_dwell_time"],
        save_boundaries=manifest["output"]["save_boundaries"],
        save_fpts=manifest["output"]["save_fpts"],
        create_subdir=False,
        devices=manifest["batch"].get("devices", 1),
        wire=manifest["batch"].get("wire", "vbz"),
        stage1_preload=manifest["batch"].get("stage1_preload", 7168),
    )
    return _run_batch_command(
        ns,
        manifest["command"],
        read_ids_excl=processed,
        run_dir=args.input,
        bidx=(bp, bf, bpr),
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command in ("predict", "continue"):
        args.input = args.input or args.input_dir
        if not args.input:
            raise SystemExit(f"{args.command} requires a run directory")
    _init_jax(
        getattr(args, "jax_platform", None),
        getattr(args, "coordinator", None),
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None),
    )
    if args.command in ("demux", "prep"):
        return _run_batch_command(args, args.command)
    if args.command == "predict":
        return _cmd_predict(args)
    if args.command == "continue":
        return _cmd_continue(args)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
