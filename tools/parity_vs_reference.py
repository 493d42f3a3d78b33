"""Reference-differential parity harness (VERDICT r3 missing #1).

Runs the SAME pod5 through (a) the upstream WarpDemuX CLI (a working
checkout + its pinned environment, /root/reference/environment.yml:1-24)
and (b) this framework's CLI, then diffs the per-read outputs:

  - `predicted_barcode` (the north-star: bit-identical assignments)
  - `confidence_score` (reference contract rounds to 3 dp,
    /root/reference/warpdemux/models/utils.py:36-43)
  - per-class probability columns (4 dp)
  - the pass/fail split and fail reasons

The reference environment is NOT installable in this container (no
network egress; dtaidistance/cython missing), so the harness degrades
gracefully: `--check-only` reports whether the supplied interpreter can
actually import the reference stack, and the diff half
(`diff_runs`) is importable and unit-tested on its own
(tests/test_parity_harness.py) so the comparison logic is proven even
where the reference cannot run.

Usage (in an environment with the reference env available):

    python tools/parity_vs_reference.py \
        --pod5 /path/to/reads.pod5 \
        --reference-python /opt/conda/envs/WDX/bin/python \
        --reference-repo /root/reference \
        --model WDX4_rna004_v1_0 --workdir /tmp/parity

Exit codes: 0 = bit-identical barcode assignments; 2 = disagreements
(report printed); 3 = reference environment unavailable.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd


def _load_csvs(run_dir: str, subdir: str) -> pd.DataFrame:
    files = sorted(glob.glob(os.path.join(run_dir, subdir, "*.csv.gz")))
    if not files:
        return pd.DataFrame()
    return pd.concat(
        [pd.read_csv(f) for f in files], ignore_index=True
    )


def _find_run_dir(out_dir: str) -> str:
    """Both CLIs create one timestamped run dir under the output dir."""
    entries = [
        p
        for p in glob.glob(os.path.join(out_dir, "*"))
        if os.path.isdir(p)
    ]
    if len(entries) == 1:
        return entries[0]
    if not entries and os.path.isdir(os.path.join(out_dir, "predictions")):
        return out_dir  # --no-create_subdir style layout
    raise FileNotFoundError(
        f"expected exactly one run dir under {out_dir}, found {entries}"
    )


def diff_runs(ref_run_dir: str, ours_run_dir: str) -> dict:
    """Diff two completed demux run dirs (reference layout: predictions/
    + failed_reads/ csv.gz shards). Returns the parity report dict."""
    ref_pred = _load_csvs(ref_run_dir, "predictions")
    ours_pred = _load_csvs(ours_run_dir, "predictions")
    ref_fail = _load_csvs(ref_run_dir, "failed_reads")
    ours_fail = _load_csvs(ours_run_dir, "failed_reads")

    rid = "#read_id" if "#read_id" in ref_pred.columns else "read_id"
    tid = "#read_id" if "#read_id" in ours_pred.columns else "read_id"
    report: dict = {
        "ref_predicted": len(ref_pred),
        "ours_predicted": len(ours_pred),
        "ref_failed": len(ref_fail),
        "ours_failed": len(ours_fail),
    }

    ref_ids = set(ref_pred[rid]) if len(ref_pred) else set()
    ours_ids = set(ours_pred[tid]) if len(ours_pred) else set()
    report["pass_only_in_ref"] = sorted(ref_ids - ours_ids)
    report["pass_only_in_ours"] = sorted(ours_ids - ref_ids)

    both = ref_ids & ours_ids
    if both:
        r = ref_pred.set_index(rid).loc[sorted(both)]
        t = ours_pred.set_index(tid).loc[sorted(both)]
        bc_match = (
            r["predicted_barcode"].to_numpy().astype(int)
            == t["predicted_barcode"].to_numpy().astype(int)
        )
        report["n_compared"] = len(both)
        report["barcode_agreement"] = float(bc_match.mean())
        report["barcode_disagreements"] = [
            {
                "read_id": i,
                "ref": int(rv),
                "ours": int(tv),
                "ref_conf": float(rc),
                "ours_conf": float(tc),
            }
            for i, rv, tv, rc, tc in zip(
                r.index[~bc_match],
                r["predicted_barcode"].to_numpy()[~bc_match],
                t["predicted_barcode"].to_numpy()[~bc_match],
                r["confidence_score"].to_numpy()[~bc_match],
                t["confidence_score"].to_numpy()[~bc_match],
            )
        ]
        dconf = np.abs(
            r["confidence_score"].to_numpy()
            - t["confidence_score"].to_numpy()
        )
        report["conf_max_abs_delta"] = float(dconf.max())
        report["conf_mean_abs_delta"] = float(dconf.mean())
        pcols = [
            c
            for c in r.columns
            if c.startswith("p") and c[1:].lstrip("-").isdigit()
        ]
        shared_pcols = [c for c in pcols if c in t.columns]
        if shared_pcols:
            dp = np.abs(
                r[shared_pcols].to_numpy() - t[shared_pcols].to_numpy()
            )
            report["prob_max_abs_delta"] = float(dp.max())
    else:
        report["n_compared"] = 0

    # fail-reason cross-tab over reads failed in both
    if len(ref_fail) and len(ours_fail):
        rfid = "#read_id" if "#read_id" in ref_fail.columns else "read_id"
        tfid = "#read_id" if "#read_id" in ours_fail.columns else "read_id"
        rmap = dict(
            zip(ref_fail[rfid], ref_fail.get("fail_reason", ""))
        )
        tmap = dict(
            zip(ours_fail[tfid], ours_fail.get("fail_reason", ""))
        )
        cross: dict = {}
        for i in set(rmap) & set(tmap):
            key = f"{rmap[i]} -> {tmap[i]}"
            cross[key] = cross.get(key, 0) + 1
        report["fail_reason_crosstab"] = dict(
            sorted(cross.items(), key=lambda kv: -kv[1])
        )
    return report


def check_reference_env(python: str, repo: str) -> tuple[bool, str]:
    """Can `python` import the full reference stack from `repo`?"""
    probe = (
        "import warpdemux, dtaidistance, pod5, sklearn, torch;"
        "from warpdemux.models.utils import available_models;"
        "print(','.join(available_models()))"
    )
    env = dict(os.environ, PYTHONPATH=repo)
    try:
        out = subprocess.run(
            [python, "-c", probe],
            env=env,
            capture_output=True,
            text=True,
            timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return False, str(e)
    if out.returncode != 0:
        return False, out.stderr.strip().splitlines()[-1] if out.stderr else "?"
    return True, out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pod5", nargs="+", help="input pod5 file(s)")
    ap.add_argument(
        "--reference-python",
        default=os.environ.get("WDX_REFERENCE_PYTHON", sys.executable),
        help="python interpreter of the reference (WDX conda) env",
    )
    ap.add_argument("--reference-repo", default="/root/reference")
    ap.add_argument("--model", default="WDX4_rna004_v1_0")
    ap.add_argument("--ncores", type=int, default=4)
    ap.add_argument("--workdir", default="/tmp/wdx_parity")
    ap.add_argument(
        "--check-only",
        action="store_true",
        help="only verify the reference environment is runnable",
    )
    ap.add_argument(
        "--diff-only",
        nargs=2,
        metavar=("REF_RUN_DIR", "OUR_RUN_DIR"),
        help="skip both runs; diff two existing run dirs",
    )
    args = ap.parse_args(argv)

    if args.diff_only:
        report = diff_runs(*args.diff_only)
        print(json.dumps(report, indent=2))
        return 0 if report.get("barcode_agreement") == 1.0 else 2

    ok, msg = check_reference_env(
        args.reference_python, args.reference_repo
    )
    if args.check_only:
        print(f"reference env {'OK' if ok else 'UNAVAILABLE'}: {msg}")
        return 0 if ok else 3
    if not ok:
        print(
            f"reference environment unavailable ({msg}); supply a working "
            "env via --reference-python (pins: "
            f"{args.reference_repo}/environment.yml)",
            file=sys.stderr,
        )
        return 3
    if not args.pod5:
        ap.error("--pod5 is required unless --check-only/--diff-only")

    ref_out = os.path.join(args.workdir, "ref")
    ours_out = os.path.join(args.workdir, "ours")
    os.makedirs(ref_out, exist_ok=True)
    os.makedirs(ours_out, exist_ok=True)

    env = dict(os.environ, PYTHONPATH=args.reference_repo)
    subprocess.run(
        [
            args.reference_python,
            "-m",
            "warpdemux.main",
            "demux",
            "-i",
            *args.pod5,
            "-o",
            ref_out,
            "-m",
            args.model,
            "-j",
            str(args.ncores),
        ],
        env=env,
        check=True,
    )
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run(
        [
            sys.executable,
            "-m",
            "warpdemux_tpu.cli",
            "demux",
            "-i",
            *args.pod5,
            "-o",
            ours_out,
            "-m",
            args.model,
        ],
        cwd=repo_root,
        check=True,
    )

    report = diff_runs(_find_run_dir(ref_out), _find_run_dir(ours_out))
    print(json.dumps(report, indent=2))
    agree = report.get("barcode_agreement")
    print(
        f"# barcode agreement: {agree} over {report.get('n_compared')} "
        f"reads; conf max |delta| {report.get('conf_max_abs_delta')}",
        file=sys.stderr,
    )
    return 0 if agree == 1.0 else 2


if __name__ == "__main__":
    sys.exit(main())
