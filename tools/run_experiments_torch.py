#!/usr/bin/env python
"""Batch experiment driver + result aggregation, through the PyTorch port
(the counterpart of ``tools/run_experiments.py:29-112``).

The analog of the reference's experiment tooling (scripts/runPUTSLAM.py
:15-40 — iterate over ``configs/*`` preset directories, run the engine on
each, evaluate ATE/RPE — and scripts/summarizeResults.py:16-30, which
aggregates the per-run RMSEs into ``resultSummary``). Each preset directory
is loaded as an operating point (``--reference-resources``) and
``putslam_tpu_torch.run.main`` runs in-process on ``--device``.

    python tools/run_experiments_torch.py --configs CONFIGS \\
        [--dataset /data/fr1_desk | --synthetic 60] --out results/ \\
        [--device cuda]

Writes one subdirectory per preset (the usual trajectory/fps/times outputs)
plus ``resultSummary.json`` with per-preset ATE/RPE/fps and min/mean/max
aggregates.
"""

import argparse
import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

AGGREGATE_KEYS = ("ate_rmse_m", "ate_before_final_m", "rpe_trans_m",
                  "rpe_rot_rad", "fps")


def _has_xml(directory: str) -> bool:
    return any(f.startswith("putslam") and f.endswith(".xml")
               for f in os.listdir(directory))


def discover_presets(configs_dir: str):
    """Preset = any subdirectory containing at least one putslam*.xml (the
    reference's configs/<name>/ layout); the configs dir itself counts if it
    holds the XMLs directly. [(name, path)], sorted by name after the
    directory itself."""
    presets = []
    if _has_xml(configs_dir):
        presets.append(("default", configs_dir))
    for name in sorted(os.listdir(configs_dir)):
        sub = os.path.join(configs_dir, name)
        if os.path.isdir(sub) and _has_xml(sub):
            presets.append((name, sub))
    return presets


def aggregate(summary: dict) -> dict:
    """min / max / mean / n of each aggregate key over the presets that
    report it (None where none does)."""
    out = {}
    for key in AGGREGATE_KEYS:
        vals = [r[key] for r in summary.values() if key in r]
        out[key] = None if not vals else {
            "min": min(vals), "max": max(vals),
            "mean": sum(vals) / len(vals), "n": len(vals)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--configs", required=True,
                    help="directory of preset resources/ directories")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--dataset-name", default=None,
                    help="datasetConfig/<name>.xml inside each preset")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--out", default="results")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device, passed to run.py (default cuda)")
    args = ap.parse_args(argv)

    from putslam_tpu_torch import run as run_mod

    presets = discover_presets(args.configs)
    if not presets:
        print(f"no presets found under {args.configs}", file=sys.stderr)
        return 1

    summary = {}
    for name, path in presets:
        cli = ["--reference-resources", path,
               "--out", os.path.join(args.out, name),
               "--seed", str(args.seed), "--device", args.device]
        if args.dataset_name:
            cli += ["--dataset-name", args.dataset_name]
        if args.dataset:
            cli += ["--dataset", args.dataset]
        else:
            cli += ["--synthetic", str(args.synthetic or 60)]
        print(f"== preset {name} ({path})", file=sys.stderr, flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_mod.main(cli)
        line = [ln for ln in buf.getvalue().splitlines()
                if ln.startswith("{")]
        report = json.loads(line[-1]) if line else {}
        report["returncode"] = rc
        summary[name] = report
        print(json.dumps({name: report}), file=sys.stderr, flush=True)

    result = {"presets": summary, "aggregate": aggregate(summary)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "resultSummary.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result["aggregate"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
