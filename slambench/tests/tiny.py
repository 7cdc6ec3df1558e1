"""A tiny cell for the CPU tests: the harness's own files copied into a
temporary checkout, plus a configuration at the port's tiny test sizes
(128×96) and two traffic mixes of 30-frame sequences, added as new
files and entries the way a later cell is added."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from slambench import spec

TINY_CONFIG = {
    "source": "the port's tiny test configuration", "fps": 30,
    "duration_s": 1.0,
    "slam": {
        "camera": {"fu": 80.0, "fv": 80.0, "cu": 64.0, "cv": 48.0, "k1": 0.0,
                   "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": 128,
                   "height": 96},
        "detector": {"max_features": 128, "grid_rows": 3, "grid_cols": 4,
                     "n_pyramid_levels": 2, "border": 8},
        "ransac": {"n_hypotheses": 128, "inlier_threshold_euclidean": 0.10},
        "map": {"max_landmarks": 512, "max_keyframes": 32},
        "backend": {"max_pose_pose_edges": 64, "max_observations": 4096,
                    "pcg_iterations": 32, "solver": "dense_schur"}},
    "reduced": [], "assumed": {},
    # the landmarks' optimality step of the tiny graphs on the CPU: sound
    # runs read at most 0.00019 mm over 12 seeds, the bfloat16 control 3.1 mm
    # or more
    "limits": {"ba_landmark_step_mm": 0.002}}
WALK = {"step_t": 0.013, "step_r": 0.011}
TRAFFIC = {
    "tiny_offline": {"mode": "offline", "pool": 2, "chunk_size": 8,
                     "walk": WALK},
    "tiny_live": {"mode": "live", "rate_hz": 30, "pool": 1,
                  "trace_frames": 10, "walk": WALK},
}
CELLS = {"tiny.offline": "tiny_offline", "tiny.live": "tiny_live"}


def checkout(tmp: Path) -> Path:
    """A checkout under ``tmp`` with the tiny cells added; returns its
    root."""
    here = tmp / "slambench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (here / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, body in TRAFFIC.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(body))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "slambench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for cell, traffic in CELLS.items():
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
        mode = TRAFFIC[traffic]["mode"]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(mode in w for w in m.get("workloads", [])):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def cell(root: Path, name: str):
    return spec.load_cell(name, root, root / "slambench")
