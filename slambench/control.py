"""The readings the check's limits are set from, on the card, at a cell's
own size. For each seed, a window of the cell's traffic, then every
number ``check.py`` compares, read from the program's outputs (the lower
readings) and with the control in the program's place (the upper
readings): the reference front end in bfloat16 with its descriptor
product in float8; the reference's re-anchoring in bfloat16; the final
graph's optimum as a bfloat16 solve could hold it at best (the final
poses and landmarks rounded to bfloat16). The benchmark's own runs never
run this.

    python3 slambench/control.py --workload <cell> --seeds 1,2,3 --seconds 30

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, seconds: float, device) -> dict:
    from slambench import check, run

    s = run.Setup(cell, seed, device, pin=device.type == "cuda")
    win = run.Window(s, cell.traffic, device, trace=False)
    getattr(win, cell.traffic["mode"])(seconds)
    win.close()
    seqs = run.records(win)
    det = dataclasses.asdict(s.cfg.detector)
    cam = dataclasses.asdict(s.cfg.camera)
    backend = dataclasses.asdict(s.cfg.backend)
    program = {k: v for k, (v, _, _) in check.numbers(
        seqs, det, cam, backend, device, cell.config.get("limits")).items()}
    kp, bits, xyz = check.frontend_numbers(
        seqs, det, cam, device,
        feats=check.control_features(seqs, det, cam, device))
    lm, kf, pooled = check.ba_steps_mm(seqs, backend, device,
                                       graphs=check.control_graphs(seqs))
    control = {"kp_unpaired": kp, "desc_bits": bits, "xyz_gap_mm": xyz,
               "reanchor_gap_mm": check.reanchor_gap_mm(
                   seqs, trajs=check.control_trajectories(seqs)),
               "ba_landmark_step_mm": lm, "ba_pose_step_mm": kf,
               "ba_pose_step_pooled_mm": pooled}
    _, kf, pooled = check.ba_steps_mm(seqs, backend, device)
    program.update(ba_pose_step_mm=kf, ba_pose_step_pooled_mm=pooled)
    return {"seed": seed, "sequences": len(seqs), "program": program,
            "control": control,
            "info": dict(check.rpe_info(seqs),
                         ate_rmse_mm=check.ate_rmse_mm(seqs))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import run, spec

    run.cache_dirs(ROOT)
    import torch

    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda")
    for seed in (int(x) for x in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
