#!/usr/bin/env python
"""Convert a TUM-layout dataset directory into the reference FileGrabber's
layout, through the PyTorch port's ``io/tum.py`` (the counterpart of
``tools/export_reference_dataset.py``; the reference's fileGrabber.cpp
:34-145, :223-237 and scripts/prepareDatasetFreiburg.py):

    rgb_%05d.png / depth_%05d.png   (copied byte for byte, renamed)
    matched                          (per frame: "ts_rgb ts_depth")
    initialPosition                  ("x y z qx qy qz qw" from groundtruth)
    groundtruth.txt                  (copied)

File copies and the TUM association only: nothing is decoded and no device
is used.

    python tools/export_reference_dataset_torch.py --tum DIR --out DIR
"""

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tum", required=True, help="TUM-layout source dir")
    ap.add_argument("--out", required=True, help="FileGrabber-layout dir")
    args = ap.parse_args(argv)

    from putslam_tpu_torch.io import tum

    rgb = tum._read_file_list(os.path.join(args.tum, "rgb.txt"))
    depth = tum._read_file_list(os.path.join(args.tum, "depth.txt"))
    pairs = tum.associate(rgb, depth)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "matched"), "w") as mf:
        for n, (i, j) in enumerate(pairs):
            ts_r, rgb_rel = rgb[i][0], rgb[i][1][0]
            ts_d, depth_rel = depth[j][0], depth[j][1][0]
            shutil.copyfile(os.path.join(args.tum, rgb_rel),
                            os.path.join(args.out, f"rgb_{n:05d}.png"))
            shutil.copyfile(os.path.join(args.tum, depth_rel),
                            os.path.join(args.out, f"depth_{n:05d}.png"))
            mf.write(f"{ts_r:.6f} {ts_d:.6f}\n")
    gt_path = os.path.join(args.tum, "groundtruth.txt")
    if os.path.exists(gt_path):
        _, poses = tum.load_trajectory(gt_path)
        x, y, z, qw, qx, qy, qz = [float(v) for v in poses[0]]
        with open(os.path.join(args.out, "initialPosition"), "w") as f:
            f.write(f"{x} {y} {z} {qx} {qy} {qz} {qw}\n")
        shutil.copyfile(gt_path, os.path.join(args.out, "groundtruth.txt"))
    print(f"exported {len(pairs)} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
