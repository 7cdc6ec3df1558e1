#!/usr/bin/env python
"""Write a synthetic handheld RGB-D sequence to disk in TUM layout, through
the PyTorch port (the counterpart of ``tools/make_disk_dataset.py``).

Renders a handheld-dynamics sequence (``io/synthetic.handheld_trajectory``)
on the device and writes rgb/*.png (8-bit), depth/*.png (16-bit, 5000
counts a metre), rgb.txt / depth.txt / groundtruth.txt and a ``camera.json``
with the true camera of the rendered data (pinhole, no distortion). The
directory is what ``python -m putslam_tpu_torch.run --dataset DIR`` reads.

    python tools/make_disk_dataset_torch.py --frames 128 --out /tmp/handheld
    python tools/make_disk_dataset_torch.py --frames 8 --out /tmp/h8 --device cpu

Degraded variants (depth holes, noise, blur) mirror a worn sensor.
``--renderer planes`` renders with the independent plane-scene renderer
(``io/synthetic2.py``: another scene, texture and shading, and a
division-model distortion the pinhole camera.json does not advertise), on
``--device`` as well, as ``tools/make_disk_dataset.py:67-71`` does.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEGRADE_PRESETS = {
    "clean": {},
    "noisy": dict(intensity_sigma=0.03, depth_sigma=0.01, depth_dropout=0.15),
    "hard": dict(intensity_sigma=0.05, depth_sigma=0.02, depth_dropout=0.30,
                 blur=1),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=640)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--degrade", choices=sorted(DEGRADE_PRESETS),
                    default="clean")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--renderer", choices=("raycast", "planes"),
                    default="raycast",
                    help="planes = the INDEPENDENT plane-scene renderer "
                         "(io/synthetic2.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)

    from putslam_tpu_torch.config import tum_fr1_config
    from putslam_tpu_torch.io import synthetic, synthetic2, tum
    from putslam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = tum_fr1_config()
    poses = synthetic.handheld_trajectory(args.frames, seed=args.seed,
                                          device=dev)
    gt = poses.cpu().numpy()

    t0 = time.time()
    all_ts = np.arange(args.frames, dtype=np.float64) / 30.0
    deg = DEGRADE_PRESETS[args.degrade]
    for s in range(0, args.frames, args.chunk):
        e = min(s + args.chunk, args.frames)
        if args.renderer == "planes":
            g, d = synthetic2.render_sequence(cfg.camera, poses[s:e])
        else:
            g, d = synthetic.render_sequence(cfg.camera, poses[s:e])
        if deg:
            g, d = synthetic.degrade_sequence(g, d, seed=args.seed + s, **deg)
        tum.write_tum_frames(args.out, g.cpu().numpy(), d.cpu().numpy(),
                             all_ts[s:e],
                             depth_scale=cfg.camera.depth_image_scale)
        print(f"[{e}/{args.frames}] {time.time()-t0:.0f}s", flush=True)
    tum._write_index_files(args.out, all_ts)
    tum.save_trajectory(os.path.join(args.out, "groundtruth.txt"), all_ts, gt)
    # the raycaster projects undistorted rays: readers must not apply the
    # fr1 distortion correction to images that were never distorted (the
    # planes renderer's division-model lens stays unadvertised on purpose)
    with open(os.path.join(args.out, "camera.json"), "w") as f:
        json.dump({"fu": cfg.camera.fu, "fv": cfg.camera.fv,
                   "cu": cfg.camera.cu, "cv": cfg.camera.cv,
                   "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
                   "width": cfg.camera.width, "height": cfg.camera.height,
                   "depth_image_scale": cfg.camera.depth_image_scale}, f)
    print(f"done: {args.out} ({args.frames} frames, {time.time()-t0:.0f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
