"""ICL-NUIM dataset preparation: POV-Ray output → TUM-layout sequence, the
port's own copy of ``putslam_tpu/io/icl.py:41-131``.

ICL's ``scene_NNNN.depth`` text files store per-pixel euclidean ray
distances; the conversion projects them to planar z-depth through the
pinhole model, ``z = d / √(1 + ((u−cu)/fu)² + ((v−cv)/fv)²)``, and writes
16-bit PNGs that ``io/tum.py``'s ``TumDataset`` replays. The depth PNG is
written with ``io/png.py`` (the reference uses PIL for it; the pixel values
are the same). Host side only: no device.

Output: ``rgb/``, ``depth/``, ``rgb.txt``, ``depth.txt`` (30 Hz synthetic
timestamps, ICL has no clock) and ``groundtruth.txt`` when a trajectory file
is present.

Usage:
    python -m putslam_tpu_torch.io.icl /data/icl/office0 /data/office0_tum
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import sys

import numpy as np

from putslam_tpu_torch.io import png as png_mod

# ICL-NUIM camera: principal point (319.5, 239.5); depth PNGs are written at
# scale 5000 like TUM.
ICL_FU = 481.20
ICL_FV = -480.00   # ICL's y-axis points up; only the magnitude is used
ICL_CU = 319.50
ICL_CV = 239.50


def ray_to_z(dist: np.ndarray, fu: float = ICL_FU, fv: float = ICL_FV,
             cu: float = ICL_CU, cv: float = ICL_CV) -> np.ndarray:
    """Euclidean ray distance (H, W) → planar z-depth (H, W) f32, each axis
    normalised by its own focal length (``putslam_tpu/io/icl.py:41``)."""
    H, W = dist.shape
    un = (np.arange(W, dtype=np.float64)[None, :] - cu) / fu
    vn = (np.arange(H, dtype=np.float64)[:, None] - cv) / abs(fv)
    denom = np.sqrt(1.0 + un * un + vn * vn)
    return (dist / denom).astype(np.float32)


def read_icl_depth(path: str, width: int = 640, height: int = 480
                   ) -> np.ndarray:
    """Parse one ``scene_NNNN.depth`` text file → ray distances (H, W), in
    the one-line or the line-per-row layout
    (``putslam_tpu/io/icl.py:55``)."""
    vals = np.fromfile(path, dtype=np.float64, sep=" ")
    if vals.size != width * height:
        raise ValueError(
            f"{path}: {vals.size} values, expected {width * height}")
    return vals.reshape(height, width)


def _write_depth_png(path: str, z_m: np.ndarray, scale: float) -> None:
    png_mod.write_png(path, np.clip(z_m * scale, 0, 65535).astype(np.uint16))


def prepare_icl_sequence(src: str, out: str, depth_scale: float = 5000.0,
                         fps: float = 30.0) -> int:
    """Convert an ICL-NUIM POV-Ray directory (scene_NNNN.png + .depth, and a
    trajectory file named *freiburg*) into a TUM-layout directory
    (``putslam_tpu/io/icl.py:71``). Returns the number of frames written."""
    os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out, "depth"), exist_ok=True)

    def frame_no(p):
        return int(re.search(r"(\d+)\.depth$", p).group(1))

    depth_files = sorted(glob.glob(os.path.join(src, "scene_*.depth")),
                         key=frame_no)
    if not depth_files:
        depth_files = sorted(glob.glob(os.path.join(src, "*.depth")),
                             key=frame_no)
    rgb_lines, depth_lines = [], []
    n = 0
    for df in depth_files:
        rgb_src = df[:-len(".depth")] + ".png"
        if not os.path.exists(rgb_src):
            continue
        ts = n / fps
        rgb_rel = f"rgb/{n:05d}.png"
        depth_rel = f"depth/{n:05d}.png"
        shutil.copy(rgb_src, os.path.join(out, rgb_rel))
        dist = read_icl_depth(df)
        _write_depth_png(os.path.join(out, depth_rel), ray_to_z(dist),
                         depth_scale)
        rgb_lines.append(f"{ts:.6f} {rgb_rel}")
        depth_lines.append(f"{ts:.6f} {depth_rel}")
        n += 1

    with open(os.path.join(out, "rgb.txt"), "w") as f:
        f.write("# color images\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out, "depth.txt"), "w") as f:
        f.write("# depth maps\n" + "\n".join(depth_lines) + "\n")

    for cand in glob.glob(os.path.join(src, "*freiburg*")):
        shutil.copy(cand, os.path.join(out, "groundtruth.txt"))
        break
    return n


def main(argv=None) -> int:
    """``python -m putslam_tpu_torch.io.icl SRC OUT [DEPTH_SCALE]``
    (``putslam_tpu/io/icl.py:118``)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    n = prepare_icl_sequence(argv[0], argv[1],
                             depth_scale=float(argv[2]) if len(argv) > 2
                             else 5000.0)
    print(f"wrote {n} frames to {argv[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
