"""TUM RGB-D dataset player and trajectory I/O, the port's own copy of
``putslam_tpu/io/tum.py:23-211``.

Host side only (PNG decode, timestamp association): plain numpy, no device.
Frames come out as float arrays; depth is turned to metres with
``depth_scale`` counts per metre (5000 in the TUM files).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from putslam_tpu_torch.io import native_loader
from putslam_tpu_torch.io import png as png_mod


def _read_file_list(path: str) -> List[Tuple[float, List[str]]]:
    """Parse a TUM list file: ``timestamp data...`` lines, '#' comments
    (``putslam_tpu/io/tum.py:23``)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(a: Sequence[Tuple[float, List[str]]],
              b: Sequence[Tuple[float, List[str]]],
              offset: float = 0.0,
              max_difference: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (``putslam_tpu/io/tum.py:37``):
    all pairs within ``max_difference``, best first, each element used once."""
    cand = []
    for i, (ta, _) in enumerate(a):
        for j, (tb, _) in enumerate(b):
            d = abs(ta - (tb + offset))
            if d < max_difference:
                cand.append((d, i, j))
    cand.sort()
    used_a, used_b, pairs = set(), set(), []
    for _, i, j in cand:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    pairs.sort()
    return pairs


@dataclass
class TumFrame:
    """One associated frame (``putslam_tpu/io/tum.py:60``)."""
    timestamp: float
    gray: np.ndarray    # (H, W) float32 in [0, 1]
    depth: np.ndarray   # (H, W) float32 metres (0 = invalid)


class TumDataset:
    """Associated (rgb, depth) frames of a TUM-layout directory holding
    rgb.txt / depth.txt and optionally groundtruth.txt
    (``putslam_tpu/io/tum.py:67``). ``loader`` says which decoder the last
    iteration used: ``"native"`` or ``"python"``."""

    def __init__(self, root: str, depth_scale: float = 5000.0,
                 max_difference: float = 0.02):
        self.root = root
        self.depth_scale = depth_scale
        self.loader = "python"
        rgb = _read_file_list(os.path.join(root, "rgb.txt"))
        depth = _read_file_list(os.path.join(root, "depth.txt"))
        self.pairs = [
            (rgb[i][0], rgb[i][1][0], depth[j][1][0])
            for i, j in associate(rgb, depth, 0.0, max_difference)
        ]
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth = (
            load_trajectory(gt_path) if os.path.exists(gt_path) else None
        )

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> TumFrame:
        ts, rgb_rel, depth_rel = self.pairs[idx]
        rgb = png_mod.read_png(os.path.join(self.root, rgb_rel))
        if rgb.ndim == 3:
            gray = (rgb[..., :3].astype(np.float32) @
                    np.array([0.299, 0.587, 0.114], np.float32)) / 255.0
        else:
            gray = rgb.astype(np.float32) / 255.0
        d16 = png_mod.read_png(os.path.join(self.root, depth_rel))
        depth = d16.astype(np.float32) / self.depth_scale
        return TumFrame(ts, gray, depth)

    def __iter__(self) -> Iterator[TumFrame]:
        """Iterate frames through the native threaded prefetcher where its
        library loads, else through the Python decoder
        (``putslam_tpu/io/tum.py:103``). Frame 0 is decoded once by the
        Python path to learn the image size."""
        if len(self) and native_loader.available():
            self.loader = "native"
            probe = self[0]
            h, w = probe.gray.shape
            rgb_paths = [os.path.join(self.root, p[1]) for p in self.pairs]
            depth_paths = [os.path.join(self.root, p[2]) for p in self.pairs]
            loader = native_loader.NativeLoader(
                rgb_paths, depth_paths, w, h, self.depth_scale)
            try:
                for idx, gray, depth in loader:
                    yield TumFrame(self.pairs[idx][0], gray, depth)
            finally:
                loader.close()
        else:
            self.loader = "python"
            for i in range(len(self)):
                yield self[i]

    def starting_pose(self) -> Optional[np.ndarray]:
        """First ground-truth pose as (7,) [t, q_wxyz], or None
        (``putslam_tpu/io/tum.py:125``)."""
        if self.groundtruth is None or len(self.groundtruth[0]) == 0:
            return None
        return self.groundtruth[1][0]


def load_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a TUM trajectory file → (timestamps (N,) f64, poses (N,7) f32
    [t, q_wxyz]); the file stores ``t tx ty tz qx qy qz qw``
    (``putslam_tpu/io/tum.py:133``)."""
    rows = _read_file_list(path)
    ts = np.array([r[0] for r in rows], np.float64)
    vals = np.array([[float(x) for x in r[1][:7]] for r in rows],
                    np.float32).reshape(-1, 7)
    t = vals[:, 0:3]
    q_xyzw = vals[:, 3:7]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=-1)
    return ts, np.concatenate([t, q_wxyz], axis=-1)


def save_trajectory(path: str, timestamps: np.ndarray, poses: np.ndarray) -> None:
    """Write ``t tx ty tz qx qy qz qw`` lines
    (``putslam_tpu/io/tum.py:147``)."""
    with open(path, "w") as f:
        for ts, p in zip(timestamps, poses):
            tx, ty, tz, qw, qx, qy, qz = [float(x) for x in p[:7]]
            f.write(f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def write_tum_dataset(root: str, grays: np.ndarray, depths: np.ndarray,
                      gt_poses: Optional[np.ndarray] = None,
                      timestamps: Optional[np.ndarray] = None,
                      depth_scale: float = 5000.0, fps: float = 30.0) -> str:
    """Write a sequence to disk in the TUM RGB-D layout: rgb/*.png 8-bit,
    depth/*.png 16-bit at ``depth_scale`` counts a metre, rgb.txt / depth.txt /
    groundtruth.txt (``putslam_tpu/io/tum.py:157``). The directory is a
    ``TumDataset`` root.

    grays: (T,H,W) float [0,1]; depths: (T,H,W) float metres (0 = hole).
    Returns ``root``."""
    grays = np.asarray(grays)
    depths = np.asarray(depths)
    T = grays.shape[0]
    if timestamps is None:
        timestamps = np.arange(T, dtype=np.float64) / fps
    write_tum_frames(root, grays, depths, timestamps, depth_scale)
    _write_index_files(root, timestamps)
    if gt_poses is not None:
        save_trajectory(os.path.join(root, "groundtruth.txt"),
                        timestamps, np.asarray(gt_poses))
    return root


def write_tum_frames(root: str, grays: np.ndarray, depths: np.ndarray,
                     timestamps: np.ndarray,
                     depth_scale: float = 5000.0) -> None:
    """Write the per-frame PNG pairs only (``putslam_tpu/io/tum.py:187``)."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    for i in range(len(grays)):
        ts = timestamps[i]
        g8 = np.clip(
            np.asarray(grays[i]) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        d16 = np.clip(np.asarray(depths[i]) * depth_scale + 0.5, 0,
                      65535).astype(np.uint16)
        png_mod.write_png(os.path.join(root, f"rgb/{ts:.6f}.png"), g8)
        png_mod.write_png(os.path.join(root, f"depth/{ts:.6f}.png"), d16)


def _write_index_files(root: str, timestamps: np.ndarray) -> None:
    """rgb.txt / depth.txt over the full timestamp list
    (``putslam_tpu/io/tum.py:205``)."""
    for sub, header in (("rgb", "color images"), ("depth", "depth maps")):
        with open(os.path.join(root, f"{sub}.txt"), "w") as f:
            f.write(f"# {header}\n# timestamp filename\n")
            for ts in timestamps:
                f.write(f"{ts:.6f} {sub}/{ts:.6f}.png\n")
