"""Inputs of the detector's keypoint chain (``ops/keypoints.py``) for its CPU
and card tests, and the chain's inputs built as ``detect_and_describe``
builds them. Imports no JAX (the card's machine has none).

A case is (config, gray (H, W), depth (H, W)) on a device: rendered fr1
frames (``io/synthetic.py``'s room), and made-up frames for the edges: no
corner at all, a few corners (most slots empty), equal corners on a grid
(tied scores), corners inside the border, depth at 0, at and beyond the
gate, and the tiny config's two levels."""

from __future__ import annotations

import dataclasses

import torch

from putslam_tpu_torch.config import tiny_test_config, tum_fr1_config
from putslam_tpu_torch.frontend import detector
from putslam_tpu_torch.io import synthetic
from putslam_tpu_torch.ops import fast_cuda

CASES = ("fr1_0", "fr1_1", "fr1_2", "fr1_ldb", "no_corner", "few_corners",
         "tied", "border", "depth_edges", "tiny")


def _squares(H, W, spots, size=3, low=0.2, high=0.9):
    """A ``low`` image with ``size``-pixel ``high`` squares at ``spots``
    (top-left corners)."""
    g = torch.full((H, W), low)
    for y, x in spots:
        g[y:y + size, x:x + size] = high
    return g


def make(name: str, device="cpu"):
    """(cfg, gray, depth) of case ``name`` on ``device``."""
    cfg = tum_fr1_config()
    H, W = cfg.camera.height, cfg.camera.width
    flat_depth = torch.full((H, W), 2.0)
    if name.startswith("fr1") or name == "depth_edges":
        i = int(name[-1]) if name[-1].isdigit() else 1
        pose = synthetic.orbit_trajectory(3, radius=0.10, yaw_amp=0.1)[i]
        gray, depth = synthetic.render_frame(cfg.camera, pose)
        if name == "fr1_ldb":
            cfg = cfg.replace(detector=dataclasses.replace(
                cfg.detector, descriptor="ldb"))
        if name == "depth_edges":
            depth = depth.clone()
            depth[:, :W // 4] = 0.0
            depth[:, W // 4:W // 4 + 40] = cfg.camera.min_depth
            depth[:, W // 2:W // 2 + 40] = cfg.camera.max_depth
            depth[:, 3 * W // 4:] = 9.0
    elif name == "no_corner":
        gray, depth = torch.full((H, W), 0.5), flat_depth
    elif name == "few_corners":
        gray = _squares(H, W, [(100, 150), (240, 400), (300, 90)], size=6)
        depth = flat_depth
    elif name == "tied":
        gray = _squares(H, W, [(y, x) for y in range(30, H - 30, 16)
                               for x in range(30, W - 30, 16)])
        depth = flat_depth
    elif name == "border":
        spots = ([(y, 2) for y in range(8, H - 8, 24)]
                 + [(y, W - 12) for y in range(8, H - 8, 24)]
                 + [(5, x) for x in range(30, W - 30, 24)]
                 + [(H - 20, x) for x in range(30, W - 30, 24)]
                 + [(200, 200)])
        gray, depth = _squares(H, W, spots, size=5), flat_depth
    elif name == "tiny":
        cfg = tiny_test_config()
        pose = synthetic.orbit_trajectory(3, radius=0.10, yaw_amp=0.1)[1]
        gray, depth = synthetic.render_frame(cfg.camera, pose)
    else:
        raise KeyError(name)
    return cfg, gray.to(device).contiguous(), depth.to(device).contiguous()


def chain_inputs(cfg, gray, depth):
    """(det, cam, shapes, budgets, levels, maps, depth): what
    ``detect_and_describe`` hands ``keypoints.chain``."""
    det = cfg.detector
    shapes = detector._pyramid_shapes(cfg)
    levels = [gray.contiguous()] + [detector.resize(gray, s).contiguous()
                                    for s in shapes[1:]]
    maps = fast_cuda.fast_score_nms_levels(levels, det.fast_threshold,
                                           det.nms_radius)
    return (det, cfg.camera, shapes, detector._level_budgets(cfg), levels,
            maps, depth)
