"""Operations and bytes of one launch of ``csrc/fast_score_nms.cu``: FAST-9
score and non-maximum suppression of every pyramid level of a frame.

Bytes: each pixel of each level read once as float32 (4) and its raw and
suppressed scores written once (8). Operations a pixel (float32): the
×255, 16 differences, 32 compares, 32 × (subtract, clamp, add), the sum
of the two, (2r + 1)² − 1 maxima of the suppression, 2 keeps. The
counts of ``chip_smoke.py`` phase 3 at commit 6b05da9 (6,911,844 bytes a
frame at 640×480 and four levels)."""

KERNEL = "fast_score_nms_kernel"


def pyramid_pixels(cfg) -> int:
    H, W = cfg.camera.height, cfg.camera.width
    det = cfg.detector
    total = 0
    for lvl in range(det.n_pyramid_levels):
        s = det.scale_factor ** lvl
        total += max(int(round(H / s)), 32) * max(int(round(W / s)), 32)
    return total


def counts(cfg):
    """(float operations, bytes) of one launch for ``cfg``."""
    n = pyramid_pixels(cfg)
    r = cfg.detector.nms_radius
    return n * (1 + 16 + 32 + 96 + 1 + (2 * r + 1) ** 2 - 1 + 2), 12 * n
