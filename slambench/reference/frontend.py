"""The plain reference of the front end: a frame's keypoints, descriptors
and lifted 3D points, worked out again from its decoded images.

Plain PyTorch, written from the description of the front end the port
implements (ORB-style): a pyramid of antialiased linear downscales by
``scale_factor`` a level; on each level the FAST-9 segment test with its
score (the summed excess of the bright or dark arc over the threshold),
non-maximum suppression in a (2r+1)² window, the grid cap (one winner a
subtile, then the level's strongest), a parabola's sub-pixel offset on the
raw score, a border test; the steered BRIEF descriptor of a 32×32 patch
(box blur, intensity-centroid angle, 256 tests in the angle's bin of 24,
a bf16 product as the configuration states); and the lift of each keypoint
through the lens model's inverse and the depth gate.

It imports nothing of the port. ``dtype`` is the precision of every
float32 stage and ``desc_dtype`` that of the descriptor's bf16 product;
the check's control runs it one step below each (bfloat16, float8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 32
DESC_BITS = 256
N_BINS = 24
TEST_SIGMA = 5.0
TEST_CLIP = 12.0
PATTERN_SEED = 1234
BLUR_RADIUS = 2
DISC_RADIUS = 15.0
# the 16 pixels of the radius-3 Bresenham circle, clockwise from the top
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
          (-1, -3))
ARC = 9


@dataclass
class Keypoints:
    """A frame's keypoints, level by level in the order of their slots."""
    uv: torch.Tensor        # (N, 2) level-0 pixels
    octave: torch.Tensor    # (N,) int64
    response: torch.Tensor  # (N,)
    valid: torch.Tensor     # (N,) bool
    desc: torch.Tensor      # (N, 256) bool, the test results
    xyz: torch.Tensor       # (N, 3) camera frame, metres
    has_depth: torch.Tensor  # (N,) bool


def pyramid_shapes(H, W, levels, factor):
    out = []
    for lvl in range(levels):
        s = factor ** lvl
        out.append((max(int(round(H / s)), 32), max(int(round(W / s)), 32)))
    return out


def level_budgets(max_features, levels):
    """Keypoints a level may keep: the coarse levels halve from a quarter,
    at least 32 each, scaled into half of the total where they exceed it;
    level 0 takes the rest."""
    if levels == 1:
        return [max_features]
    coarse = [max(max_features // (2 ** (lvl + 1)), 32)
              for lvl in range(1, levels)]
    if sum(coarse) > max_features // 2:
        scale = (max_features // 2) / sum(coarse)
        coarse = [max(int(b * scale), 16) for b in coarse]
    return [max_features - sum(coarse)] + coarse


def resize_weights(n_in, n_out, dtype, device):
    """(n_in, n_out) weights of the antialiased linear resampling: a
    triangle kernel widened by the downscale factor, each output's weights
    normalised to sum 1."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - torch.abs(centre[None, :] - src[:, None]) / width,
                    min=0.0)
    w = w / w.sum(dim=0, keepdim=True)
    return w.to(dtype)


def _shift(img, dx, dy):
    """out[y, x] = img[y + dy, x + dx], 0 outside."""
    H, W = img.shape
    out = torch.zeros_like(img)
    ys = slice(max(-dy, 0), H - max(dy, 0))
    xs = slice(max(-dx, 0), W - max(dx, 0))
    yd = slice(max(dy, 0), H + min(dy, 0))
    xd = slice(max(dx, 0), W + min(dx, 0))
    out[ys, xs] = img[yd, xd]
    return out


def fast_score(img255, threshold):
    """FAST-9 score map of an image on the 0..255 scale: where the 16
    circle pixels hold 9 contiguous ones all brighter than centre +
    threshold, the sum over all 16 of max(diff − threshold, 0); the same
    for darker; 0 elsewhere and within 3 px of the border."""
    t = float(threshold)
    diffs = torch.stack([_shift(img255, dx, dy) - img255
                         for dx, dy in CIRCLE])            # (16, H, W)
    bright = diffs > t
    dark = diffs < -t
    ex_b = torch.zeros_like(img255)
    ex_d = torch.zeros_like(img255)
    for k in range(16):
        ex_b = ex_b + torch.clamp(diffs[k] - t, min=0.0)
        ex_d = ex_d + torch.clamp(-diffs[k] - t, min=0.0)

    def has_arc(mask):
        ring = torch.cat([mask, mask[:ARC - 1]])            # wrap around
        found = torch.zeros_like(mask[0])
        for s in range(16):
            run = ring[s:s + ARC].all(dim=0)
            found = found | run
        return found

    score = torch.where(has_arc(bright), ex_b, torch.zeros_like(ex_b)) \
        + torch.where(has_arc(dark), ex_d, torch.zeros_like(ex_d))
    H, W = img255.shape
    inner = torch.zeros_like(score, dtype=torch.bool)
    inner[3:H - 3, 3:W - 3] = True
    return torch.where(inner, score, torch.zeros_like(score))


def suppress(score, radius):
    """Keep a positive score that no score within a (2r+1)² window exceeds."""
    w = 2 * radius + 1
    pooled = F.max_pool2d(score[None, None].float(), w, stride=1,
                          padding=radius)[0, 0].to(score.dtype)
    return torch.where((score >= pooled) & (score > 0), score,
                       torch.zeros_like(score))


def grid_cap(score, rows, cols, budget):
    """One candidate a subtile (the first maximum in row-major order) of
    an m×m split of each of the rows×cols cells, m the ceiling of the root
    of twice a cell's share of the budget; then the ``budget`` strongest
    candidates, equal scores in tile order. Returns (uv (budget, 2),
    response, valid)."""
    H, W = score.shape
    k_cell = 2 * math.ceil(budget / (rows * cols))
    m = max(math.ceil(math.sqrt(k_cell)), 1)
    nh, nw = rows * m, cols * m
    th, tw = math.ceil(H / nh), math.ceil(W / nw)
    padded = torch.zeros((th * nh, tw * nw), dtype=score.dtype,
                         device=score.device)
    padded[:H, :W] = score
    tiles = padded.reshape(nh, th, nw, tw).permute(0, 2, 1, 3) \
        .reshape(nh * nw, th * tw)
    best = tiles.max(dim=1).values
    arg = torch.argmax((tiles == best[:, None]).to(torch.int8), dim=1)
    tile = torch.arange(nh * nw, device=score.device)
    y = (tile // nw) * th + arg // tw
    x = (tile % nw) * tw + arg % tw
    k = min(budget, best.shape[0])
    order = torch.sort(best, descending=True, stable=True).indices[:k]
    resp = best[order]
    valid = resp > 0
    uv = torch.stack([x[order], y[order]], dim=-1).to(score.dtype)
    uv = torch.where(valid[:, None], uv, torch.full_like(uv, -1.0))
    if k < budget:
        pad = budget - k
        uv = torch.cat([uv, torch.full((pad, 2), -1.0, dtype=uv.dtype,
                                       device=uv.device)])
        resp = torch.cat([resp, torch.zeros(pad, dtype=resp.dtype,
                                            device=resp.device)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                              device=valid.device)])
    return uv, torch.where(valid, resp, torch.zeros_like(resp)), valid


def refine(raw, uv):
    """Sub-pixel offset of each candidate: the vertex of the parabola
    through the raw score and its two neighbours along u and along v
    (none where the curvature is under 1e-6), clamped to ±0.5 px."""
    H, W = raw.shape
    u = torch.clamp(uv[:, 0].long(), 1, W - 2)
    v = torch.clamp(uv[:, 1].long(), 1, H - 2)
    c = raw[v, u]
    l, r = raw[v, u - 1], raw[v, u + 1]
    up, dn = raw[v - 1, u], raw[v + 1, u]
    dxx = r - 2 * c + l
    dyy = dn - 2 * c + up
    zero = torch.zeros_like(c)
    ou = torch.where(torch.abs(dxx) > 1e-6, -(0.5 * (r - l)) / dxx, zero)
    ov = torch.where(torch.abs(dyy) > 1e-6, -(0.5 * (dn - up)) / dyy, zero)
    return uv + torch.stack([torch.clamp(ou, -0.5, 0.5),
                             torch.clamp(ov, -0.5, 0.5)], dim=-1)


def _bilinear_taps(xs, ys):
    """(P², K) bilinear sampling weights of K patch-frame points."""
    K = xs.shape[0]
    c = (PATCH - 1) / 2.0
    Wt = np.zeros((PATCH * PATCH, K), np.float32)
    px = np.clip(xs + c, 0.0, PATCH - 1.001)
    py = np.clip(ys + c, 0.0, PATCH - 1.001)
    x0 = np.floor(px).astype(np.int64)
    y0 = np.floor(py).astype(np.int64)
    dx, dy = px - x0, py - y0
    for k in range(K):
        b = y0[k] * PATCH + x0[k]
        Wt[b, k] += (1 - dx[k]) * (1 - dy[k])
        Wt[b + 1, k] += dx[k] * (1 - dy[k])
        Wt[b + PATCH, k] += (1 - dx[k]) * dy[k]
        Wt[b + PATCH + 1, k] += dx[k] * dy[k]
    return Wt


def descriptor_bank():
    """(P², 24·256 + 2) float32: for each of 24 bins the 256 tests I(q) −
    I(p) of the seeded Gaussian point pairs (σ 5 px, clipped at 12)
    rotated by the bin's angle and sampled bilinearly, composed with a
    5×5 box blur whose edge taps are clamped; then the two
    intensity-centroid moments (x, y) over the radius-15 disc."""
    rng = np.random.default_rng(PATTERN_SEED)
    pat = np.clip(rng.normal(0.0, TEST_SIGMA, size=(DESC_BITS, 4))
                  .astype(np.float32), -TEST_CLIP, TEST_CLIP)
    tests = np.zeros((PATCH * PATCH, N_BINS * DESC_BITS), np.float32)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        c, s = np.cos(th), np.sin(th)
        px, py = c * pat[:, 0] - s * pat[:, 1], s * pat[:, 0] + c * pat[:, 1]
        qx, qy = c * pat[:, 2] - s * pat[:, 3], s * pat[:, 2] + c * pat[:, 3]
        tests[:, b * DESC_BITS:(b + 1) * DESC_BITS] = \
            _bilinear_taps(qx, qy) - _bilinear_taps(px, py)
    w = 2 * BLUR_RADIUS + 1
    B1 = np.zeros((PATCH, PATCH), np.float32)
    for i in range(PATCH):
        for d in range(-BLUR_RADIUS, BLUR_RADIUS + 1):
            B1[i, min(max(i + d, 0), PATCH - 1)] += 1.0 / w
    blurred = np.kron(B1, B1).T @ tests
    yy, xx = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
    c = (PATCH - 1) / 2.0
    disc = ((xx - c) ** 2 + (yy - c) ** 2 <= DISC_RADIUS ** 2)
    moments = np.stack([(disc * (xx - c)).reshape(-1),
                        (disc * (yy - c)).reshape(-1)], axis=1)
    return np.concatenate([blurred, moments.astype(np.float32)], axis=1)


def patches(img, uv):
    """The 32×32 window at each rounded keypoint, shifted into the image."""
    H, W = img.shape
    u0 = torch.clamp(torch.round(uv[:, 0]).long() - PATCH // 2, 0, W - PATCH)
    v0 = torch.clamp(torch.round(uv[:, 1]).long() - PATCH // 2, 0, H - PATCH)
    r = torch.arange(PATCH, device=img.device)
    return img[(v0[:, None] + r)[:, :, None], (u0[:, None] + r)[:, None, :]]


def describe(patch, bank, desc_dtype):
    """(N, P, P) patches → (test results (N, 256) bool, angles (N,)): the
    product with the bank in ``desc_dtype`` (bf16 as configured: inputs
    and the product's result rounded to it), the angle from the moments,
    the tests of the angle's nearest bin."""
    N = patch.shape[0]
    flat = patch.reshape(N, PATCH * PATCH).float()
    if desc_dtype in (torch.bfloat16, torch.float16, torch.float32):
        out = (flat.to(desc_dtype) @ bank.to(desc_dtype)).float()
    else:        # 8-bit: inputs rounded to it, the product in float32
        out = flat.to(desc_dtype).float() @ bank.to(desc_dtype).float()
    ang = torch.atan2(out[:, -1], out[:, -2])
    tau = torch.remainder(ang, 2.0 * math.pi)
    bins = torch.round(tau / (2.0 * math.pi / N_BINS)).long() % N_BINS
    tests = out[:, :N_BINS * DESC_BITS].reshape(N, N_BINS, DESC_BITS)
    return tests[torch.arange(N, device=out.device), bins] > 0, ang


def undistort(cam, uv, iters=8):
    """Ideal pixels of distorted ones: the radial-tangential model inverted
    by ``iters`` fixed-point steps on normalised coordinates."""
    xd = (uv[:, 0] - cam["cu"]) / cam["fu"]
    yd = (uv[:, 1] - cam["cv"]) / cam["fv"]
    x, y = xd, yd
    k1, k2, k3, p1, p2 = (cam[k] for k in ("k1", "k2", "k3", "p1", "p2"))
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = p1 * 2.0 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p2 * 2.0 * x * y + p1 * (r2 + 2.0 * y * y)
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x * cam["fu"] + cam["cu"], y * cam["fv"] + cam["cv"]],
                       dim=-1)


def keypoints(gray_u8, depth_u16, det, cam, dtype=torch.float32,
              desc_dtype=torch.bfloat16):
    """The reference front end of one frame. ``gray_u8`` (H, W) uint8,
    ``depth_u16`` (H, W) int32 counts; ``det`` and ``cam`` dicts of the
    detector and camera settings. Returns ``Keypoints``."""
    dev = gray_u8.device
    gray = (gray_u8.to(torch.float32) / 255.0).to(dtype)
    H, W = gray.shape
    levels = det["n_pyramid_levels"]
    shapes = pyramid_shapes(H, W, levels, det["scale_factor"])
    budgets = level_budgets(det["max_features"], levels)
    bank = torch.as_tensor(descriptor_bank(), device=dev)
    uvs, octs, resps, valids, descs = [], [], [], [], []
    for lvl, ((h, w), budget) in enumerate(zip(shapes, budgets)):
        if lvl == 0:
            img = gray
        else:
            wy = resize_weights(H, h, dtype, dev)
            wx = resize_weights(W, w, dtype, dev)
            img = (wy.T @ gray) @ wx
        raw = fast_score(img * 255.0, det["fast_threshold"])
        uv, resp, valid = grid_cap(suppress(raw, det["nms_radius"]),
                                   det["grid_rows"], det["grid_cols"], budget)
        uv = torch.where(valid[:, None], refine(raw, uv), uv)
        scale = det["scale_factor"] ** lvl
        b = float(max(det["border"] // max(int(scale), 1), PATCH // 2 + 1))
        valid = valid & (uv[:, 0] >= b) & (uv[:, 0] <= w - 1 - b) \
            & (uv[:, 1] >= b) & (uv[:, 1] <= h - 1 - b)
        bits, _ = describe(patches(img, uv), bank, desc_dtype)
        uvs.append(uv.float() * scale)
        octs.append(torch.full((budget,), lvl, dtype=torch.int64, device=dev))
        resps.append(torch.where(valid, resp, torch.zeros_like(resp)).float())
        valids.append(valid)
        descs.append(bits & valid[:, None])
    uv0 = torch.cat(uvs)
    valid = torch.cat(valids)
    depth = depth_u16.to(torch.float32) / cam["depth_image_scale"]
    u = torch.clamp(torch.round(uv0[:, 0]).long(), 0, W - 1)
    v = torch.clamp(torch.round(uv0[:, 1]).long(), 0, H - 1)
    z = depth[v, u].to(dtype)
    und = undistort(cam, uv0.to(dtype))
    xy = torch.stack([(und[:, 0] - cam["cu"]) / cam["fu"],
                      (und[:, 1] - cam["cv"]) / cam["fv"]], dim=-1)
    xyz = torch.cat([xy * z[:, None], z[:, None]], dim=-1).float()
    has_depth = valid & (z > cam["min_depth"]) & (z < cam["max_depth"])
    return Keypoints(uv=uv0, octave=torch.cat(octs),
                     response=torch.cat(resps), valid=valid,
                     desc=torch.cat(descs), xyz=xyz, has_depth=has_depth)
