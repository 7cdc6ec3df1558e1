"""Batched pyramidal Lucas-Kanade optical flow (KLT).

Port of ``putslam_tpu/ops/klt.py`` (``build_pyramid``, ``track``,
``refine_patch_alignment``, ``refine_patch_alignment_affine``). All N tracks advance together: each
Gauss-Newton iteration is one batched (N, W²) bilinear sample and N 2×2
solves. Every level runs all ``max_iter`` iterations; a track whose step
falls under ``eps`` stops moving (the masked freeze of the JAX package's
``fori_loop``), there is no early exit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from putslam_tpu_torch.config import TrackerConfig


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Halving 2×2 average-pool pyramid. The four pixels are summed as
    (top pair) + (bottom pair), the order XLA's CPU reduction takes, so
    every level equals the JAX package's bit for bit."""
    pyr = [img]
    for _ in range(levels - 1):
        im = pyr[-1]
        H2, W2 = (im.shape[0] // 2) * 2, (im.shape[1] // 2) * 2
        im = im[:H2, :W2]
        top = im[0::2, 0::2] + im[0::2, 1::2]
        bottom = im[1::2, 0::2] + im[1::2, 1::2]
        pyr.append((top + bottom) / 4.0)
    return pyr


def _grad(img):
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy = torch.zeros_like(img)
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def _sample_patches(img, pts, offs):
    """Bilinear patches: img (H, W), pts (N, 2), offs (W2, 2) → (N, W2).
    Coordinates clip to [0, W − 1.001] so the +1 neighbour is in range."""
    H, W = img.shape
    u = torch.clamp(pts[:, None, 0] + offs[None, :, 0], 0.0, W - 1.001)
    v = torch.clamp(pts[:, None, 1] + offs[None, :, 1], 0.0, H - 1.001)
    x0 = torch.floor(u).long()
    y0 = torch.floor(v).long()
    du = u - x0
    dv = v - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


class TrackResult(NamedTuple):
    pts: torch.Tensor     # (N, 2) tracked positions in the new frame
    err: torch.Tensor     # (N,) mean |ΔI| over the window, 0..255 scale
    valid: torch.Tensor   # (N,) bool — in-image and below the error gate


def _window_offsets(win_size: int, like: torch.Tensor) -> torch.Tensor:
    r = win_size // 2
    a = torch.arange(-r, r + 1, dtype=torch.float32, device=like.device)
    oy, ox = torch.meshgrid(a, a, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)   # (W2, 2)


def track(tcfg: TrackerConfig, prev: torch.Tensor, curr: torch.Tensor,
          pts: torch.Tensor, valid: torch.Tensor,
          init_flow: Optional[torch.Tensor] = None) -> TrackResult:
    """Track ``pts`` (N, 2, pixels in ``prev``) into ``curr`` by
    inverse-compositional LK, coarse to fine."""
    r = tcfg.win_size // 2
    offs = _window_offsets(tcfg.win_size, pts)
    prev_pyr = build_pyramid(prev, tcfg.max_levels)
    curr_pyr = build_pyramid(curr, tcfg.max_levels)
    flow = torch.zeros_like(pts) if init_flow is None else init_flow
    for lvl in reversed(range(tcfg.max_levels)):
        s = 2.0 ** lvl
        p_l = pts / s
        img_p, img_c = prev_pyr[lvl], curr_pyr[lvl]
        gx, gy = _grad(img_p)
        T = _sample_patches(img_p, p_l, offs)
        Tx = _sample_patches(gx, p_l, offs)
        Ty = _sample_patches(gy, p_l, offs)
        a = torch.sum(Tx * Tx, dim=-1)
        b = torch.sum(Tx * Ty, dim=-1)
        c = torch.sum(Ty * Ty, dim=-1)
        det = a * c - b * b
        inv_ok = det > 1e-6
        det_safe = torch.where(inv_ok, det, torch.ones_like(det))
        for _ in range(tcfg.max_iter):
            diff = _sample_patches(img_c, p_l + flow / s, offs) - T
            bx = torch.sum(Tx * diff, dim=-1)
            by = torch.sum(Ty * diff, dim=-1)
            step = torch.stack([(c * bx - b * by) / det_safe,
                                (a * by - b * bx) / det_safe], dim=-1) * s
            step = torch.where(inv_ok[:, None], step, torch.zeros_like(step))
            small = torch.linalg.norm(step, dim=-1) < tcfg.eps * s
            flow = flow - torch.where(small[:, None], torch.zeros_like(step),
                                      step)
    new_pts = pts + flow
    I0 = _sample_patches(curr_pyr[0], new_pts, offs)
    T0 = _sample_patches(prev_pyr[0], pts, offs)
    err = torch.mean(torch.abs(I0 - T0), dim=-1) * 255.0
    H, W = prev.shape
    inb = ((new_pts[:, 0] >= r) & (new_pts[:, 0] <= W - 1 - r)
           & (new_pts[:, 1] >= r) & (new_pts[:, 1] <= H - 1 - r))
    return TrackResult(new_pts, err, valid & inb & (err < tcfg.error_threshold))


def refine_patch_alignment(tcfg: TrackerConfig, ref_img, tgt_img, ref_pts,
                           tgt_pts_init, valid) -> TrackResult:
    """Single-level Gauss-Newton photometric polish of initial guesses
    ``tgt_pts_init`` in ``tgt_img`` for ``ref_pts`` in ``ref_img``."""
    one = TrackerConfig(win_size=tcfg.win_size, max_levels=1,
                        max_iter=tcfg.max_iter, eps=tcfg.eps,
                        error_threshold=tcfg.error_threshold)
    return track(one, ref_img, tgt_img, ref_pts, valid,
                 init_flow=tgt_pts_init - ref_pts)


def _sample_warped(img, ref_pts, M, offs):
    """Bilinear samples of ``img`` at the offsets ``offs`` (W2, 2) warped by
    the 2×3 matrices ``M`` (N, 2, 3) around ``ref_pts`` (N, 2) → (N, W2).
    The clip bounds and the floor → gather order are the JAX package's
    (``putslam_tpu/ops/klt.py:199-211``). A warp that diverged to NaN
    samples NaN, as in the JAX package (whose gather clamps the index of a
    NaN coordinate); its gather index is sent to 0 here, where torch would
    index out of bounds."""
    w_off = torch.einsum("nab,wb->nwa", M[:, :, :2], offs) + M[:, None, :, 2]
    q = ref_pts[:, None, :] + w_off                               # (N, W2, 2)
    H, W = img.shape
    u = torch.clamp(q[..., 0], 0.0, W - 1.001)
    v = torch.clamp(q[..., 1], 0.0, H - 1.001)
    xf = torch.floor(u)
    yf = torch.floor(v)
    x0 = torch.nan_to_num(xf, nan=0.0).long()
    y0 = torch.nan_to_num(yf, nan=0.0).long()
    du, dv = u - xf, v - yf
    return (img[y0, x0] * (1 - du) * (1 - dv)
            + img[y0, x0 + 1] * du * (1 - dv)
            + img[y0 + 1, x0] * (1 - du) * dv
            + img[y0 + 1, x0 + 1] * du * dv)


def refine_patch_alignment_affine(tcfg: TrackerConfig, ref_img, tgt_img,
                                  ref_pts, tgt_pts_init,
                                  valid) -> TrackResult:
    """Affine-warped inverse-compositional patch alignment
    (``putslam_tpu/ops/klt.py:157-245``; the warping variant of the
    reference's MatchingOnPatches, MatchingOnPatches.h:37-66).

    Warp W(x; p) = (I + A)·x + t around the template point, p = (a₁..a₄,
    tx, ty). The template's steepest-descent images and its (N, 6, 6)
    Hessian (ridge 1e-4) are built once; each of the ``max_iter``
    iterations is one batched bilinear sample, a batched solve, and the
    composition with the inverted incremental warp (Baker-Matthews IC). A
    point whose translation step ``‖dp[4:6]‖`` falls under ``eps`` keeps
    its warp for that iteration (a masked select, no host decision), so
    all iterations run with no synchronisation."""
    r = tcfg.win_size // 2
    offs = _window_offsets(tcfg.win_size, ref_pts)                # (W2, 2)
    N = ref_pts.shape[0]
    dt, dev = ref_img.dtype, ref_img.device

    gx, gy = _grad(ref_img)
    T = _sample_patches(ref_img, ref_pts, offs)                   # (N, W2)
    Tx = _sample_patches(gx, ref_pts, offs)
    Ty = _sample_patches(gy, ref_pts, offs)
    # steepest-descent images: (N, W2, 6)
    sd = torch.stack([Tx * offs[None, :, 0], Tx * offs[None, :, 1],
                      Ty * offs[None, :, 0], Ty * offs[None, :, 1],
                      Tx, Ty], dim=-1)
    Hm = torch.einsum("nwa,nwb->nab", sd, sd) \
        + 1e-4 * torch.eye(6, dtype=dt, device=dev)              # (N, 6, 6)

    # the warps as 2x3 matrices [I+A | t], t started from the guess
    M = torch.zeros((N, 2, 3), dtype=dt, device=dev)
    M[:, 0, 0] = 1.0
    M[:, 1, 1] = 1.0
    M[:, :, 2] = tgt_pts_init - ref_pts
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=dt,
                          device=dev).expand(N, 1, 3)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    for _ in range(tcfg.max_iter):
        I = _sample_warped(tgt_img, ref_pts, M, offs)
        b = torch.einsum("nwa,nw->na", sd, I - T)                 # (N, 6)
        # the _ex forms: no error check, so no host synchronisation
        dp = torch.linalg.solve_ex(Hm, b[..., None])[0][..., 0]   # (N, 6)
        # compose M ← M ∘ inv(W(dp)) in homogeneous 3x3 form
        Md = eye3.repeat(N, 1, 1)
        Md[:, 0, 0] += dp[:, 0]
        Md[:, 0, 1] += dp[:, 1]
        Md[:, 1, 0] += dp[:, 2]
        Md[:, 1, 1] += dp[:, 3]
        Md[:, 0, 2] += dp[:, 4]
        Md[:, 1, 2] += dp[:, 5]
        M3 = torch.cat([M, bottom], dim=1)
        Mn = torch.einsum("nab,nbc->nac", M3,
                          torch.linalg.inv_ex(Md)[0])[:, :2, :]
        small = torch.linalg.norm(dp[:, 4:6], dim=-1) < tcfg.eps
        M = torch.where(small[:, None, None], M, Mn)

    new_pts = ref_pts + M[:, :, 2]
    # photometric error under the final warp
    I = _sample_warped(tgt_img, ref_pts, M, offs)
    err = torch.mean(torch.abs(I - T), dim=-1) * 255.0
    H, W = tgt_img.shape
    inb = ((new_pts[:, 0] >= r) & (new_pts[:, 0] <= W - 1 - r)
           & (new_pts[:, 1] >= r) & (new_pts[:, 1] <= H - 1 - r))
    return TrackResult(new_pts, err, valid & inb & (err < tcfg.error_threshold))
