"""Inputs of guided map matching for the tests of ``ops/guided_match.py``
(the CPU's ``test_torch_guided.py``, the card's
``test_torch_guided_cuda.py``): a random map and frame at the tiny or the
fr1 widths, from a seed, with numpy alone (no JAX).

The landmarks lie near features (so the sphere gate lets a few through)
with their descriptors a number of bit flips away from the feature's, and
the frame holds what the real ones hold and what they may: duplicate
features (ties), features without depth, invalid feature rows (zero
descriptors), invalid landmarks, unused slots (zeros, as ``init_map`` makes
them, or stale bits), landmarks far from every feature (all gated out),
octaves outside the window, landmarks whose only candidate lies at the
Hamming gate − 1, at it and + 1, and points at the sphere's radius − 1 ulp,
at it and + 1 ulp."""

from typing import NamedTuple

import numpy as np
import torch

from putslam_tpu_torch.ops import guided_match as gops

WIDTHS = {"tiny": (512, 4, 128), "fr1": (8192, 4, 512)}   # L, D, N
RADIUS = 0.12            # the fr1 config's sphere radius, metres
MAX_HAMMING = 64
RATIO = 0.55
WINDOW = 1
N_SPECIAL = 24           # landmarks 0..23 are the hand-placed ones


class Landmarks(NamedTuple):
    lm_desc: torch.Tensor        # (L, D, 256) int8
    lm_slot_used: torch.Tensor   # (L, D) bool
    lm_valid: torch.Tensor       # (L,) bool
    lm_octave: torch.Tensor      # (L,) int32


class Frame(NamedTuple):
    xyz: torch.Tensor            # (N, 3) float32
    has_depth: torch.Tensor      # (N,) bool
    octave: torch.Tensor         # (N,) int32
    desc: torch.Tensor           # (N, 256) int8


def gates(scale: float = 1.0, slack: float = 0.0,
          acceptance: str = "hamming") -> gops.Gates:
    return gops.Gates(RADIUS * scale, WINDOW, MAX_HAMMING + slack,
                      acceptance, RATIO)


def _flip(rng, rows: np.ndarray, n_flips: np.ndarray) -> np.ndarray:
    """``rows`` (..., 256) ±1 with ``n_flips`` (...) of each row's bits
    flipped, at random places."""
    r = rng.random(rows.shape)
    cut = np.take_along_axis(np.sort(r, axis=-1),
                             np.minimum(n_flips, 255)[..., None], axis=-1)
    flip = (r < cut) & (n_flips[..., None] > 0)
    return np.where(flip, -rows, rows).astype(np.int8)


def make(width: str, seed: int, scale: float = 1.0, slack: float = 0.0,
         all_valid: bool = False, views: int = 0, device="cpu"):
    """(lm_cam, Landmarks, Frame) at ``width``, with ``views`` descriptor
    slots a landmark if given; the radius ± 1 ulp points are placed for
    ``gates(scale)``, the Hamming gate ± 1 landmarks for ``slack``;
    ``all_valid`` makes every landmark valid with every slot used."""
    L, D, N = WIDTHS[width]
    D = views or D
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    xyz[:, 2] += 2.0
    has_depth = rng.random(N) < 0.9
    octave = rng.integers(0, 4, N).astype(np.int32)
    desc = rng.choice(np.array([-1, 1], np.int8), (N, 256))
    # duplicates (ties between features), then invalid rows
    dup = rng.choice(N // 2, N // 16, replace=False) * 2
    for a in (xyz, has_depth, octave, desc):
        a[dup + 1] = a[dup]
    dead = rng.random(N) < 0.05
    dead[dup] = dead[dup + 1] = False
    has_depth[dead] = False
    desc[dead] = 0
    xyz[dead] = 0.0

    pick = rng.integers(0, N, L)
    lm_cam = (xyz[pick] + rng.normal(0.0, 0.05 * scale, (L, 3))).astype(
        np.float32)
    lm_desc = _flip(rng, np.repeat(desc[pick][:, None], D, axis=1),
                    rng.integers(0, 110, (L, D)))
    lm_desc[~desc[pick].any(-1)] = rng.choice(
        np.array([-1, 1], np.int8), (256,))
    used = rng.random((L, D)) < 0.6
    used[:, 0] |= rng.random(L) < 0.9
    stale = rng.random((L, D)) < 0.5
    lm_desc[~used & ~stale] = 0
    valid = rng.random(L) < 0.85
    lm_oct = np.clip(octave[pick] + rng.integers(-2, 3, L), 0, 3).astype(
        np.int32)
    far = rng.random(L) < 0.05
    lm_cam[far] = 50.0
    if all_valid:
        valid[:] = True
        used[:] = True

    # hand-placed landmarks on features kept apart from the rest
    lone = np.arange(N - 12, N)
    xyz[lone] = np.stack([np.zeros(12), np.linspace(-0.9, 0.9, 12),
                          np.full(12, -30.0)], axis=1)
    has_depth[lone] = True
    octave[lone] = 1
    desc[lone] = rng.choice(np.array([-1, 1], np.int8), (12, 256))
    k = 0
    for delta in (-1, 0, 1):                 # the Hamming gate ± 1, twice
        for _ in range(2):
            f = lone[k % 12]
            lm_cam[k] = xyz[f]
            lm_desc[k] = _flip(rng, np.repeat(desc[f][None], D, axis=0),
                               np.full(D, 200))
            lm_desc[k, 0] = _flip(rng, desc[f],
                                  np.array(int(MAX_HAMMING + slack) + delta))
            used[k], valid[k], lm_oct[k] = True, True, 1
            k += 1
    r = np.float32(RADIUS * scale)
    for way in (-np.inf, None, np.inf):      # the radius ± 1 ulp, twice
        for _ in range(2):
            f = lone[k % 12]
            at = r if way is None else np.nextafter(r, np.float32(way))
            lm_cam[k] = xyz[f] + np.array([at, 0.0, 0.0], np.float32)
            lm_desc[k] = desc[f]
            used[k], valid[k], lm_oct[k] = True, True, 1
            k += 1
    for _ in range(N_SPECIAL - k):           # octave just outside the window
        f = lone[k % 12]
        lm_cam[k] = xyz[f]
        lm_desc[k] = desc[f]
        used[k], valid[k], lm_oct[k] = True, True, 1 + WINDOW + 1
        k += 1

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return (t(lm_cam), Landmarks(t(lm_desc), t(used), t(valid), t(lm_oct)),
            Frame(t(xyz), t(has_depth), t(octave), t(desc)))
