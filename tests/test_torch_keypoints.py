"""The detector's keypoint chain (``ops/keypoints.py``) on the CPU.

The wrapper's contract: a CPU tensor takes the plain version and never
the kernel; a wrong dtype, device or shape raises ``ValueError``. The
plain version is the old chain bit for bit: ``detect_and_describe`` as it
was before the chain became one call is kept here (``old_detect``) and
every ``Features`` field is compared on rendered fr1 frames (both
descriptor kinds) and on the edge cases of ``_keypoints_cases.py`` (no
corner, a few, tied scores, corners in the border, depth at 0, at the gate
and beyond, the tiny config). ``grid_policy="exact"`` keeps its ATen chain:
``chain`` hands it to the plain version and never to the kernel. The
kernel's selection (a warp a subtile's first maximum, then each
candidate's rank by count) is written out in numpy and equals
``fast.grid_topk``'s stable sort on every level of those frames. The
layout at fr1, the float32 camera numbers and the bfloat16 patch
matrix. The card's own tests are ``test_torch_keypoints_cuda.py``."""

import dataclasses

import _torch_port  # noqa: F401  (one thread a worker)
import numpy as np
import pytest
import torch
from _keypoints_cases import CASES, chain_inputs, make

from putslam_tpu_torch.config import tum_fr1_config
from putslam_tpu_torch.convert import brief_bank
from putslam_tpu_torch.frontend import detector
from putslam_tpu_torch.geometry import camera as camera_mod
from putslam_tpu_torch.ops import brief, fast, fast_cuda, keypoints
from putslam_tpu_torch.utils import cuda_lib


def old_detect(cfg, gray, depth):
    """``detect_and_describe`` before the keypoint chain was one call
    (the parent's code, verbatim but for the descriptor product, which
    ``describe_patches`` ran on the float patches)."""
    det = cfg.detector
    cam = cfg.camera
    budgets = detector._level_budgets(cfg)
    dev = gray.device
    shapes = detector._pyramid_shapes(cfg)
    levels = [gray.contiguous()] + [detector.resize(gray, s).contiguous()
                                    for s in shapes[1:]]
    maps = fast_cuda.fast_score_nms_levels(levels, det.fast_threshold,
                                           det.nms_radius)

    all_uv0, all_resp, all_oct, all_patch, all_valid = [], [], [], [], []
    for lvl, (img, (Hl, Wl)) in enumerate(zip(levels, shapes)):
        scale = det.scale_factor ** lvl
        Nl = budgets[lvl]
        uv_l, resp, valid = fast.detect(
            img, det.fast_threshold, det.nms_radius, det.grid_rows,
            det.grid_cols, Nl, grid_policy=det.grid_policy, maps=maps[lvl])
        b = float(max(det.border // max(int(scale), 1), brief.PATCH // 2 + 1))
        inb = ((uv_l[:, 0] >= b) & (uv_l[:, 0] <= Wl - 1 - b)
               & (uv_l[:, 1] >= b) & (uv_l[:, 1] <= Hl - 1 - b))
        valid = valid & inb
        all_patch.append(brief.extract_patches(img, uv_l))
        all_uv0.append(uv_l * scale)
        all_resp.append(torch.where(valid, resp, torch.zeros_like(resp)))
        all_oct.append(torch.full((Nl,), lvl, dtype=torch.int32, device=dev))
        all_valid.append(valid)

    uv0 = torch.cat(all_uv0)
    resp = torch.cat(all_resp)
    octv = torch.cat(all_oct)
    valid = torch.cat(all_valid)
    patches = torch.cat(all_patch)
    N = patches.shape[0]
    bank = brief_bank(patches.device, det.descriptor)
    flat = patches.reshape(N, brief.PATCH * brief.PATCH).to(torch.bfloat16)
    out = flat @ bank
    ang = torch.atan2(out[:, -1].float(), out[:, -2].float())
    desc = brief._select_bits(out[:, :brief.N_BINS * brief.DESC_BITS], ang)
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))

    z = camera_mod.sample_depth(depth, uv0)
    uv_und = camera_mod.undistort_pixels(cam, uv0)
    xyz = camera_mod.unproject(cam, uv_und, z)
    has_depth = valid & camera_mod.depth_valid_mask(cam, z)
    v2 = valid[:, None]
    return detector.Features(
        uv=torch.where(v2, uv0, torch.full_like(uv0, -1.0)),
        uv_undist=torch.where(v2, uv_und, torch.full_like(uv_und, -1.0)),
        xyz=torch.where(has_depth[:, None], xyz, torch.zeros_like(xyz)),
        response=torch.where(valid, resp, torch.zeros_like(resp)),
        octave=octv,
        angle=ang,
        desc=desc,
        valid=valid,
        has_depth=has_depth,
    )


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_features_equal(got, ref):
    for name in detector.Features._fields:
        x, y = getattr(got, name), getattr(ref, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(_bits(x), _bits(y)), name


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return request.param, make(request.param)


def test_plain_path_equals_the_old_chain(case):
    name, (cfg, g, d) = case
    feat = detector.detect_and_describe(cfg, g, d)
    assert_features_equal(feat, old_detect(cfg, g, d))
    if name.startswith("fr1"):
        assert int(feat.valid.sum()) > 200
    if name == "no_corner":
        assert not feat.valid.any()
    if name == "depth_edges":
        assert 0 < int(feat.has_depth.sum()) < int(feat.valid.sum())


@pytest.mark.parametrize("name", ["fr1_0", "tied", "tiny"])
def test_exact_policy_keeps_its_aten_chain(name, monkeypatch):
    cfg, g, d = make(name)
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                   grid_policy="exact"))

    def never(*a, **k):
        raise AssertionError("the exact cap reached the kernel")

    calls = []
    plain = keypoints.plain_chain

    def spy(det, *args):
        calls.append(det.grid_policy)
        return plain(det, *args)

    monkeypatch.setattr(keypoints, "_launch", never)
    monkeypatch.setattr(keypoints, "plain_chain", spy)
    assert_features_equal(detector.detect_and_describe(cfg, g, d),
                          old_detect(cfg, g, d))
    assert calls == ["exact"]


def test_subtile_policy_makes_one_call(monkeypatch):
    cfg, g, d = make("tiny")
    calls = []
    real = keypoints.chain

    def spy(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(keypoints, "chain", spy)
    detector.detect_and_describe(cfg, g, d)
    assert calls == [detector._pyramid_shapes(cfg)]


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    args = chain_inputs(*make("fr1_1"))

    def never(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(keypoints, "_launch", never)
    monkeypatch.setattr(cuda_lib.Library, "library", never)
    got = keypoints.chain(*args)
    ref = keypoints.plain_chain(*args)
    for name, x, y in zip(keypoints.Chain._fields, got, ref):
        assert torch.equal(x, y), name
    assert got.patches.dtype == torch.bfloat16
    assert tuple(got.patches.shape) == (512, brief.PATCH * brief.PATCH)


def _wrong(name, det, cam, shapes, budgets, levels, maps, depth):
    a = dict(det=det, cam=cam, shapes=shapes, budgets=budgets,
             levels=list(levels), maps=list(maps), depth=depth)
    if name == "float64 depth":
        a["depth"] = depth.double()
    elif name == "depth on another device":
        a["depth"] = torch.empty(depth.shape, device="meta")
    elif name == "3-D depth":
        a["depth"] = depth[None]
    elif name == "float64 level":
        a["levels"][1] = levels[1].double()
    elif name == "level of another shape":
        a["levels"][1] = levels[1][1:]
    elif name == "map of another shape":
        a["maps"][0] = (maps[0][0], maps[0][1][:, 1:])
    elif name == "map on another device":
        a["maps"][-1] = (torch.empty(maps[-1][0].shape, device="meta"),
                         maps[-1][1])
    elif name == "a level below a window":
        a["shapes"] = [(31, 40)] + list(shapes[1:])
        a["levels"][0] = levels[0][:31, :40]
        a["maps"][0] = tuple(m[:31, :40] for m in maps[0])
    elif name == "one map pair short":
        a["maps"] = a["maps"][:-1]
    elif name == "no level":
        a.update(levels=[], maps=[], shapes=[], budgets=[])
    return a


WRONG = ("float64 depth", "depth on another device", "3-D depth",
         "float64 level", "level of another shape", "map of another shape",
         "map on another device", "a level below a window",
         "one map pair short", "no level")


@pytest.mark.parametrize("wrong", WRONG)
def test_wrong_input_raises(wrong):
    args = chain_inputs(*make("tiny"))
    with pytest.raises(ValueError):
        keypoints.chain(**_wrong(wrong, *args))


# ---- the kernel's selection, written out --------------------------------


def _lanes_first_max(vals):
    """``tiles_kernel``'s walk of one subtile's values (row-major): lane l
    keeps the first maximum of the values l, l + 32, ...; then the shuffle
    reduction (offsets 16 to 1) keeps the larger value, the lower index on
    a tie. Returns (best, index)."""
    n = len(vals)
    best = np.full(32, -np.inf, np.float32)
    arg = np.full(32, n, np.int64)
    for f in range(n):
        lane = f % 32
        if vals[f] > best[lane]:
            best[lane], arg[lane] = vals[f], f
    off = 16
    while off:
        ob = np.concatenate([best[off:], best[32 - off:]])
        oa = np.concatenate([arg[off:], arg[32 - off:]])
        take = (ob > best) | ((ob == best) & (oa < arg))
        best, arg = np.where(take, ob, best), np.where(take, oa, arg)
        off //= 2
    return best[0], arg[0]


def kernel_cap(nms: np.ndarray, nsh, nsw, sub_h, sub_w, K):
    """The kernel's cap of one level: every subtile's candidate
    (``tiles_kernel``), then each candidate's slot = the candidates before
    it in a stable descending order, counted (``select_kernel``). Returns
    ``grid_topk``'s (uv before the refine, response, valid)."""
    H, W = nms.shape
    padded = np.zeros((nsh * sub_h, nsw * sub_w), np.float32)
    padded[:H, :W] = nms
    n = nsh * nsw
    score = np.empty(n, np.float32)
    arg = np.empty(n, np.int64)
    for c in range(n):
        ty, tx = divmod(c, nsw)
        tile = padded[ty * sub_h:(ty + 1) * sub_h, tx * sub_w:(tx + 1) * sub_w]
        score[c], arg[c] = _lanes_first_max(tile.reshape(-1))
    uv = np.full((K, 2), -1.0, np.float32)
    resp = np.zeros(K, np.float32)
    valid = np.zeros(K, bool)
    idx = np.arange(n)
    for c in range(n):
        slot = int(np.sum(score > score[c])
                   + np.sum((score == score[c]) & (idx < c)))
        if slot >= K:
            continue
        ty, tx = divmod(c, nsw)
        if score[c] > 0:
            uv[slot] = (tx * sub_w + arg[c] % sub_w,
                        ty * sub_h + arg[c] // sub_w)
            resp[slot], valid[slot] = score[c], True
    return uv, resp, valid


@pytest.mark.parametrize("name", CASES)
def test_kernel_selection_is_the_stable_sort(name):
    det, _, shapes, budgets, _, maps, _ = chain_inputs(*make(name))
    for (H, W), K, (_, nms) in zip(shapes, budgets, maps):
        grid = fast.subtile_grid(H, W, det.grid_rows, det.grid_cols, K)
        uv, resp, valid = fast.grid_topk(nms, det.grid_rows, det.grid_cols,
                                         K)
        k_uv, k_resp, k_valid = kernel_cap(nms.numpy(), *grid, K)
        np.testing.assert_array_equal(k_valid, valid.numpy())
        np.testing.assert_array_equal(k_uv, uv.numpy())
        np.testing.assert_array_equal(k_resp.view(np.int32),
                                      resp.numpy().view(np.int32))
    if name == "tied":   # equal scores do meet among the kept keypoints
        r = resp.numpy()
        assert len(np.unique(r[r > 0])) < np.count_nonzero(r)


def test_plan_at_fr1():
    cfg = tum_fr1_config()
    det = cfg.detector
    shapes = tuple(detector._pyramid_shapes(cfg))
    budgets = tuple(detector._level_budgets(cfg))
    p = keypoints.plan(det.grid_rows, det.grid_cols, det.scale_factor,
                       det.border, shapes, budgets)
    ints = np.array(p.ints).reshape(-1, keypoints.LEVEL_INTS)
    floats = np.array(p.floats, np.float32).reshape(-1,
                                                    keypoints.LEVEL_FLOATS)
    assert shapes == ((480, 640), (339, 453), (240, 320), (170, 226))
    assert budgets == (288, 128, 64, 32)
    n = ints[:, 4] * ints[:, 5]
    assert n.tolist() == [768, 432, 192, 192]
    assert (n >= 2 * ints[:, 2]).all()
    assert ints[:, 3].tolist() == [0, 288, 416, 480]        # first slots
    assert ints[:, 8].tolist() == [0, 768, 1200, 1392]      # first subtiles
    assert ints[:, 9].tolist() == [0, 96, 150, 174]         # first blocks
    assert (p.slots, p.candidates, p.blocks, p.max_candidates) == (
        512, 1584, 198, 768)
    assert ints[:, 6:8].tolist() == [[20, 20], [19, 19], [20, 20], [15, 15]]
    assert floats[:, :3].tolist() == [[20, 619, 459], [20, 432, 318],
                                      [20, 299, 219], [17, 208, 152]]
    assert floats[:, 3].tolist() == [np.float32(det.scale_factor ** k)
                                     for k in range(4)]


def test_camera_floats_are_atens_float32():
    cam = tum_fr1_config().camera
    f = keypoints.camera_floats(cam)
    assert len(f) == keypoints.CAMERA_FLOATS
    f32 = np.float32
    assert f[4] == f32(1.0) / f32(cam.fu) and f[5] == f32(1.0) / f32(cam.fv)
    assert f[0] == f32(cam.cu) and f[10] == f32(cam.p2)
    assert f[11] == f32(cam.min_depth) and f[12] == f32(cam.max_depth)
    # the reciprocal is not the division: the card's product with it can
    # differ from the CPU's quotient in the last bit
    x = np.arange(1, 641, dtype=np.float32) - f32(cam.cu)
    assert not np.array_equal(x * f32(f[4]), x / f32(cam.fu))


def test_describe_patches_takes_the_patch_matrix():
    p = torch.rand((64, brief.PATCH, brief.PATCH),
                   generator=torch.Generator().manual_seed(3))
    flat = brief.patch_matrix(p)
    assert flat.dtype == torch.bfloat16 and tuple(flat.shape) == (64, 1024)
    for kind in brief.KINDS:
        (d0, a0), (d1, a1) = (brief.describe_patches(x, kind)
                              for x in (p, flat))
        assert torch.equal(d0, d1) and torch.equal(_bits(a0), _bits(a1))
