"""RANSAC's hypotheses and scores (``putslam_tpu_torch/ops/ransac_score.py``)
on the CPU.

The CPU runs the plain version, which fixes every operation the card's
kernel (``csrc/ransac_score.cu``) repeats. Held here, bit for bit (0 ulps):
``plain_score`` against the formulation ``frontend/ransac.py::estimate``
used before the kernel (its ``_pair_errors``, the mask, ``torch.sum``),
kept below, for each error model (0-4, and 3 with information matrices) at the
fr1 widths (1024 poses, 512 matches) and at the tiny config's; and
``plain_hypotheses`` against the gather, ``kabsch.plain_kabsch_soa`` and
``plain_score``. The masked error sum's order (``kabsch.inner_sum``) is
``torch.sum``'s on the CPU for the shapes the kernel sums. A CPU tensor
takes the plain path and the launch refuses one. ``ransac.estimate``
against the JAX package's on the same draws (atol 1e-5, as
``tests/test_torch_kabsch.py::test_estimate_at_fr1_widths_matches_jax_same_draws``)
for each model at the fr1 widths. The kernel itself runs on the card
only: ``tests/test_torch_ransac_score_cuda.py``.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config, tum_fr1_config
from putslam_tpu.frontend import ransac as jransac
from putslam_tpu_torch.frontend import ransac as transac
from putslam_tpu_torch.geometry import se3 as tse3
from putslam_tpu_torch.ops import kabsch as tkabsch
from putslam_tpu_torch.ops import ransac_score as tscore

ATOL_JAX = 1e-5
# the error models: (error_version, with information matrices)
MODELS = [(0, False), (1, False), (2, False), (3, False), (3, True),
          (4, False)]


def _scene(rng, N, outliers):
    """(p, q, valid) numpy: N points about 2 m ahead, q a rigid motion of p
    plus 3 mm noise, a share of the pairs moved off, 10 % invalid; a few
    points near z = 0, where the reprojection models clamp the depth."""
    p = (rng.uniform(-1, 1, (N, 3)) + [0.0, 0.0, 2.0])
    a = 0.04
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    q = p @ R.T + [0.05, -0.02, 0.03] + rng.normal(0, 0.003, (N, 3))
    bad = rng.uniform(size=N) < outliers
    q[bad] += rng.uniform(-0.5, 0.5, (bad.sum(), 3))
    p[:2, 2] = 0.0
    q[2:4, 2] = 1e-10
    valid = rng.uniform(size=N) > 0.1
    return p.astype(np.float32), q.astype(np.float32), valid


def _infos(rng, N):
    """Symmetric positive information matrices of a 3-10 mm anisotropic
    noise (as tests/test_torch_matching_options.py::_infos)."""
    Q, _ = np.linalg.qr(rng.normal(size=(N, 3, 3)))
    sig = rng.uniform(0.003, 0.01, (N, 3))
    info = np.einsum("nij,nj,nkj->nik", Q, 1.0 / sig ** 2, Q)
    return (0.5 * (info + np.swapaxes(info, -1, -2))).astype(np.float32)


def _case(size, version, with_info, seed=0):
    """(cfg, cam, p, q, valid, info, idx) of one case: the fr1 widths (H
    1024 hypotheses of 3 samples over N 512 matches) or the tiny config's;
    the sampler's indices drawn by ``ransac.sample_indices``."""
    jcfg = tum_fr1_config() if size == "fr1" else tiny_test_config()
    rc = dataclasses.replace(jcfg.ransac, error_version=version,
                             inlier_threshold_mahalanobis=(
                                 9.0 if with_info else 4e-4))
    N = 512 if size == "fr1" else 48
    rng = np.random.default_rng(zlib.crc32(f"{size}{version}{with_info}"
                                           f"{seed}".encode()))
    p, q, valid = _scene(rng, N, 0.3)
    info = t(_infos(rng, N)) if with_info else None
    cfg, cam = port_cfg(rc), port_cfg(jcfg.camera)
    u = t(rng.uniform(size=(rc.used_pairs, rc.n_hypotheses))
          .astype(np.float32))
    idx = transac.sample_indices(cfg, t(valid), u)
    return cfg, cam, t(p), t(q), t(valid), info, idx


def _old_pair_errors(cfg, cam, T, p, q, info=None):
    """``frontend/ransac.py::_pair_errors`` as it was before the kernel:
    the error of each (pose, match) pair and its threshold, T (..., 7)."""
    x, y, z = tse3.apply_soa(T[..., None, :], p[..., 0], p[..., 1], p[..., 2])
    dx, dy, dz = x - q[..., 0], y - q[..., 1], z - q[..., 2]

    def reproj_err():
        zp = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        qz = q[..., 2]
        zo = torch.where(torch.abs(qz) < 1e-9, torch.full_like(qz, 1e-9), qz)
        du = cam.fu * (x / zp - q[..., 0] / zo)
        dv = cam.fv * (y / zp - q[..., 1] / zo)
        return torch.sqrt(du * du + dv * dv)

    if cfg.error_version == 0:
        return (torch.sqrt(dx * dx + dy * dy + dz * dz),
                cfg.inlier_threshold_euclidean)
    if cfg.error_version == 4:
        return (torch.sqrt(dx * dx + dy * dy + dz * dz),
                cfg.inlier_threshold_euclidean
                * torch.clamp(q[..., 2], min=1.0))
    if cfg.error_version == 1:
        return reproj_err(), cfg.inlier_threshold_reprojection
    if cfg.error_version == 2:
        e1 = torch.sqrt(dx * dx + dy * dy + dz * dz)
        return torch.maximum(e1 / cfg.inlier_threshold_euclidean,
                             reproj_err() / cfg.inlier_threshold_reprojection
                             ), 1.0
    assert cfg.error_version == 3
    if info is None:
        err = dx * dx + dy * dy + dz * dz
    else:
        i00, i01, i02 = info[:, 0, 0], info[:, 0, 1], info[:, 0, 2]
        i11, i12, i22 = info[:, 1, 1], info[:, 1, 2], info[:, 2, 2]
        err = (i00 * dx * dx + i11 * dy * dy + i22 * dz * dz
               + 2.0 * (i01 * dx * dy + i02 * dx * dz + i12 * dy * dz))
    return err, cfg.inlier_threshold_mahalanobis


def _old_score(cfg, cam, T, p, q, valid, info):
    """The formulation ``ransac.estimate`` scored with before the kernel
    (its (H, N) pass): (inl, counts, the masked error sum)."""
    err, thr = _old_pair_errors(cfg, cam, T, p, q, info)
    inl = (err < thr) & valid[None, :]
    counts = torch.sum(inl, dim=-1)
    err_sum = torch.sum(torch.where(inl, err, torch.zeros_like(err)), dim=-1)
    return inl, counts, err_sum


def _fits(p, q, idx):
    """The sampled fits of ``idx``'s hypotheses, as estimate made them."""
    return tkabsch.kabsch_soa(*(x[:, c][idx] for x in (p, q)
                                for c in range(3)))


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("size", ["fr1", "tiny"])
@pytest.mark.parametrize("version,with_info", MODELS)
def test_plain_score_is_the_old_formulation(size, version, with_info):
    cfg, cam, p, q, valid, info, idx = _case(size, version, with_info)
    T = _fits(p, q, idx)
    model = tscore.model_of(cfg, cam)
    got = tscore.plain_score(T, p, q, valid, model, info)
    _assert_same(got, _old_score(cfg, cam, T, p, q, valid, info))
    assert int(got[1].max()) > 0          # some hypothesis has inliers
    # one pose (a refit's) through the (N,) formulation of the refit pass
    err, thr = _old_pair_errors(cfg, cam, T[5], p, q, info)
    inl, counts, _ = tscore.plain_score(T[5:6], p, q, valid, model, info)
    assert torch.equal(inl[0], (err < thr) & valid)
    assert int(counts[0]) == int(torch.sum(inl[0]))


@pytest.mark.parametrize("size", ["fr1", "tiny"])
@pytest.mark.parametrize("version,with_info", [(0, False), (3, True)])
def test_plain_hypotheses_is_gather_fit_score(size, version, with_info):
    cfg, cam, p, q, valid, info, idx = _case(size, version, with_info)
    model = tscore.model_of(cfg, cam)
    got = tscore.plain_hypotheses(p, q, valid, idx, model, info)
    T = tkabsch.plain_kabsch_soa(*(x[:, c][idx] for x in (p, q)
                                   for c in range(3)))
    _assert_same(got, (T,) + tscore.plain_score(T, p, q, valid, model, info))
    # and the old formulation of estimate: the fit, then the (H, N) pass
    _assert_same(got, (_fits(p, q, idx),)
                 + _old_score(cfg, cam, T, p, q, valid, info))
    assert got[0].shape == (idx.shape[1], 7)


@pytest.mark.parametrize("shape", [(1024, 512), (1, 512), (1024, 37),
                                   (3, 1), (2, 7), (5, 1000), (1, 2051)])
def test_masked_error_sum_order_is_torch_sum(shape):
    """``inner_sum`` of a masked error row (zeros where no inlier) is
    ``torch.sum(dim=-1)`` on the CPU, at the main path's (H, N), at one
    pose, and at ragged N."""
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    err = np.abs(rng.standard_normal(shape)
                 * 10.0 ** rng.integers(-4, 1, shape)).astype(np.float32)
    err[rng.uniform(size=shape) < 0.4] = 0.0
    x = t(err)
    assert torch.equal(tkabsch.inner_sum(x), torch.sum(x, dim=-1))


def test_no_valid_match_and_all_valid():
    cfg, cam, p, q, valid, info, idx = _case("tiny", 0, False)
    model = tscore.model_of(cfg, cam)
    T = _fits(p, q, idx)
    for v in (torch.zeros_like(valid), torch.ones_like(valid)):
        _assert_same(tscore.plain_score(T, p, q, v, model),
                     _old_score(cfg, cam, T, p, q, v, None))
    inl, counts, err_sum = tscore.plain_score(T, p, q,
                                              torch.zeros_like(valid), model)
    assert not bool(inl.any()) and int(counts.max()) == 0
    assert float(err_sum.abs().max()) == 0.0


def test_model_of_checks_the_config():
    cfg, cam = _case("tiny", 0, False)[:2]
    assert tscore.model_of(cfg, cam) == tscore.ScoreModel(
        0, cfg.inlier_threshold_euclidean, cfg.inlier_threshold_reprojection,
        cfg.inlier_threshold_mahalanobis, cam.fu, cam.fv)
    with pytest.raises(ValueError, match="error_version 5"):
        tscore.model_of(dataclasses.replace(cfg, error_version=5), cam)
    with pytest.raises(ValueError, match="needs a camera"):
        tscore.model_of(dataclasses.replace(cfg, error_version=1), None)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel's launch")

    monkeypatch.setattr(tscore, "_launch", refuse)
    cfg, cam, p, q, valid, info, idx = _case("tiny", 3, True)
    model = tscore.model_of(cfg, cam)
    got = tscore.hypotheses(p, q, valid, idx, model, info)
    _assert_same(got, tscore.plain_hypotheses(p, q, valid, idx, model, info))
    _assert_same(tscore.score(got[0][:1], p, q, valid, model, info),
                 tscore.plain_score(got[0][:1], p, q, valid, model, info))
    res = transac.estimate(cfg, cam, p, q, valid,
                           u=torch.rand((cfg.used_pairs, cfg.n_hypotheses),
                                        generator=torch.Generator()
                                        .manual_seed(0)), info=info)
    assert res.pose.shape == (7,)


def test_launch_refuses_a_cpu_tensor():
    """The CUDA path checks its inputs before it builds or launches."""
    cfg, cam, p, q, valid, info, idx = _case("tiny", 0, False)
    model = tscore.model_of(cfg, cam)
    with pytest.raises(ValueError, match="device"):
        tscore._launch(p, q, valid, model, None, idx=idx)
    with pytest.raises(ValueError, match="device"):
        tscore._launch(p, q, valid, model, None, poses=_fits(p, q, idx)[:1])


@pytest.mark.parametrize("version,with_info", MODELS)
def test_estimate_at_fr1_widths_matches_jax_same_draws(version, with_info):
    """RANSAC with the fr1 config (1024 hypotheses, two refits) over 512
    matches, each error model: the same uniforms to both packages."""
    jcfg = tum_fr1_config()
    cfg = dataclasses.replace(jcfg.ransac, error_version=version,
                              inlier_threshold_mahalanobis=(
                                  9.0 if with_info else 4e-4))
    rng = np.random.default_rng(20 + version + 10 * with_info)
    p, q, valid = _scene(rng, 512, 0.3)
    info = _infos(rng, 512) if with_info else None
    key = jax.random.PRNGKey(11)
    u = jax.random.uniform(key, (cfg.used_pairs, cfg.n_hypotheses),
                           maxval=1.0)
    ref = jransac.estimate(cfg, jcfg.camera, key, jnp.asarray(p),
                           jnp.asarray(q), jnp.asarray(valid),
                           info=None if info is None else jnp.asarray(info))
    got = transac.estimate(port_cfg(cfg), port_cfg(jcfg.camera), t(p), t(q),
                           t(valid), u=t(u),
                           info=None if info is None else t(info))
    assert bool(ref.ok)
    np.testing.assert_allclose(n(got.pose), np.asarray(ref.pose),
                               atol=ATOL_JAX)
    for f in ("inliers", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
