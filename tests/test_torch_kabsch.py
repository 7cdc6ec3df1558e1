"""RANSAC's rigid fit (``putslam_tpu_torch/ops/kabsch.py``) on the CPU.

The CPU runs the plain version, which fixes every order the card's kernel
(``csrc/kabsch_fit.cu``) follows. Held here: against the JAX package's
``putslam_tpu.ops.kabsch`` on the same numpy inputs (atol 1e-5, as
``tests/test_torch_vo.py::test_kabsch_matches_jax``), at the main path's
shapes (1024 sampled hypotheses of 3 points, a refit over 512 matches) and
on degenerate inputs; against the formulation it replaced (``torch.sum``,
``mean``, ``torch.linalg.norm``, ``se3.quat_rotate``, ``se3.make_pose``),
kept below, bit for bit (it writes that formulation's CPU arithmetic out);
the sum orders, the norm and the cross product against ATen's CPU
kernels; a CPU tensor takes the plain path; and
``ransac.estimate`` at the fr1 widths against JAX on the same draws. The
kernel itself runs on the card only: ``tests/test_torch_kabsch_cuda.py``.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tum_fr1_config
from putslam_tpu.frontend import ransac as jransac
from putslam_tpu.geometry import se3 as jse3
from putslam_tpu.ops import kabsch as jkabsch
from putslam_tpu_torch.frontend import ransac as transac
from putslam_tpu_torch.geometry import se3 as tse3
from putslam_tpu_torch.ops import kabsch as tkabsch

ATOL_JAX = 1e-5
EPS = float(np.finfo(np.float32).eps)
# the rewritten plain version against the old formulation, in ulps of 1.0
# (float32 eps): it writes out the old formulation's CPU arithmetic, so
# none (tests/_kabsch_probe.py ulps: 0.0 on every case)
ULPS = 0


def _scene(rng, N, outliers=0.0):
    """(p, q): N points about 2 m ahead, q = T·p + noise, a share of the
    pairs moved off as outliers."""
    p = (rng.uniform(-1, 1, (N, 3)) + [0, 0, 2]).astype(np.float32)
    T = np.asarray(jse3.make_pose(jnp.asarray([0.05, -0.02, 0.03]),
                                  jnp.asarray([1.0, 0.02, -0.03, 0.01])))
    q = np.asarray(jse3.apply(jnp.asarray(T), jnp.asarray(p)))
    q = q + rng.normal(0, 0.003, q.shape)
    bad = rng.uniform(size=N) < outliers
    q[bad] += rng.uniform(-0.5, 0.5, (bad.sum(), 3))
    return p, q.astype(np.float32)


def _weighted_case(kind):
    """(p, q, w) of one refit case, made with numpy from a seed."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    if kind == "batch":                       # 3 rows, more than one lane row
        ps, qs = zip(*(_scene(rng, 700, 0.2) for _ in range(3)))
        p, q = np.stack(ps), np.stack(qs)
        return p, q, (rng.uniform(size=(3, 700)) < 0.7).astype(np.float32)
    p, q = _scene(rng, 512, 0.3)
    w = (rng.uniform(size=512) < 0.6).astype(np.float32)
    if kind == "zero_weights":
        w[:] = 0.0
    elif kind == "three_equal_points":
        w[:] = 0.0
        w[[4, 9, 100]] = 1.0
        p[[4, 9, 100]] = p[4]
        q[[4, 9, 100]] = q[4]
    elif kind == "collinear":
        s = rng.uniform(-1, 1, 512).astype(np.float32)
        p = (np.array([0.1, 0.2, 2.0], np.float32)
             + s[:, None] * np.array([0.6, -0.3, 0.2], np.float32))
        q = p + np.array([0.05, 0.0, -0.02], np.float32)
    elif kind == "two_valid":
        w[:] = 0.0
        w[[17, 300]] = 1.0
    return p, q, w


WEIGHTED = ["refit_512", "batch", "zero_weights", "three_equal_points",
            "collinear", "two_valid"]


def _sampled_case(kind):
    """The six (3, H) components of a sampled fit: H = 1024 minimal samples
    of a scene with outliers, or a degenerate set."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    p, q = _scene(rng, 512, 0.3)
    idx = rng.integers(0, 512, (3, 1024))
    if kind == "three_equal_points":
        idx[:] = idx[0]
    elif kind == "collinear":
        s = rng.uniform(-1, 1, 512).astype(np.float32)
        p = (np.array([0.1, 0.2, 2.0], np.float32)
             + s[:, None] * np.array([0.6, -0.3, 0.2], np.float32))
        q = p + np.array([0.05, 0.0, -0.02], np.float32)
    return [np.ascontiguousarray(x[:, c][idx]) for x in (p, q)
            for c in range(3)]


SAMPLED = ["sampled_1024", "three_equal_points", "collinear"]


@pytest.mark.parametrize("kind", WEIGHTED)
def test_weighted_kabsch_matches_jax(kind):
    p, q, w = _weighted_case(kind)
    got = n(tkabsch.weighted_kabsch(t(p), t(q), t(w)))
    ref = np.asarray(jkabsch.weighted_kabsch(jnp.asarray(p), jnp.asarray(q),
                                             jnp.asarray(w)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL_JAX)


@pytest.mark.parametrize("kind", ["sampled_1024", "collinear"])
def test_kabsch_soa_matches_jax(kind):
    comps = _sampled_case(kind)
    got = n(tkabsch.kabsch_soa(*(t(c) for c in comps)))
    ref = np.asarray(jkabsch.kabsch_soa(*(jnp.asarray(c) for c in comps)))
    assert got.shape == ref.shape == (1024, 7)
    np.testing.assert_allclose(got, ref, atol=ATOL_JAX)


def test_kabsch_soa_of_three_equal_points_is_a_valid_pose():
    """Three equal points determine no rotation: S is the rounding noise of
    p − p̄, which differs between the packages (4e-5 apart on 2 % of the
    components), so each package's rotation is its own. Both give finite
    unit quaternions with w ≥ 0 and a translation that maps the point onto
    its match."""
    comps = _sampled_case("three_equal_points")
    got = n(tkabsch.kabsch_soa(*(t(c) for c in comps)))
    ref = np.asarray(jkabsch.kabsch_soa(*(jnp.asarray(c) for c in comps)))
    p = np.stack([c[0] for c in comps[:3]], -1).astype(np.float64)
    q = np.stack([c[0] for c in comps[3:]], -1).astype(np.float64)
    for pose in (got, ref):
        assert np.isfinite(pose).all()
        np.testing.assert_allclose(np.linalg.norm(pose[:, 3:], axis=-1), 1.0,
                                   atol=1e-6)
        assert (pose[:, 3] >= 0).all()
        moved = np.asarray(jse3.apply(jnp.asarray(pose), jnp.asarray(p)))
        np.testing.assert_allclose(moved, q, atol=ATOL_JAX)


# ---- the formulation the plain version replaced -------------------------

def _old_horn(S, iters=30):
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S
    k00 = Sxx + Syy + Szz
    k01 = Syz - Szy
    k02 = Szx - Sxz
    k03 = Sxy - Syx
    k11 = Sxx - Syy - Szz
    k12 = Sxy + Syx
    k13 = Szx + Sxz
    k22 = -Sxx + Syy - Szz
    k23 = Syz + Szy
    k33 = -Sxx - Syy + Szz
    a = torch.abs
    c = (a(k00) + a(k11) + a(k22) + a(k33)
         + 2.0 * (a(k01) + a(k02) + a(k03) + a(k12) + a(k13) + a(k23))) \
        / 4.0 + 1e-6
    b00, b11, b22, b33 = k00 + c, k11 + c, k22 + c, k33 + c
    b01, b02, b03, b12, b13, b23 = k01, k02, k03, k12, k13, k23
    for _ in range(max(3, (iters + 5) // 6)):
        n00 = b00 * b00 + b01 * b01 + b02 * b02 + b03 * b03
        n01 = b00 * b01 + b01 * b11 + b02 * b12 + b03 * b13
        n02 = b00 * b02 + b01 * b12 + b02 * b22 + b03 * b23
        n03 = b00 * b03 + b01 * b13 + b02 * b23 + b03 * b33
        n11 = b01 * b01 + b11 * b11 + b12 * b12 + b13 * b13
        n12 = b01 * b02 + b11 * b12 + b12 * b22 + b13 * b23
        n13 = b01 * b03 + b11 * b13 + b12 * b23 + b13 * b33
        n22 = b02 * b02 + b12 * b12 + b22 * b22 + b23 * b23
        n23 = b02 * b03 + b12 * b13 + b22 * b23 + b23 * b33
        n33 = b03 * b03 + b13 * b13 + b23 * b23 + b33 * b33
        scale = torch.clamp(torch.maximum(torch.maximum(n00, n11),
                                          torch.maximum(n22, n33)), min=1e-30)
        inv = 1.0 / scale
        b00, b11, b22, b33 = n00 * inv, n11 * inv, n22 * inv, n33 * inv
        b01, b02, b03 = n01 * inv, n02 * inv, n03 * inv
        b12, b13, b23 = n12 * inv, n13 * inv, n23 * inv
    c0, c1, c2, c3 = 1.0, 0.31, 0.17, 0.083
    v0 = b00 * c0 + b01 * c1 + b02 * c2 + b03 * c3
    v1 = b01 * c0 + b11 * c1 + b12 * c2 + b13 * c3
    v2 = b02 * c0 + b12 * c1 + b22 * c2 + b23 * c3
    v3 = b03 * c0 + b13 * c1 + b23 * c2 + b33 * c3
    nrm = torch.clamp(torch.sqrt(v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3),
                      min=1e-20)
    v0, v1, v2, v3 = v0 / nrm, v1 / nrm, v2 / nrm, v3 / nrm
    u0 = b00 * v0 + b01 * v1 + b02 * v2 + b03 * v3
    u1 = b01 * v0 + b11 * v1 + b12 * v2 + b13 * v3
    u2 = b02 * v0 + b12 * v1 + b22 * v2 + b23 * v3
    u3 = b03 * v0 + b13 * v1 + b23 * v2 + b33 * v3
    v = torch.stack([u0, u1, u2, u3], dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-20)
    return torch.where(v[..., 0:1] < 0, -v, v)


def _old_weighted(p, q, w):
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    wn = w / wsum
    p_bar = torch.sum(wn[..., None] * p, dim=-2)
    q_bar = torch.sum(wn[..., None] * q, dim=-2)
    pc = p - p_bar[..., None, :]
    qc = q - q_bar[..., None, :]
    wpc = wn[..., None] * pc
    S = [torch.sum(wpc[..., i] * qc[..., j], dim=-1)
         for i in range(3) for j in range(3)]
    quat = tse3.quat_normalize(_old_horn(S))
    return tse3.make_pose(q_bar - tse3.quat_rotate(quat, p_bar), quat)


def _old_soa(px, py, pz, qx, qy, qz):
    pb = [c.mean(0) for c in (px, py, pz)]
    qb = [c.mean(0) for c in (qx, qy, qz)]
    pcs = [c - m for c, m in zip((px, py, pz), pb)]
    qcs = [c - m for c, m in zip((qx, qy, qz), qb)]
    S = [torch.sum(pcs[i] * qcs[j], dim=0)
         for i in range(3) for j in range(3)]
    quat = tse3.quat_normalize(_old_horn(S))
    p_bar, q_bar = torch.stack(pb, dim=-1), torch.stack(qb, dim=-1)
    return tse3.make_pose(q_bar - tse3.quat_rotate(quat, p_bar), quat)


@pytest.mark.parametrize("kind", WEIGHTED + ["sampled_" + k for k in SAMPLED])
def test_rewritten_plain_within_ulps_of_the_old_formulation(kind):
    if kind.startswith("sampled_"):
        comps = [t(c) for c in _sampled_case(kind[len("sampled_"):])]
        new, old = tkabsch.plain_kabsch_soa(*comps), _old_soa(*comps)
    else:
        p, q, w = (t(x) for x in _weighted_case(kind))
        new, old = tkabsch.plain_weighted_kabsch(p, q, w), _old_weighted(p, q, w)
    ulps = float((new - old).abs().max()) / EPS
    assert ulps <= ULPS, f"{kind}: {ulps:.1f} ulps of 1.0 from the old form"


@pytest.mark.parametrize("N", [1, 3, 7, 8, 13, 64, 128, 129, 512, 700,
                               1024, 4100])
def test_sum_orders_are_the_cpus(N):
    """``inner_sum`` and ``row_sum`` repeat ATen's CPU float sums bit for
    bit: of a contiguous row, and over the rows of an (n, 3) array."""
    rng = np.random.default_rng(N)
    x = torch.from_numpy((rng.standard_normal((3, N))
                          * 10.0 ** rng.integers(-3, 4, (3, N)))
                         .astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((3, N, 3)).astype(np.float32))
    assert torch.equal(tkabsch.inner_sum(x), torch.sum(x, dim=-1))
    assert torch.equal(tkabsch.row_sum(y), torch.sum(y, dim=-2))


def _split_row_sum(x):
    """Column totals of x (n, cols) float32 as the refit kernel's
    ``warp_row_sum`` computes them: accumulator k of a column is a chain of
    the rows 4i + k; its first-level blocks of ``step`` rows, each summed
    from +0.0 apart (a lane each), are merged in block order through the
    cascade, after the rows past the last full block; then the column's
    total is accumulator 0, the rows past the last full row of four, and
    accumulators 1-3 in turn."""
    f32 = np.float32
    n_rows, cols = x.shape
    size = n_rows // 4
    power = max(4, tkabsch._ceil_log2(size) // 4)
    step, mask, nb = 1 << power, (1 << power) - 1, size >> power
    totals = []
    for col in range(cols):
        chain = []
        for k in range(4):
            rows = x[4 * np.arange(size) + k, col]
            parts = np.zeros(nb, f32)       # the blocks, independent
            for r in range(step):
                parts = parts + rows[r:nb * step:step]
            acc1 = acc2 = acc3 = f32(0.0)
            for b in range(nb):             # one lane merges them in order
                acc1 = acc1 + parts[b]
                i = (b + 1) << power
                if not i & (mask << power):
                    acc2, acc1 = acc2 + acc1, f32(0.0)
                    if not i & (mask << (2 * power)):
                        acc3, acc2 = acc3 + acc2, f32(0.0)
            acc0 = f32(0.0)
            for v in rows[nb * step:]:
                acc0 = acc0 + v
            chain.append(((acc0 + acc1) + acc2) + acc3)
        total = chain[0]
        for m in range(4 * size, n_rows):
            total = total + x[m, col]
        for k in range(1, 4):
            total = total + chain[k]
        totals.append(total)
    return np.array(totals, f32)


def _split_inner_sum(x):
    """Σ of a float32 row x (n,) as the refit kernel's ``warp_inner_sum``
    computes it: the 8 lanes × 4 accumulators = 32 chains of
    ``_split_row_sum`` over the row's vectors of 8, then from +0.0 the
    elements past the last full vector and the 8 lane totals in turn; a
    row shorter than 8 through ``_split_row_sum`` of one column."""
    lanes = tkabsch.LANES
    if x.shape[0] < lanes:
        return _split_row_sum(x[:, None])[0]
    nv = x.shape[0] // lanes
    total = np.float32(0.0)
    for v in x[nv * lanes:]:
        total = total + v
    for v in _split_row_sum(x[:nv * lanes].reshape(nv, lanes)):
        total = total + v
    return total


@pytest.mark.parametrize("N", [1, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65,
                               127, 128, 129, 255, 256, 257, 511, 512, 513,
                               1023, 1024, 1025, 2051, 4100, 16389])
def test_refit_split_is_the_sum_order(N):
    """The refit kernel's parallel split of the sums (independent chains
    and first-level blocks, merged in a fixed order) gives the bits of
    ``inner_sum``, ``row_sum`` and ``torch.sum`` on the CPU, at sizes across
    the cascade's levels."""
    rng = np.random.default_rng(1000 + N)
    with np.errstate(over="ignore"):
        x = (rng.standard_normal((2, N)) * 10.0 ** rng.integers(-3, 4, (2, N))
             ).astype(np.float32)
        y = rng.standard_normal((N, 3)).astype(np.float32)
        split = [_split_inner_sum(r) for r in x]
        split_rows = _split_row_sum(y)
    np.testing.assert_array_equal(np.array(split, np.float32),
                                  n(tkabsch.inner_sum(t(x))))
    np.testing.assert_array_equal(np.array(split, np.float32),
                                  n(torch.sum(t(x), dim=-1)))
    np.testing.assert_array_equal(split_rows, n(tkabsch.row_sum(t(y))))
    np.testing.assert_array_equal(split_rows, n(torch.sum(t(y), dim=0)))


def test_norm_and_cross_are_the_cpus():
    """``_norm`` is ``torch.linalg.norm`` and ``_cross`` is
    ``torch.linalg.cross`` on the CPU, bit for bit."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy((rng.standard_normal((4096, 4))
                          * 10.0 ** rng.integers(-3, 3, (4096, 4)))
                         .astype(np.float32))
    np.testing.assert_array_equal(
        n(tkabsch._norm(*v.unbind(-1), 0.0)),
        n(torch.linalg.norm(v, dim=-1)))
    a, b = v[:, :3], v.flip(0)[:, 1:]
    np.testing.assert_array_equal(
        n(torch.stack(tkabsch._cross(a.unbind(-1), b.unbind(-1)), -1)),
        n(torch.linalg.cross(a, b, dim=-1)))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel's launch")

    monkeypatch.setattr(tkabsch, "_launch_weighted", refuse)
    p, q, w = (t(x) for x in _weighted_case("refit_512"))
    assert torch.equal(tkabsch.weighted_kabsch(p, q, w),
                       tkabsch.plain_weighted_kabsch(p, q, w))
    comps = [t(c) for c in _sampled_case("sampled_1024")]
    assert torch.equal(tkabsch.kabsch_soa(*comps),
                       tkabsch.plain_kabsch_soa(*comps))


def test_launch_refuses_a_cpu_tensor():
    """The CUDA path checks its inputs before it builds or launches."""
    p, q, w = (t(x) for x in _weighted_case("refit_512"))
    with pytest.raises(ValueError, match="device"):
        tkabsch._launch_weighted(p, q, w, 30)


@pytest.mark.parametrize("outliers", [0.3, 0.8])
def test_estimate_at_fr1_widths_matches_jax_same_draws(outliers):
    """RANSAC with the fr1 config (1024 hypotheses, two refits) over 512
    matches: the same uniforms to both packages."""
    cfg = tum_fr1_config().ransac
    rng = np.random.default_rng(int(outliers * 10))
    p, q = _scene(rng, 512, outliers)
    valid = rng.uniform(size=512) > 0.1
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, (cfg.used_pairs, cfg.n_hypotheses),
                           maxval=1.0)
    ref = jransac.estimate(cfg, None, key, jnp.asarray(p), jnp.asarray(q),
                           jnp.asarray(valid))
    got = transac.estimate(port_cfg(cfg), None, t(p), t(q), t(valid), u=t(u))
    np.testing.assert_allclose(n(got.pose), np.asarray(ref.pose),
                               atol=ATOL_JAX)
    for f in ("inliers", "n_inliers", "ok"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
