"""The port's ICL-NUIM preparation against the JAX package's on a small
POV-Ray tree written here (two 640×480 ``scene_*.depth`` ray-distance dumps,
their PNGs and a trajectory file): ``ray_to_z`` and ``read_icl_depth`` exact,
the written TUM-layout sequence equal when read back (the JAX package writes
the depth PNG with PIL, the port with its own codec: the pixels are equal,
the files need not be), and the depth back to the truth within the 16-bit
quantisation."""

import numpy as np
import pytest

from putslam_tpu.io import icl as jicl
from putslam_tpu.io import tum as jtum
from putslam_tpu_torch.io import icl as ticl
from putslam_tpu_torch.io import png as tpng
from putslam_tpu_torch.io import tum as ttum

H, W = 480, 640


def _ray_dist(z):
    un = (np.arange(W, dtype=np.float64)[None, :] - ticl.ICL_CU) / ticl.ICL_FU
    vn = (np.arange(H, dtype=np.float64)[:, None] - ticl.ICL_CV) \
        / abs(ticl.ICL_FV)
    return z * np.sqrt(1.0 + un * un + vn * vn)


@pytest.fixture(scope="module")
def povray(tmp_path_factory):
    src = tmp_path_factory.mktemp("povray")
    rng = np.random.default_rng(3)
    z_true = rng.uniform(0.8, 4.0, (H, W))
    dist = _ray_dist(z_true)
    for i, layout in enumerate(("line", "rows")):
        rows = dist.ravel()[None] if layout == "line" else dist
        np.savetxt(src / f"scene_00_{i:04d}.depth", rows, fmt="%.5f")
        tpng.write_png(str(src / f"scene_00_{i:04d}.png"),
                       rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    # a depth dump without its image is skipped
    np.savetxt(src / "scene_00_0002.depth", dist.ravel()[None], fmt="%.5f")
    (src / "traj0.gt.freiburg").write_text("0 0 0 -2.5 0 0 0 1\n")
    return src, z_true


def test_constants_and_ray_to_z_equal():
    for name in ("ICL_FU", "ICL_FV", "ICL_CU", "ICL_CV"):
        assert getattr(ticl, name) == getattr(jicl, name)
    rng = np.random.default_rng(0)
    dist = rng.uniform(0.5, 8.0, (H, W))
    ours = ticl.ray_to_z(dist)
    assert ours.dtype == np.float32
    assert np.array_equal(ours, jicl.ray_to_z(dist))
    small = rng.uniform(0.5, 8.0, (6, 8))
    assert np.array_equal(ticl.ray_to_z(small, 50.0, -40.0, 3.5, 2.5),
                          jicl.ray_to_z(small, 50.0, -40.0, 3.5, 2.5))


def test_read_icl_depth_equal(povray, tmp_path):
    src, _ = povray
    for i in range(2):                         # one-line and per-row layouts
        path = str(src / f"scene_00_{i:04d}.depth")
        assert np.array_equal(ticl.read_icl_depth(path),
                              jicl.read_icl_depth(path))
    short = tmp_path / "short.depth"
    short.write_text("1.0 2.0 3.0\n")
    with pytest.raises(ValueError):
        ticl.read_icl_depth(str(short))
    assert ticl.read_icl_depth(str(short), 3, 1).shape == (1, 3)


def test_prepare_icl_sequence_equal(povray, tmp_path):
    src, z_true = povray
    jout, tout = tmp_path / "j", tmp_path / "t"
    assert jicl.prepare_icl_sequence(str(src), str(jout)) == 2
    assert ticl.prepare_icl_sequence(str(src), str(tout)) == 2
    for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
        assert (tout / name).read_text() == (jout / name).read_text()
    jds, tds = jtum.TumDataset(str(jout)), ttum.TumDataset(str(tout))
    assert len(tds) == len(jds) == 2 and tds.pairs == jds.pairs
    for i in range(2):
        assert np.array_equal(tds[i].gray, jds[i].gray)
        assert np.array_equal(tds[i].depth, jds[i].depth)
    err = np.abs(tds[0].depth.astype(np.float64) - z_true)
    assert err.max() < 1.5e-3          # 16-bit at 5000 counts: 0.2 mm steps
    np.testing.assert_allclose(tds.starting_pose(),
                               [0, 0, -2.5, 1, 0, 0, 0], atol=1e-6)


def test_main_writes_at_the_given_scale(povray, tmp_path, capsys):
    src, z_true = povray
    out = tmp_path / "m"
    assert ticl.main([str(src), str(out), "1000"]) == 0
    assert "wrote 2 frames" in capsys.readouterr().out
    d = tpng.read_png(str(out / "depth" / "00000.png"))
    assert d.dtype == np.uint16
    np.testing.assert_allclose(d / 1000.0, z_true, atol=1.5e-3)
    assert ticl.main([]) == 2
