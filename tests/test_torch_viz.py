"""The offline visualizer (utils/viz.py) against the JAX package's: each
plot's data — every line's ``Line2D.get_xydata()`` and every scatter's
``PathCollection.get_offsets()`` and colour array, axis by axis, with the
titles — equals the JAX function's on the same arrays (exactly: both hand
matplotlib the same float32 values). Tensors are accepted as inputs; and
``run.main(--synthetic 3 --plots)`` on the CPU writes trajectory.png,
map.png and stats.png whose data equal the JAX functions' on the arrays
the run handed to the port's."""

import json
import types

import matplotlib.figure
import numpy as np
import pytest
import torch

from putslam_tpu.utils import viz as jviz
from putslam_tpu_torch import run
from putslam_tpu_torch.utils import viz as tviz
from putslam_tpu_torch.utils.device import as_numpy


@pytest.fixture()
def figures(monkeypatch):
    """Every figure saved, as a list of (path, data): per axes its title
    and the data of its lines and collections, read before it is closed."""
    seen = []
    real = matplotlib.figure.Figure.savefig

    def spy(fig, path, *a, **k):
        data = []
        for ax in fig.axes:
            data.append((ax.get_title(),
                         [ln.get_xydata().tolist() for ln in ax.get_lines()],
                         [(np.asarray(c.get_offsets()).tolist(),
                           None if c.get_array() is None
                           else np.asarray(c.get_array()).tolist())
                          for c in ax.collections]))
        seen.append((str(path), data))
        return real(fig, path, *a, **k)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", spy)
    return seen


def _arrays(seed=0, T=12, L=40, K=6):
    rng = np.random.default_rng(seed)
    est = rng.normal(0, 0.3, (T, 7)).astype(np.float32)
    gt = est + rng.normal(0, 0.01, (T, 7)).astype(np.float32)
    ms = dict(lm_pos=rng.normal(0, 1, (L, 3)).astype(np.float32),
              lm_valid=rng.uniform(size=L) > 0.3,
              lm_n_obs=rng.integers(0, 30, L).astype(np.int32),
              kf_pose=rng.normal(0, 0.3, (K, 7)).astype(np.float32),
              kf_valid=rng.uniform(size=K) > 0.2)
    outs = dict(n_map_inliers=rng.integers(0, 200, T).astype(np.int32),
                n_landmarks=np.cumsum(rng.integers(0, 9, T)).astype(np.int32),
                is_keyframe=rng.uniform(size=T) > 0.5,
                chi2=rng.uniform(0.1, 100.0, (T, 3)).astype(np.float32),
                ba_ran=rng.uniform(size=T) > 0.4)
    return est, gt, ms, outs


def _ns(d, wrap=lambda x: x):
    return types.SimpleNamespace(**{k: wrap(v) for k, v in d.items()})


def test_plots_match_jax(figures, tmp_path):
    est, gt, ms, outs = _arrays()
    tt = torch.as_tensor
    jviz.plot_trajectory(str(tmp_path / "j_traj.png"), est, gt, title="x")
    tviz.plot_trajectory(str(tmp_path / "t_traj.png"), tt(est), tt(gt),
                         title="x")
    jviz.plot_trajectory(str(tmp_path / "j_traj2.png"), est)
    tviz.plot_trajectory(str(tmp_path / "t_traj2.png"), est)
    jviz.plot_map(str(tmp_path / "j_map.png"), _ns(ms), est)
    tviz.plot_map(str(tmp_path / "t_map.png"), _ns(ms, tt), tt(est))
    jviz.plot_run_stats(str(tmp_path / "j_stats.png"), _ns(outs), title="s")
    tviz.plot_run_stats(str(tmp_path / "t_stats.png"), _ns(outs, tt),
                        title="s")
    assert len(figures) == 8
    for (jp, jd), (tp, td) in zip(figures[0::2], figures[1::2]):
        assert "j_" in jp and "t_" in tp
        assert td == jd, (jp, tp)
        assert (tmp_path / tp.split("/")[-1]).stat().st_size > 0
    # the map scatter holds the valid landmarks, coloured by clipped counts
    _, map_data = figures[4]
    offsets, colours = map_data[0][2][0]
    assert len(offsets) == int(ms["lm_valid"].sum())
    assert max(colours) <= 20


def test_run_plots_match_jax(figures, tmp_path, capsys, monkeypatch):
    calls = []
    for name in ("plot_trajectory", "plot_map", "plot_run_stats"):
        real = getattr(tviz, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, a, k))
            return _real(*a, **k)

        monkeypatch.setattr(tviz, name, spy)
    out = tmp_path / "run"
    assert run.main(["--synthetic", "3", "--device", "cpu", "--plots",
                     "--out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "frames"] == 3
    assert [c[0] for c in calls] == ["plot_trajectory", "plot_map",
                                     "plot_run_stats"]
    assert sorted(p.name for p in out.glob("*.png")) == \
        ["map.png", "stats.png", "trajectory.png"]
    port_figs = list(figures)
    figures.clear()
    for name, args, kw in calls:
        path, *rest = args
        if name == "plot_map":
            st = rest[0]
            rest[0] = _ns({f: as_numpy(getattr(st, f)) for f in
                           ("lm_pos", "lm_valid", "lm_n_obs", "kf_pose",
                            "kf_valid")})
        elif name == "plot_run_stats":
            rest[0] = _ns({f: as_numpy(getattr(rest[0], f)) for f in
                           ("n_map_inliers", "n_landmarks", "is_keyframe",
                            "chi2", "ba_ran")})
        rest = [None if x is None else x if isinstance(
            x, types.SimpleNamespace) else as_numpy(x) for x in rest]
        getattr(jviz, name)(str(tmp_path / f"jax_{name}.png"), *rest, **kw)
    assert len(port_figs) == len(figures) == 3
    for (tp, td), (_, jd) in zip(port_figs, figures):
        assert td == jd, tp
    assert len(port_figs[0][1][0][1]) == 2     # estimate and ground truth
