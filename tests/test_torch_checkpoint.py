"""Checkpoints: the port's round trip is exact; a checkpoint the JAX package
wrote loads into the port and equals ``convert.from_numpy`` of the same
state (exact: the same arrays), and one the port wrote loads into the JAX
package; the JAX state's ``key`` leaf is ignored on load and never written;
a shape mismatch raises ValueError, a missing leaf KeyError; resuming a run
from a checkpoint continues it exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.models import slam as jslam
from putslam_tpu.utils import checkpoint as jckpt
from putslam_tpu_torch import convert
from putslam_tpu_torch.models import slam as tslam
from putslam_tpu_torch.utils import checkpoint as tckpt

T = 8


@pytest.fixture(scope="module")
def run():
    """A JAX state after a few frames (keyframes, BA, graph filled), and
    the frames."""
    cfg = tiny_test_config()
    poses = np.asarray(jsyn.orbit_trajectory(T, radius=0.10, yaw_amp=0.1))
    g, d = (np.asarray(x) for x in jsyn.render_sequence(cfg.camera,
                                                        jnp.asarray(poses)))
    js = jslam.slam_init(cfg, g[0], d[0], poses[0])
    for i in range(1, 5):
        js, _ = jslam.slam_step(cfg, js, g[i], d[i])
    return cfg, js, g, d, poses


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}/")
    else:
        yield prefix[:-1], tree


def _assert_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert list(la) == list(lb)
    for key in la:
        x, y = n(la[key]), n(lb[key])
        assert x.dtype == y.dtype and np.array_equal(x, y), key


def test_round_trip_exact(tmp_path, run):
    cfg, js, g, d, poses = run
    state = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    path = str(tmp_path / "ck.npz")
    tckpt.save_state(path, state)
    template = tslam.slam_init(port_cfg(cfg), t(g[0]), t(d[0]), t(poses[0]),
                               device="cpu")
    back = tckpt.load_state(path, template)
    assert type(back) is tslam.SlamState
    assert type(back.map) is type(state.map)
    _assert_equal(back, state)
    assert all(torch.is_tensor(v) for _, v in _leaves(back))


def test_keys_are_the_jax_package_paths(tmp_path, run):
    cfg, js, *_ = run
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save_state(jp, js)
    tckpt.save_state(tp, convert.from_numpy(jax.tree.map(np.asarray, js),
                                            "cpu"))
    jkeys, tkeys = set(np.load(jp).files), set(np.load(tp).files)
    assert jkeys - tkeys == {"key"} and tkeys <= jkeys
    for key in ("map/kf_pose", "graph/obs_kf", "lc_queue/prob", "ekf/x",
                "prev_feat/desc", "pose"):
        assert key in tkeys


def test_jax_checkpoint_loads_into_the_port_and_back(tmp_path, run):
    cfg, js, g, d, poses = run
    jp = str(tmp_path / "j.npz")
    jckpt.save_state(jp, js)
    template = tslam.slam_init(port_cfg(cfg), t(g[0]), t(d[0]), t(poses[0]),
                               device="cpu")
    loaded = tckpt.load_state(jp, template)         # the key leaf is ignored
    _assert_equal(loaded, convert.from_numpy(jax.tree.map(np.asarray, js),
                                             "cpu"))
    # the other way: the port's file carries no key, so the JAX loader
    # gets one from a file of its own beside it
    tp = str(tmp_path / "t.npz")
    tckpt.save_state(tp, loaded)
    jtemplate = jslam.slam_init(cfg, g[0], d[0], poses[0])
    with pytest.raises(KeyError):
        jckpt.load_state(tp, jtemplate)
    with np.load(tp) as data:
        np.savez(str(tmp_path / "tk.npz"), key=np.asarray(js.key),
                 **{k: data[k] for k in data.files})
    jback = jckpt.load_state(str(tmp_path / "tk.npz"), jtemplate)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(js)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_mismatches_raise(tmp_path, run):
    cfg, js, g, d, poses = run
    state = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    path = str(tmp_path / "ck.npz")
    tckpt.save_state(path, state)
    wrong = state._replace(pose=torch.zeros(6))
    with pytest.raises(ValueError, match="pose"):
        tckpt.load_state(path, wrong)
    with np.load(path) as data:
        np.savez(str(tmp_path / "less.npz"),
                 **{k: data[k] for k in data.files if k != "graph/obs_w"})
    with pytest.raises(KeyError, match="graph/obs_w"):
        tckpt.load_state(str(tmp_path / "less.npz"), state)


def test_other_trees_and_dtypes(tmp_path):
    tree = {"b": [torch.arange(3, dtype=torch.int32), torch.ones(2, 2)],
            "a": (torch.tensor(True), np.float64(2.5))}
    path = str(tmp_path / "tree.npz")
    tckpt.save_state(path, tree)
    assert set(np.load(path).files) == {"a/0", "a/1", "b/0", "b/1"}
    back = tckpt.load_state(path, tree)
    assert back["b"][0].dtype == torch.int32 and back["a"][0].dtype == torch.bool
    assert torch.equal(back["b"][1], tree["b"][1])
    assert float(back["a"][1]) == 2.5 and isinstance(back["a"], tuple)


def test_resume_continues_exactly(tmp_path, run):
    """Stop after frame 4, write the state and the generator's state, load
    both into a fresh state and generator, continue: every later output and
    the final state equal the uninterrupted run's."""
    cfg, _, g, d, poses = run
    pcfg = port_cfg(cfg)
    tg, td = t(g), t(d)

    def start():
        gen = torch.Generator()
        gen.manual_seed(5)
        return tslam.slam_init(pcfg, tg[0], td[0], t(poses[0]),
                               device="cpu"), gen

    state, gen = start()
    state, _ = tslam.slam_sequence(pcfg, state, tg[1:5], td[1:5],
                                   generator=gen)
    path = str(tmp_path / "mid.npz")
    tckpt.save_state(path, state)
    gen_state = gen.get_state()
    full_state, full_outs = tslam.slam_sequence(pcfg, state, tg[5:], td[5:],
                                                generator=gen)

    fresh, gen2 = start()
    resumed = tckpt.load_state(path, fresh)
    gen2.set_state(gen_state)
    res_state, res_outs = tslam.slam_sequence(pcfg, resumed, tg[5:], td[5:],
                                              generator=gen2)
    _assert_equal(res_outs, full_outs)
    _assert_equal(res_state, full_state)
