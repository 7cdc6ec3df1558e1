"""Loop-closure parity: BoW signature (exact), tf-idf scoring (1e-6, with
and without idf), the candidate queue (exact arrays, scores included, over
a wrapped ring, the recency gate and tie-heavy score vectors) and the
geometric verification of keyframe pairs from a JAX revisit run fed the
same uniforms (ok and n_inliers exact, ratio 1e-6, rel_pose 1e-5)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import n, port_cfg, t

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic as jsyn
from putslam_tpu.loopclosure import bow as jbow
from putslam_tpu.loopclosure import verify as jverify
from putslam_tpu.models import slam as jslam
from putslam_tpu_torch import convert
from putslam_tpu_torch.loopclosure import bow as tbow
from putslam_tpu_torch.loopclosure import verify as tverify


def _queue_equal(tq, jq):
    np.testing.assert_array_equal(n(tq.kf_a), np.asarray(jq.kf_a))
    np.testing.assert_array_equal(n(tq.kf_b), np.asarray(jq.kf_b))
    np.testing.assert_array_equal(n(tq.prob), np.asarray(jq.prob))


def test_vocab_is_the_jax_vocab_and_cached():
    v = tbow.make_vocab(512, "cpu")
    np.testing.assert_array_equal(n(v), np.asarray(jbow.make_vocab(512)))
    assert tbow.make_vocab(512, "cpu") is v


@pytest.mark.parametrize("flip", [0.0, 0.3])
def test_signature_matches_jax(flip):
    """flip = 0: descriptors equal to vocabulary words (one exact winner);
    0.3: noisy copies, where even-integer dot products tie often."""
    rng = np.random.default_rng(0)
    vocab = np.asarray(jbow.make_vocab(512))
    desc = vocab[rng.integers(0, 512, 256)].copy()
    desc[rng.uniform(size=desc.shape) < flip] *= -1
    valid = rng.uniform(size=256) > 0.2
    ref = jbow.signature(jnp.asarray(vocab), jnp.asarray(desc),
                         jnp.asarray(valid))
    got = tbow.signature(tbow.make_vocab(512, "cpu"), t(desc), t(valid))
    np.testing.assert_array_equal(n(got), np.asarray(ref))


@pytest.mark.parametrize("use_idf", [True, False])
def test_score_against_matches_jax(use_idf):
    rng = np.random.default_rng(1)
    K, V = 32, 512
    sigs = np.where(rng.uniform(size=(K, V)) < 0.1,
                    rng.integers(1, 6, (K, V)), 0).astype(np.float32)
    sigs /= np.maximum(np.linalg.norm(sigs, axis=1, keepdims=True), 1e-9)
    q = sigs[3] + 0.2 * (rng.uniform(size=V) < 0.05)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    valid = rng.uniform(size=K) > 0.3
    ref = jbow.score_against(jnp.asarray(sigs), jnp.asarray(q),
                             jnp.asarray(valid), use_idf=use_idf)
    got = tbow.score_against(t(sigs), t(q), t(valid), use_idf=use_idf)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-6, rtol=0)
    assert np.array_equal(np.isinf(n(got)), ~valid)


def test_queue_push_pop_matches_jax():
    """Twelve pushes into an 8-slot queue over a wrapped 16-slot keyframe
    ring (sequence numbers past the ring size), scores quantised to 0.05 so
    that many tie, with a pop after every push; then pops until the queue
    is empty and beyond (argmax of all -inf is slot 0, prob stays -inf)."""
    rng = np.random.default_rng(2)
    K, Q = 16, 8
    jq = jbow.init_queue(Q)
    tq = tbow.init_queue(Q, "cpu")
    _queue_equal(tq, jq)
    for step in range(12):
        n_kf = 20 + step
        kf_seq = np.array([(n_kf - 1 - ((n_kf - 1 - s) % K))
                           if s < K else -1 for s in range(K)], np.int32)
        kf_seq[rng.uniform(size=K) < 0.1] = -1            # empty slots
        scores = np.round(rng.uniform(0, 1, K) / 0.05) * 0.05
        scores = scores.astype(np.float32)
        kf_a = (n_kf - 1) % K
        jq = jbow.push_candidates(jq, jnp.int32(kf_a), jnp.asarray(scores),
                                  jnp.asarray(kf_seq), jnp.int32(n_kf),
                                  tail_skip=3, min_score=0.3)
        tq = tbow.push_candidates(tq, torch.tensor(kf_a, dtype=torch.int32),
                                  t(scores), t(kf_seq),
                                  torch.tensor(n_kf, dtype=torch.int32),
                                  tail_skip=3, min_score=0.3)
        _queue_equal(tq, jq)
        ja, jb, jp, jq = jbow.pop_best(jq)
        ta, tb, tp, tq = tbow.pop_best(tq)
        assert (int(ta), int(tb)) == (int(ja), int(jb))
        assert float(tp) == float(jp)
        _queue_equal(tq, jq)
    for _ in range(Q + 2):
        ja, jb, jp, jq = jbow.pop_best(jq)
        ta, tb, tp, tq = tbow.pop_best(tq)
        assert (int(ta), int(tb), float(tp)) == (int(ja), int(jb), float(jp))
        _queue_equal(tq, jq)
    assert not bool(torch.isfinite(tp))          # empty: nothing to verify


@functools.lru_cache(maxsize=1)
def _revisit_state():
    """JAX slam state 16 frames into a 24-frame revisit (sweep 0.6 m) on
    the tiny config, with the LC test's map settings."""
    cfg = tiny_test_config()
    cfg = cfg.replace(map=dataclasses.replace(
        cfg.map, add_features_when_measurements_less_than=10,
        max_keyframes=64))
    poses = np.asarray(jsyn.revisit_trajectory(24, sweep=0.6))
    g, d = (np.asarray(x) for x in jsyn.render_sequence(
        cfg.camera, jnp.asarray(poses)))
    s = jslam.slam_init(cfg, g[0], d[0], poses[0])
    for i in range(1, 17):
        s, _ = jslam.slam_step(cfg, s, g[i], d[i])
    return cfg, s


def test_verify_candidate_matches_jax():
    cfg, js = _revisit_state()
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    valid = np.nonzero(np.asarray(js.map.kf_valid))[0]
    assert len(valid) >= 4
    H, k = cfg.ransac.n_hypotheses, cfg.ransac.used_pairs
    key = jax.random.PRNGKey(5)
    n_ok = 0
    for a in valid[-3:]:
        for b in valid[:4]:
            if a == b:
                continue
            key, sub = jax.random.split(key)
            ref = jverify.verify_candidate(cfg, js.map, js.graph,
                                           jnp.int32(a), jnp.int32(b), sub)
            u = t(jax.random.uniform(sub, (k, H), maxval=1.0))
            got = tverify.verify_candidate(
                port_cfg(cfg), ts.map, ts.graph, torch.tensor(a, dtype=torch.int32),
                torch.tensor(b, dtype=torch.int32), u=u)
            assert bool(got.ok) == bool(ref.ok), (a, b)
            assert int(got.n_inliers) == int(ref.n_inliers), (a, b)
            np.testing.assert_allclose(n(got.ratio), np.asarray(ref.ratio),
                                       rtol=1e-6)
            np.testing.assert_allclose(n(got.rel_pose),
                                       np.asarray(ref.rel_pose), atol=1e-5)
            n_ok += int(ref.ok)
    assert n_ok >= 1


def test_gather_kf_set_matches_jax():
    """The view-aware descriptor slot and the fixed-size edge gather."""
    cfg, js = _revisit_state()
    ts = convert.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for kf in np.nonzero(np.asarray(js.map.kf_valid))[0]:
        ref = jverify._gather_kf_set(js.map, js.graph, jnp.int32(kf))
        got = tverify._gather_kf_set(ts.map, ts.graph,
                                     torch.tensor(kf, dtype=torch.int32))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(n(a), np.asarray(b))
