"""Binary bag-of-words place recognition.

Port of ``putslam_tpu/loopclosure/bow.py``: a fixed random ±1 vocabulary,
nearest-word histograms (tf signatures), tf-idf cosine scoring against the
stored keyframe signatures, and the fixed-capacity candidate queue.

Ties follow the JAX package: ``argmax`` takes the first maximum (as
``torch.argmax`` does), and ``jax.lax.top_k``'s lowest-index-first order
among equal values — the ``-inf`` of masked and empty slots included — is a
stable descending sort cut to k, so the queue's empty slots hold the same
``kf_a`` / ``kf_b`` as the JAX package's.

The word histogram is a float ``index_add_`` of 1.0s (and 0.0s), exact in
any order below 2**24 per word, so it repeats itself on the card without a
fixed order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from putslam_tpu_torch.utils.indexing import take_row

DESC_BITS = 256
VOCAB_SEED = 17

_VOCABS: dict = {}


def make_vocab(vocab_size: int, device, seed: int = VOCAB_SEED) -> torch.Tensor:
    """(V, 256) ±1 int8 word prototypes from a fixed numpy seed — the JAX
    package's words — built once per (size, seed, device) and cached."""
    device = torch.device(device)
    key = (vocab_size, seed, device)
    vocab = _VOCABS.get(key)
    if vocab is None:
        rng = np.random.default_rng(seed)
        vocab = torch.as_tensor(rng.choice(np.array([-1, 1], np.int8),
                                           size=(vocab_size, DESC_BITS)),
                                device=device)
        _VOCABS[key] = vocab
    return vocab


def signature(vocab: torch.Tensor, desc: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """L2-normalised nearest-word histogram (V,) of one frame. desc (N, 256)
    ±1 int8; valid (N,). The ±1 dot products are even integers ≤ 256, exact
    in a float32 matmul (TF32 is off in this package)."""
    V = vocab.shape[0]
    word = torch.argmax(desc.float() @ vocab.float().T, dim=1)
    hist = torch.zeros((V,), dtype=torch.float32, device=desc.device)
    hist.index_add_(0, word, valid.to(torch.float32))
    return hist / torch.clamp(torch.linalg.norm(hist), min=1e-9)


def score_against(signatures: torch.Tensor, sig: torch.Tensor,
                  sig_valid: torch.Tensor, use_idf: bool = True
                  ) -> torch.Tensor:
    """tf-idf cosine of ``sig`` (V,) against the stored signatures (K, V)
    → (K,), ``-inf`` on invalid rows. idf_v = log((1 + n_docs) / (1 + df_v))
    over the valid rows; ``use_idf=False`` is the plain tf cosine."""
    if use_idf:
        n_docs = torch.sum(sig_valid.to(torch.float32))
        df = torch.sum(((signatures > 0.0) & sig_valid[:, None])
                       .to(torch.float32), dim=0)
        idf = torch.log((1.0 + n_docs) / (1.0 + df))
        ws = signatures * idf[None, :]
        wq = sig * idf
        ws = ws / torch.clamp(torch.linalg.norm(ws, dim=1, keepdim=True),
                              min=1e-9)
        wq = wq / torch.clamp(torch.linalg.norm(wq), min=1e-9)
        s = ws @ wq
    else:
        s = signatures @ sig
    return torch.where(sig_valid, s, torch.full_like(s, -np.inf))


class LCQueue(NamedTuple):
    """Fixed-capacity priority buffer of loop-closure candidates."""

    kf_a: torch.Tensor   # (Q,) int32 — current keyframe
    kf_b: torch.Tensor   # (Q,) int32 — candidate past keyframe
    prob: torch.Tensor   # (Q,) float32 — score (-inf = empty)


def init_queue(capacity: int, device) -> LCQueue:
    i32 = dict(dtype=torch.int32, device=device)
    return LCQueue(torch.full((capacity,), -1, **i32),
                   torch.full((capacity,), -1, **i32),
                   torch.full((capacity,), -np.inf, dtype=torch.float32,
                              device=device))


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties lowest index first."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def push_candidates(q: LCQueue, kf_a, scores: torch.Tensor, kf_seq, n_kf,
                    tail_skip: int, min_score: float,
                    top_k: int = 4) -> LCQueue:
    """Gate (recency by sequence number, absolute score), take the best
    ``top_k`` and merge them into the queue, keeping the top-capacity."""
    recent = (kf_seq > n_kf - 1 - tail_skip) | (kf_seq < 0)
    ninf = torch.full_like(scores, -np.inf)
    s = torch.where(recent, ninf, scores)
    s = torch.where(s >= min_score, s, ninf)
    top_p, top_i = _top_k(s, top_k)
    cand_a = torch.as_tensor(kf_a, device=scores.device).to(
        torch.int32).expand(top_k)
    all_a = torch.cat([q.kf_a, cand_a])
    all_b = torch.cat([q.kf_b, top_i.to(torch.int32)])
    all_p = torch.cat([q.prob, top_p])
    keep_p, keep_i = _top_k(all_p, q.prob.shape[0])
    return LCQueue(all_a[keep_i], all_b[keep_i], keep_p)


def pop_best(q: LCQueue):
    """Best candidate and the queue with its slot cleared. Returns
    (kf_a, kf_b, prob, queue'); on an empty queue slot 0 is taken and
    ``prob`` is ``-inf``. Device ops only, no host sync."""
    i = torch.argmax(q.prob)
    hit = torch.arange(q.prob.shape[0], device=i.device) == i
    a, b, p = (take_row(x, i) for x in q)
    return a, b, p, LCQueue(
        torch.where(hit, torch.full_like(q.kf_a, -1), q.kf_a),
        torch.where(hit, torch.full_like(q.kf_b, -1), q.kf_b),
        torch.where(hit, torch.full_like(q.prob, -np.inf), q.prob))
