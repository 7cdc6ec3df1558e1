"""Operations and bytes of one hypotheses launch of
``csrc/ransac_score.cu``: H hypotheses, each fitted from its own sampled
matches and scored over the N match slots, for RANSAC's Euclidean error
model.

Operations: those of the plain version it is held bit-equal to, counted
element by element (add, sub, mul, div, neg, abs, sqrt, reciprocal,
clamp, maximum, where, compare) at commit 6b05da9: a fit 719, a score
45.3125 a slot (23,200 at N 512); 24,493,056 at H 1024 × N 512.
Bytes: the matches p and q (N × 3 float32 each) and their mask (N), the
sampled indices (3 × H int64) read once; the poses (H × 7 float32), the
inlier rows (H × N bool), counts (H int64) and error sums (H float32)
written once: 602,624 at H 1024 × N 512."""

KERNEL = "ransac_score_kernel<true"
FIT_OPS = 719
SCORE_OPS_PER_SLOT = 45.3125


def counts(cfg):
    """(float operations, bytes) of one hypotheses launch for ``cfg``:
    H the configured hypotheses, N the feature capacity (the match slots
    of each RANSAC call on the main path)."""
    H = cfg.ransac.n_hypotheses
    N = cfg.detector.max_features
    k = cfg.ransac.used_pairs
    ops = H * (FIT_OPS + SCORE_OPS_PER_SLOT * N)
    nbytes = 2 * N * 3 * 4 + N + k * H * 8 + H * 7 * 4 + H * N + H * 8 + H * 4
    return ops, nbytes
