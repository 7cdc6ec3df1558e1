"""Operations and bytes of one launch of ``csrc/guided_match.cu``: every
landmark of the map (L, D descriptor slots) against the frame's N features.

Bytes: read once, the map's descriptors (L × D × 256 int8), slot flags
(L × D bool), octaves (L int32), validity (L bool) and the landmarks in the
camera frame (L × 3 float32); the features' points (N × 3 float32), depth
flags (N bool), octaves (N int32) and descriptors (N × 256 int8); written
once, the feature index (L int32), distance (L float32) and acceptance (L
bool) of each landmark and the count (int32): 8,774,148 at L 8192 × D 4 ×
N 512. The kernel reads every one of them, whatever the gates let through.
These are the bytes this kernel reads, not the bytes the function needs: an
invalid landmark's result (index 0, distance inf, not accepted) does not
depend on its descriptors, which the kernel loads all the same. On maps
with a small share of valid landmarks the share of this bound therefore
reads higher than a bound on the function's bytes would (fr1's walks hold
~13 % valid landmarks: about a sixth of these bytes).

Operations: the sphere gate's float operations, 9 a pair (three
differences, three squares, two sums, one root), on every pair: 37,748,736
at fr1, 0.56 us at 67 TFLOP/s against the bytes' 2.62 us at 3.35 TB/s. The
kernel skips the sphere on pairs that fail the depth or octave gate and
counts bits by popcount only on the pairs that pass it, which depends on
the data; neither can move the bound off the bytes."""

KERNEL = "guided_match_kernel"
GATE_OPS_PER_PAIR = 9


def counts(cfg):
    """(float operations, bytes) of one launch for ``cfg``: L the map's
    landmark capacity, D its descriptor slots, N the feature capacity."""
    L = cfg.map.max_landmarks
    D = cfg.map.descriptor_views
    N = cfg.detector.max_features
    ops = GATE_OPS_PER_PAIR * L * N
    nbytes = (L * D * 256 + L * D + L * 4 + L + L * 3 * 4
              + N * 3 * 4 + N + N * 4 + N * 256
              + L * 4 + L * 4 + L + 4)
    return ops, nbytes
