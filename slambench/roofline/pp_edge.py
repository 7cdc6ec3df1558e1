"""Operations and bytes of one launch of ``csrc/pp_edge.cu``: the
pose-pose edge terms of one Gauss-Newton iteration over every edge slot of
the graph (E = ``backend.max_pose_pose_edges``), valid or not, as the
kernel computes them.

Bytes: read once a slot, its indices i and j (int32 each), the measured
relative pose (7 float32), the weight (float32), the validity (bool) and
the two generations at insert (int32 each), 49 bytes; the two gathered
keyframe poses (7 float32 each) and the two keyframes' current generations
(int32 each), 64 bytes; written once, the residual (6 float32), the two
6 × 6 Jacobians (float32) and the weight and squared error (float32 each),
320 bytes: 433 bytes a slot, 443,392 at fr1's 1,024 slots. A gathered pose
counts each time a slot reads it (two slots on one keyframe read it twice
from the cache, not from memory), so this bound counts at most the bytes
the kernel moves. The generations count as read on every call: the
in-loop BA passes them; a solve without them reads 8 bytes a slot less.

Operations: ~1,550 float operations a slot (an FMA counts two; a square
root, division, sine, cosine or arc tangent one), counted from the source:
the residual's two inverses and two compositions and its log map (~373),
J_l⁻¹ at −φ (~107), Q (~574: nine 3 × 3 products), Y and the adjoint's
products (~450), the weight (~18). At fr1 1.59 M operations, 0.024 us at
67 TFLOP/s against the bytes' 0.132 us at 3.35 TB/s: the bound is the
bytes. What holds the kernel far above it is its launch and one thread's
dependent chain, which no bound by throughput sees."""

KERNEL = "pp_edge_kernel"
READ_PER_SLOT = 4 + 4 + 7 * 4 + 4 + 1 + 4 + 4 + 2 * 7 * 4 + 2 * 4
WRITTEN_PER_SLOT = 6 * 4 + 2 * 36 * 4 + 4 + 4
OPS_PER_SLOT = 1550


def counts(cfg):
    """(float operations, bytes) of one launch for ``cfg``: E the graph's
    pose-pose edge capacity."""
    E = cfg.backend.max_pose_pose_edges
    return OPS_PER_SLOT * E, (READ_PER_SLOT + WRITTEN_PER_SLOT) * E
