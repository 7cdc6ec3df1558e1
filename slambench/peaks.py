"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the denominators of every roofline
share the benchmark reports."""

FP32_OPS_PER_S = 67e12      # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
