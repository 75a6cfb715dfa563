"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit). A share of a roofline is stated against these, with
the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def floor_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time one card could take: the larger of bytes over HBM
    bandwidth and operations over the float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)
