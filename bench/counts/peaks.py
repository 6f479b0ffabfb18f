"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, bytes_: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS_PER_S, bytes_ / HBM_BYTES_PER_S)
