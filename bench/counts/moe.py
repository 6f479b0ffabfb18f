"""The expert products of a mixture-of-experts layer (GLU experts)."""


def expert_products(T: int, k: int, D: int, F: int, experts_used: int,
                    itemsize: int = 2):
    """T tokens routed to k experts each: three products (gate, up,
    down) of 2·D·F FLOPs per (token, expert) pair; the used experts'
    weights and the tokens' rows read once, one output row written per
    pair. The GLU's intermediates stay on chip in the least work."""
    flops = 6 * T * k * D * F
    bytes_ = itemsize * (3 * experts_used * D * F + T * D + T * k * D)
    return flops, bytes_
