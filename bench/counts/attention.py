"""K4 (flash prefill) and K5 (paged decode), per layer and per call."""


def flash_prefill(S: int, H: int, KH: int, D: int, itemsize: int = 2):
    """One causal prefill of S tokens: 4·D FLOPs per visible (query, key)
    pair and head (Q·Kᵀ and P·V); q and the output once, k and v once."""
    pairs = S * (S + 1) // 2
    flops = 4 * D * H * pairs
    bytes_ = itemsize * D * S * (2 * H + 2 * KH)
    return flops, bytes_


def paged_decode(lengths, H: int, KH: int, D: int, itemsize: int = 2):
    """One decode step over the sequences whose cache lengths (the new
    token included) are ``lengths``: each valid K and V row read once,
    each query read and each output written once."""
    n = sum(lengths)
    flops = 4 * D * H * n
    bytes_ = itemsize * D * (2 * KH * n + 2 * H * len(lengths))
    return flops, bytes_
