"""K2, the training attention (``ops/attention_train.py``): operations
and compulsory bytes of one call, as ``chip_smoke.py`` ``k2_bound`` counts
them (the Pallas CostEstimates: 4 E a valid (query, key) pair forward, 10
E backward)."""


def work(lengths, T: int, E: int, H: int, backward: bool,
         dot_bytes: int = 2):
    """(FLOPs, bytes) of one K2 call over B = len(lengths) rows padded to
    T: every query row of a row against its valid keys; q/k/v (and their
    gradients) at ``dot_bytes``, the output (or its cotangent) in float32,
    the (B, H, T) row statistics, lengths and seeds."""
    B = len(lengths)
    pairs = float(sum(T * min(max(n, 0), T) for n in lengths))
    flops = (10 if backward else 4) * E * pairs
    nbytes = (6 if backward else 3) * B * T * E * dot_bytes \
        + B * T * E * 4 + 2 * B * H * T * 4 + 2 * B * 4
    return flops, nbytes
