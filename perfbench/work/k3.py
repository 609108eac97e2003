"""K3, the training conv feed-forward (``ops/conv_ff_train.py``):
operations and compulsory bytes of one call, as ``chip_smoke.py``
``k3_bound`` counts them, with the operations of the real rows only."""


def work(lengths, T: int, E: int, C: int, backward: bool,
         dot_bytes: int = 2):
    """(FLOPs, bytes) of one call over B = len(lengths) rows padded to T:
    two k=3 convs, 12 E C a real row forward and 36 E C backward; x (and
    the cotangent, dx) in float32, the conv weights once at ``dot_bytes``
    (and their float32 gradients), the vectors and FiLM once."""
    B = len(lengths)
    rows = float(sum(min(n, T) for n in lengths))
    flops = (36 if backward else 12) * rows * E * C
    nbytes = (4 if backward else 2) * B * T * E * 4 + 6 * E * C * dot_bytes \
        + (6 * E * C + C + 3 * E) * 4 * backward \
        + (C + 5 * E) * 4 + B * 2 * E * 4 * (2 if backward else 1) + B * 4
    return flops, nbytes
