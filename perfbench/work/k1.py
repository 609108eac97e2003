"""K1, the fused inference FFT block (``ops/fft_block.py``): operations
and compulsory bytes of one call, as ``chip_smoke.py`` ``k1_bound`` counts
them. Rows past a length need no work."""


def work(lengths, T: int, E: int, C: int, dot_bytes: int = 2):
    """(FLOPs, bytes) of one K1 call on B = len(lengths) rows padded to T:
    the QKV and output projections (8 E^2 a row), the scores and the
    weighted values (4 n E for a row of n), the two k=3 convs (12 E C a
    row); x read and out written once in float32, the dot weights once at
    ``dot_bytes``, the FiLM rows and lengths once."""
    B = len(lengths)
    flops = sum(2.0 * n * (4 * E * E + 6 * E * C) + 4.0 * n * n * E
                for n in lengths)
    nbytes = 2 * B * T * E * 4 + (4 * E * E + 6 * E * C) * dot_bytes \
        + B * 2 * E * 4 + B * 4
    return flops, nbytes
