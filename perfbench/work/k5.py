"""K5, the fused MRF vocoder stage (``ops/mrf_vocoder.py``): operations
and compulsory bytes of one call, as ``chip_smoke.py`` ``k5_bound`` counts
them, over the real samples only."""


def fan(cfg):
    """(taps, convs) of one stage's fan: every conv of every resblock (two
    a dilation for ResBlock1)."""
    per = 2 if str(cfg.get("resblock", "1")) == "1" else 1
    pairs = list(zip(cfg["resblock_kernel_sizes"],
                     cfg["resblock_dilation_sizes"]))
    return (sum(per * k * len(d) for k, d in pairs),
            sum(per * len(d) for _, d in pairs))


def work(samples, rows_padded: int, n_padded: int, C: int, n_taps: int,
         n_convs: int):
    """(FLOPs, bytes) of one K5 call: 2 C^2 a tap for every real output
    sample (``samples``: the real samples of each row at this stage); x
    read and the output written once in float32 over the padded call, the
    bf16 taps and float32 biases once."""
    flops = 2.0 * float(sum(samples)) * C * C * n_taps
    nbytes = 2 * rows_padded * n_padded * C * 4 + n_taps * C * C * 2 \
        + n_convs * C * 4
    return flops, nbytes
