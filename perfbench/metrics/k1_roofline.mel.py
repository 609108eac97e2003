"""K1's (the fused inference FFT block's) share of its roofline in the
profiled calls of bulk synthesis: the bound of every block call of every
pass at its real lengths (``work/k1.py``) over the union of K1's device
intervals."""

from harness import readers


def read(record, sl):
    if sl is None or not sl.work.get("calls"):
        return None
    calls = []
    for c in sl.work["calls"]:
        for module, blocks, E, H, C in readers.fft_blocks(record["config"]):
            if module == "prosody_encoder":
                lens, n = c["ref_frames"], c["ref_padded"]
            elif module == "phoneme_encoder":
                lens, n = c["symbols"], c["symbols_padded"]
            else:
                lens, n = c["frames"], c["bucket"]
            calls += [(lens, n, E, C)] * (blocks * c["passes"])
    return readers.share(readers.k1_bound_s(calls), sl, "k1")
