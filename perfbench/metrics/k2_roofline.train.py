"""K2's (the training attention's) share of its roofline in the profiled
training steps: the bound of every forward and backward call at its real
lengths (``work/k2.py``) over the union of K2's device intervals."""

from harness import readers


def read(record, sl):
    if sl is None or not sl.work.get("steps"):
        return None
    calls = []
    for step in sl.work["steps"]:
        for L, T, ins, outs in step:
            for module, blocks, E, H, C in readers.fft_blocks(
                    record["config"]):
                n, lens = (L, ins) if module == "phoneme_encoder" \
                    else (T, outs)
                calls += [(lens, n, E, H)] * blocks
    return readers.share(readers.k2_bound_s(calls), sl, "k2")
