"""Median device milliseconds between the starts of consecutive training
steps in the window (CUDA events recorded before each step's launch): a
step's time on the card while the card is the bottleneck."""

from harness import readers


def read(record, sl):
    steps = record.get("step_s")
    if not steps:
        return None
    return readers.p50(steps) * 1e3
