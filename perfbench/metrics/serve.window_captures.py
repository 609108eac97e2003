"""CUDA graphs the engine captured during the window
(``GraphCache.captures``, ``inference/graphs.py``): each is a compile the
warm-up missed."""


def read(record, sl):
    n = record.get("window_captures")
    return None if n is None else float(n)
