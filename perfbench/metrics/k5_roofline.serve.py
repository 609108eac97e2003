"""K5's share of its roofline in the profiled slice of serving: the
bound of the real samples of the audio passes (``work/k5.py``) over the
union of K5's device intervals."""

from harness import readers


def read(record, sl):
    if sl is None:
        return None
    calls = [(c["frames"], c["rows_padded"], c["bucket"])
             for c in sl.work.get("engine_calls", ())
             if c.get("bucket") is not None]
    if not calls:
        return None
    cfg = record["config"]
    return readers.share(readers.k5_bound_s(cfg["vocoder"], calls), sl, "k5")
