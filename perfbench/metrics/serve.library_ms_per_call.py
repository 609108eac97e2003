"""Device milliseconds an engine call of the profiled slice spends in
operations that are none of the program's kernels K1-K5: the generator's
staged convs (cuDNN), the library GEMMs, copies and elementwise work."""

from harness import readers


def read(record, sl):
    if sl is None:
        return None
    n = len(sl.work.get("engine_calls", ()))
    if not n:
        return None
    return sl.union_s(exclude=readers.ANY_KERNEL) * 1e3 / n
