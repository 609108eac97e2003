"""Median host milliseconds of an engine call (``run_cached_to_audio``) in
the window: the benchmark's span around it."""

from harness import readers


def read(record, sl):
    calls = record.get("engine_calls")
    if not calls:
        return None
    return readers.p50([(c["t1"] - c["t0"]) * 1e3 for c in calls])
