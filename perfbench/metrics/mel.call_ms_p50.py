"""Median host milliseconds of an engine call (``InferenceEngine.run``,
its output copied to the host) in the window."""

from harness import readers


def read(record, sl):
    calls = record.get("calls")
    if not calls:
        return None
    return readers.p50([(c["t1"] - c["t0"]) * 1e3 for c in calls])
