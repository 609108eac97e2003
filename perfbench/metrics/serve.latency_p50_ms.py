"""Median latency of the window's requests, each from when it was due to
when its waveform came back (a failed one counts as infinitely late)."""

from harness import common


def read(record, sl):
    lat = record.get("latency_s")
    if not lat:
        return None
    return common.percentile(lat, 50) * 1e3
