"""99th percentile of how late the open-loop generator handed the
window's requests over, past when each was due: the client's own delay,
which the latencies include."""

from harness import common


def read(record, sl):
    late = record.get("lateness_s")
    if not late:
        return None
    return common.percentile(late, 99) * 1e3
