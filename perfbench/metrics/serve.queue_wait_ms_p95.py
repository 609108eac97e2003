"""95th percentile of the window's requests' wait before their batch
started: from when each was due to the start of the ``run_jobs`` call
that served it (the pool's hand-off, the job's preparation, the
batcher's window and the batches ahead of it)."""

from harness import common


def read(record, sl):
    waits = record.get("queue_wait_s")
    if not waits:
        return None
    return common.percentile(waits, 95) * 1e3
