"""Host milliseconds a step of the window waited for its batch on the
prefetch queue (``data/loader.py`` collation on ``utils.prefetch_iterator``'s
thread), on average."""


def read(record, sl):
    waits = record.get("data_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
