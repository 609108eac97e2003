"""Milliseconds a second of the window that the interpreter spent in
garbage collections, which stop the service's threads and the clients'
alike."""


def read(record, sl):
    pauses = record.get("gc_pauses_s")
    if pauses is None:
        return None
    return sum(d for _, d in pauses) * 1e3 / record["window_s"]
