"""Rows a batch of the server's dynamic batcher, over the window (the
service's ``batch_sizes`` counter, ``cli/serve.py``)."""


def read(record, sl):
    sizes = record.get("batch_sizes")
    n = sum(sizes.values()) if sizes else 0
    if not n:
        return None
    return sum(int(k) * v for k, v in sizes.items()) / n
