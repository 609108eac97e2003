"""Share of the samples vocoded in the window's engine calls that are
padding: padded rows x output bucket against the real rows' frames."""


def read(record, sl):
    calls = [c for c in record.get("engine_calls", ())
             if c.get("bucket") is not None]
    padded = sum(c["rows_padded"] * c["bucket"] for c in calls)
    if not padded:
        return None
    real = sum(sum(c["frames"]) for c in calls)
    return 100.0 * (padded - real) / padded
