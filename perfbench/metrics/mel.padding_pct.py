"""Share of the decoded frame-rows of the window's calls that are
padding: rows x output bucket against the rows' real frames."""


def read(record, sl):
    calls = record.get("calls")
    padded = sum(len(c["frames"]) * c["bucket"] for c in calls or ())
    if not padded:
        return None
    real = sum(sum(c["frames"]) for c in calls)
    return 100.0 * (padded - real) / padded
