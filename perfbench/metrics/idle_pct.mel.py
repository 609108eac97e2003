"""Share of the profiled calls' wall time of bulk synthesis in which no
operation ran on the device."""


def read(record, sl):
    if sl is None or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.wall_s)
