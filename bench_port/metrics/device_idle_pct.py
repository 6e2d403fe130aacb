"""The share of the profiled stretch's wall with no operation running on
the device on any stream (the union of the device operations' intervals)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
