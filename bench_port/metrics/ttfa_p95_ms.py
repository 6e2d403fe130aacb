"""The 95th percentile, over every request due inside the window, of the
time from when it was due (its open-loop arrival) to its first audio; a
request that failed or never had audio counts above every measured value."""

from bplib import harness


def read(run):
    return harness.e2e(run)["ttfa_p95_ms"]
