"""The 99th percentile, over all requests, of the interval between
consecutive windows of one request's audio (K chunks that arrive together)
inside the window."""

from bplib import harness


def read(run):
    return harness.e2e(run)["gap_p99_ms"]
