"""Seconds of audio delivered to the requests' streams inside the window,
over the window's wall seconds (every chunk that arrived in the window,
whichever request it belongs to)."""

from bplib import harness


def read(run):
    return harness.e2e(run)["audio_s_per_s"]
