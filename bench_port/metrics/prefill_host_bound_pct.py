"""The share of the ``vv.prefill`` spans' wall, clipped to the profile and
put on its clock (``trace_clock_offset_ns``), during which no device
operation ran on any stream but the frame step's: the prefills' time on
the host, whatever its cause. None if the profile covers less than half a
prefill (each counted by the share of its span inside it), as
``prefill_device_ms``."""

from bplib import spans


def read(run):
    got = spans.prefill_intervals(run)
    if got is None:
        return None
    ivs, covered = got
    decode = run.trace.decode_streams()
    if not decode or covered < 0.5:
        return None
    ivs = spans.union(ivs)
    wall = spans.length(ivs)
    others = spans.device_busy(run, {st for *_, st, _ in run.trace.device} - decode)
    return 100.0 * (wall - spans.overlap(ivs, others)) / wall
