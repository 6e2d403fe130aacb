"""The share of the decode-in-flight time inside the profile during which
no device operation ran on any stream. The decode-in-flight time is the
union of each window's interval from the start of its
``vv.window.dispatch`` span to the end of its ``vv.window.process`` span
in the program's recorder, clipped to the profile and put on its clock
(``trace_clock_offset_ns``): the idle time that falls while windows are in
flight, apart from an engine with no work."""

from bplib import spans


def read(run):
    ivs = spans.windows_in_flight(run)
    if not ivs:
        return None
    wall = spans.length(ivs)
    return 100.0 * (wall - spans.overlap(ivs, spans.device_busy(run))) / wall
