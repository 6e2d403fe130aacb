"""The program's own spans (``vibevoice_tpu_torch.utils.profiling``'s
recorder), read after a run for the per-layer readers, on the profile's
clock beside the device's operations.

A program without the recorder gives nothing to read: every function here
then returns None, and the readers return None, without raising."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def recorder():
    """The program's profiling module if it has the recorder, else None."""
    try:
        from vibevoice_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "trace_clock_offset_ns")):
        return None
    return profiling


def held() -> Optional[list]:
    """Every span the recorder holds, or None without a recorder."""
    prof = recorder()
    return None if prof is None else prof.spans()


def union(ivs: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as disjoint intervals in order."""
    out: List[List[int]] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(ivs: Sequence[Interval]) -> int:
    return sum(b - a for a, b in ivs)


def overlap(xs: Sequence[Interval], ys: Sequence[Interval]) -> int:
    """The length of the intersection of two unions (each disjoint, in
    order)."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_clip(run) -> Optional[Tuple[int, int, int]]:
    """(start, end) of the profile in the recorder's clock (ns) and the
    offset to the profile's clock, or None without a profile or recorder."""
    prof = recorder()
    if prof is None or run.trace is None or run.trace_span[1] <= run.trace_span[0]:
        return None
    a, b = run.trace_span
    return int(a * 1e9), int(b * 1e9), prof.trace_clock_offset_ns()


def device_busy(run, streams=None) -> List[Interval]:
    """The union of the device operations' intervals, on ``streams`` only
    if given, in the profile's clock."""
    return union([(s, s + d) for _, s, d, st, _ in run.trace.device
                  if streams is None or st in streams])


def prefill_intervals(run) -> Optional[Tuple[List[Interval], float]]:
    """The ``vv.prefill`` spans clipped to the profile, in the profile's
    clock, and the prefills they cover (each by the share of its span
    inside the profile)."""
    clip, spans = profile_clip(run), held()
    if clip is None or spans is None:
        return None
    a, b, off = clip
    ivs, covered = [], 0.0
    for s in spans:
        if s.name != "vv.prefill" or s.t1 <= s.t0:
            continue
        lo, hi = max(s.t0, a), min(s.t1, b)
        if hi > lo:
            ivs.append((lo + off, hi + off))
            covered += (hi - lo) / (s.t1 - s.t0)
    return ivs, covered


def windows_in_flight(run) -> Optional[List[Interval]]:
    """The union of each window's interval from the start of its
    ``vv.window.dispatch`` to the end of its ``vv.window.process`` (which
    names the dispatch as its parent), clipped to the profile, in the
    profile's clock."""
    clip, spans = profile_clip(run), held()
    if clip is None or spans is None:
        return None
    a, b, off = clip
    dispatch = {s.sid: s for s in spans if s.name == "vv.window.dispatch"}
    ivs = []
    for p in spans:
        d = dispatch.get(p.parent) if p.name == "vv.window.process" else None
        if d is not None:
            lo, hi = max(d.t0, a), min(p.t1, b)
            if hi > lo:
                ivs.append((lo + off, hi + off))
    return union(ivs)
