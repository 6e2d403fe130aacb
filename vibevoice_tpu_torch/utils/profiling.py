"""Spans and profiles (port of vibevoice_tpu/utils/profiling.py).

    from vibevoice_tpu_torch.utils import profiling

    with profiling.span("vv.queue", rid=7):   # a span in the recorder (always on)
        ...
    profiling.spans()                          # a snapshot of what is held

    with profiling.trace("prof/"):             # a torch.profiler trace written into prof/
        out = generate(...)

    with profiling.phase("prefill"):           # a span, and while a profile runs
        ...                                    # a named range in it (and NVTX)

**The recorder** is process-wide and always on. It holds the last
``CAPACITY`` spans in a bounded deque (older ones are dropped). A span is its name, its start and end in ``time.monotonic_ns()``
(the clock of ``RequestHandle.submit_time`` and of the benchmark's
harness), the native id of the thread that recorded it, a request id and
its parent's span id. Recording one costs a few clock reads and one
append: no lock, no device work (no synchronise, no event, no
allocation). ``span`` is a context manager whose spans nest on a thread
(a span opened inside another takes it as its parent and its request id,
unless given); ``record`` enters a span measured elsewhere, such as one
that starts on one thread and ends on another.
``trace_clock_offset_ns()`` maps the recorder's clock to the one that
``torch.profiler`` (Kineto) stamps its events in, ``CLOCK_REALTIME``:
``kineto_ns = monotonic_ns + trace_clock_offset_ns()``.

``trace`` records the host's activity, and the card's (CUPTI) when one is
present, and writes a Chrome trace (``trace.json``, which TensorBoard's and
Perfetto's viewers read) plus ``key_averages.txt``, the table of ops and
kernels by total time. ``phase`` is a recorder span that, while a profile
is running, is also a ``torch.profiler.record_function`` range and, on the
card, an NVTX range; with no profile it costs about what a span costs
(``record_function`` alone costs 9-16 us a call even then).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

CAPACITY = 65_536  # spans held; minutes of serving traffic


class Span(NamedTuple):
    name: str
    t0: int  # time.monotonic_ns()
    t1: int
    thread: int  # threading.get_native_id() of the recording thread
    rid: Optional[int]  # the request's id (RequestHandle.rid), if any
    parent: Optional[int]  # the parent's sid, if any
    sid: int  # this span's id


class _Thread:
    """A thread's open spans and its native id, held in a ``threading.local``:
    they go with the thread."""

    __slots__ = ("stack", "tid", "__weakref__")

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


class _Open:
    """An open span of ``span()``: its id and start are fixed on entry,
    its end on ``end()`` or on exit, and it is recorded on exit."""

    __slots__ = ("rec", "name", "rid", "parent", "sid", "t0", "t1", "th")

    def __init__(self, rec: "Recorder", name: str, rid, parent, start_ns):
        self.rec = rec
        self.name = name
        self.rid = rid
        self.parent = parent
        self.t0 = start_ns
        self.t1 = None

    def __enter__(self) -> "_Open":
        th = self.th = self.rec._thread()
        if th.stack:
            top = th.stack[-1]
            if self.parent is None:
                self.parent = top.sid
            if self.rid is None:
                self.rid = top.rid
        self.sid = next(self.rec._ids)
        if self.t0 is None:
            self.t0 = time.monotonic_ns()
        th.stack.append(self)
        return self

    def end(self, t1_ns: Optional[int] = None) -> int:
        """End the span now (or at ``t1_ns``) though its block goes on;
        returns the end."""
        self.t1 = time.monotonic_ns() if t1_ns is None else t1_ns
        return self.t1

    def __exit__(self, *exc) -> bool:
        if self.t1 is None:
            self.t1 = time.monotonic_ns()
        th = self.th
        th.stack.pop()
        self.rec._spans.append((self.name, self.t0, self.t1, th.tid, self.rid, self.parent,
                                self.sid))
        return False


class Recorder:
    """A bounded store of spans (module docstring). Every thread appends to
    the deque (atomic): nothing takes a lock."""

    def __init__(self, capacity: int = CAPACITY):
        # plain tuples in Span's order, made Spans when read
        self._spans: "collections.deque" = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _thread(self) -> _Thread:
        try:
            return self._local.th
        except AttributeError:
            th = self._local.th = _Thread()
            return th

    def next_id(self) -> int:
        """A fresh span id, for a span recorded later (``record(sid=)``)
        that others name as their parent meanwhile."""
        return next(self._ids)

    def span(self, name: str, rid: Optional[int] = None, parent: Optional[int] = None, *,
             start_ns: Optional[int] = None) -> _Open:
        return _Open(self, name, rid, parent, start_ns)

    def record(self, name: str, t0_ns: int, t1_ns: int, rid: Optional[int] = None,
               parent: Optional[int] = None, *, sid: Optional[int] = None) -> int:
        sid = next(self._ids) if sid is None else sid
        self._spans.append((name, t0_ns, t1_ns, threading.get_native_id(), rid, parent, sid))
        return sid

    def spans(self, since_ns: Optional[int] = None) -> List[Span]:
        """The spans held, oldest first; with ``since_ns`` those that end at
        or after it."""
        return [Span._make(s) for s in list(self._spans)
                if since_ns is None or s[2] >= since_ns]


RECORDER = Recorder()


def span(name: str, rid: Optional[int] = None, parent: Optional[int] = None, *,
         start_ns: Optional[int] = None) -> _Open:
    """A span of the block in the process-wide recorder; ``start_ns`` starts
    it at an earlier reading of ``time.monotonic_ns()``."""
    return RECORDER.span(name, rid, parent, start_ns=start_ns)


def record(name: str, t0_ns: int, t1_ns: int, rid: Optional[int] = None,
           parent: Optional[int] = None, *, sid: Optional[int] = None) -> int:
    """Record a span measured elsewhere; returns its id (``sid`` if given,
    from ``next_id()``)."""
    return RECORDER.record(name, t0_ns, t1_ns, rid, parent, sid=sid)


def next_id() -> int:
    return RECORDER.next_id()


def spans(since_ns: Optional[int] = None) -> List[Span]:
    """A snapshot of the spans held (``Recorder.spans``)."""
    return RECORDER.spans(since_ns)


def trace_clock_offset_ns() -> int:
    """``kineto_ns - monotonic_ns``: Kineto stamps host and device events in
    ``CLOCK_REALTIME`` (``time.time_ns()``); of 64 readings of that clock
    around one of ``time.monotonic_ns()``, the tightest gives the offset."""
    best = None
    for _ in range(64):
        a = time.time_ns()
        m = time.monotonic_ns()
        b = time.time_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2 - m)
    return best[1]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block into ``log_dir`` (trace.json, key_averages.txt);
    yields the ``torch.profiler.profile``, whose events are read after the
    block. CUDA activity is recorded when a card is present."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=False)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
        with open(os.path.join(log_dir, "key_averages.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


@contextlib.contextmanager
def phase(name: str) -> Iterator[_Open]:
    """Name a region: a recorder span, and while a profile is running a
    range of that name in it and an NVTX range on the card."""
    with span(name) as sp:
        if not torch.autograd.profiler._is_profiler_enabled:
            yield sp
            return
        nvtx = torch.cuda.is_available()
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            with record_function(name):
                yield sp
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
