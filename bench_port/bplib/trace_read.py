"""Reading a ``torch.profiler`` trace of the card into plain records: the
device's operations with their stream, the CUDA runtime calls that
launched them, and the host's ops, for the per-layer readers."""

from __future__ import annotations

import faulthandler
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

RUNTIME_PREFIXES = ("cuda", "cu")  # the CUDA runtime's and driver's calls


@dataclass
class Trace:
    device: List[Tuple[str, int, int, int, int]] = field(default_factory=list)
    # (name, start ns, duration ns, stream, correlation) of each device op
    runtime: List[Tuple[str, int, int, int, int]] = field(default_factory=list)
    # (name, start ns, duration ns, host thread, correlation) of CUDA calls
    host: List[Tuple[str, int, int, int]] = field(default_factory=list)
    # (name, start ns, duration ns, host thread) of host ops
    t0: int = 0
    t1: int = 0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def decode_streams(self) -> Set[int]:
        """Streams that the frame step's graph replays ran on."""
        graph = {c for n, _, _, _, c in self.runtime if n.startswith("cudaGraphLaunch")}
        return {s for _, _, _, s, c in self.device if c in graph}

    def graph_launches(self) -> int:
        return sum(1 for n, *_ in self.runtime if n.startswith("cudaGraphLaunch"))

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device ops' intervals, in order."""
        out: List[List[int]] = []
        for _, s, d, _, _ in sorted(self.device, key=lambda e: e[1]):
            e = s + d
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` longest stretches with no device op, each named by the
        host op that covered its middle longest (``host idle`` if none)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for dur, start in gaps:
            mid = start + dur // 2
            cover = [(d, name) for name, s, d, _ in self.host if s <= mid < s + d]
            label = min(cover)[1] if cover else "host idle"
            out.append((label, dur / 1e9))
        return out

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        tot: Dict[str, int] = {}
        for name, _, d, _, _ in self.device:
            tot[name] = tot.get(name, 0) + d
        return [(k, v / 1e9) for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _get(e, name, default=None):
    f = getattr(e, name, None)
    if f is None:
        return default
    try:
        return f() if callable(f) else f
    except (RuntimeError, TypeError):
        return default


class Profile:
    """A profile of the host and the card (CUPTI) from now to ``stop()``,
    through the autograd profiler itself, whose raw Kineto records are
    read without building the profiler's Python event tree."""

    def __init__(self):
        import torch

        t0 = time.monotonic()
        self.prof = torch.autograd.profiler.profile(use_device="cuda", use_kineto=True)
        self.prof.__enter__()
        log(f"profile started in {time.monotonic() - t0:.3f} s")

    def stop(self):
        import torch

        t0 = time.monotonic()
        # a stop that hangs says where before the run's time limit ends it
        faulthandler.dump_traceback_later(120, exit=False)
        try:
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
        finally:
            faulthandler.cancel_dump_traceback_later()
        log(f"profile stopped in {time.monotonic() - t0:.3f} s")

    def read(self) -> "Trace":
        t0 = time.monotonic()
        t = read(self.prof.kineto_results.events())
        streams = {}
        for _, _, _, st, _ in t.device:
            streams[st] = streams.get(st, 0) + 1
        log(f"profile read in {time.monotonic() - t0:.3f} s: {len(t.device)} device ops "
            f"(by stream {streams}), {len(t.runtime)} runtime calls, {len(t.host)} host ops")
        return t


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read(events) -> Trace:
    """The records of a profile's raw Kineto events."""
    t = Trace()
    lo, hi = None, None
    for e in events:
        start = int(_get(e, "start_ns", _get(e, "start_us", 0) * 1000))
        dur = int(_get(e, "duration_ns", _get(e, "duration_us", 0) * 1000))
        name = _get(e, "name", "")
        corr = int(_get(e, "correlation_id", -1) or -1)
        if str(_get(e, "device_type", "")).endswith("CUDA"):
            t.device.append((name, start, dur, int(_get(e, "device_resource_id", -1)), corr))
        elif name.startswith(RUNTIME_PREFIXES):
            t.runtime.append((name, start, dur, int(_get(e, "start_thread_id", -1)), corr))
        else:
            t.host.append((name, start, dur, int(_get(e, "start_thread_id", -1))))
        if dur >= 0 and start > 0:
            lo = start if lo is None else min(lo, start)
            hi = start + dur if hi is None else max(hi, start + dur)
    t.t0, t.t1 = lo or 0, hi or 0
    return t
