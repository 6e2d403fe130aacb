"""Tracing and profiling helpers (port of vibevoice_tpu/utils/profiling.py).

    from vibevoice_tpu_torch.utils.profiling import trace, phase

    with trace("prof/"):            # a torch.profiler trace written into prof/
        out = generate(...)

    with phase("prefill"):          # a named range in that trace (and NVTX)
        ...

``trace`` records the host's activity, and the card's (CUPTI) when one is
present, and writes a Chrome trace (``trace.json``, which TensorBoard's and
Perfetto's viewers read) plus ``key_averages.txt``, the table of ops and
kernels by total time. ``phase`` is a ``torch.profiler.record_function``
range, which a profile shows as a span, and on the card also an NVTX range.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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
def phase(name: str) -> Iterator[None]:
    """Name a region: a span of that name in a profile, an NVTX range on
    the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Lightweight wall-clock phase accounting for host loops."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[k]
            lines.append(f"{k}: total {self.totals[k]:.3f}s over {n} calls "
                         f"({1e3 * self.totals[k] / n:.2f} ms/call)")
        return "\n".join(lines)
