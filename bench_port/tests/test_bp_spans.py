"""The readers of the program's own spans (``bplib/spans.py``,
``metrics/prefill_host_bound_pct.py``, ``decode_idle_pct.py``) on a ``Run`` with
spans put into a fresh recorder and a hand-built ``Trace``, each value
computed by hand; and None, without raising, from a program without the
recorder.

    python3 -m pytest bench_port/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT))

from bplib import harness, spec, spans, trace_read  # noqa: E402
from vibevoice_tpu_torch.utils import profiling  # noqa: E402

TINY = BENCH_DIR / "tests" / "tiny.json"
OFFSET = 1_700_000_000_000_000_000  # the profile's clock minus the recorder's
S = 1_000_000_000  # ns a second
MS = 1_000_000
DECODE, PREFILL = 7, 13  # streams
READERS = ("prefill_host_bound_pct", "decode_idle_pct")


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the program's place, on a fixed clock offset."""
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    monkeypatch.setattr(profiling, "trace_clock_offset_ns", lambda: OFFSET)
    return r


def _trace(device):
    """A profile whose frame step ran on stream DECODE (one graph launch
    there) and whose other operations are ``device``: (start, end, stream)
    in the recorder's clock."""
    launch = ("cudaGraphLaunch", 10 * S + OFFSET, 1000, 1, 99)
    ops = [("graph op", 10 * S + OFFSET, 1000, DECODE, 99)]
    ops += [("op", a + OFFSET, b - a, st, i) for i, (a, b, st) in enumerate(device)]
    return trace_read.Trace(device=ops, runtime=[launch], host=[],
                            t0=10 * S + OFFSET, t1=11 * S + OFFSET)


def _run(trace=None):
    return harness.Run(m=spec.load(TINY), window=(0.0, 10.0), give_up=10.0, served=[],
                       setup_s=1.0, frames_per_dispatch=2, max_batch=4, prefills=[],
                       occupancy=[], trace=trace, trace_span=(10.0, 11.0))


def read(name, run):
    return harness.load_reader(ROOT, name)(run)


def test_prefill_host_bound_share(rec):
    # one prefill over 10.2-10.6 s (400 ms); the prefill stream busy 10.30-10.35
    # and 10.50-10.60 (twice, overlapping), a frame-step op inside it too
    rec.record("vv.prefill", 10 * S + 200 * MS, 10 * S + 600 * MS, rid=1)
    trace = _trace([(10 * S + 300 * MS, 10 * S + 350 * MS, PREFILL),
                    (10 * S + 500 * MS, 10 * S + 600 * MS, PREFILL),
                    (10 * S + 520 * MS, 10 * S + 580 * MS, PREFILL),
                    (10 * S + 210 * MS, 10 * S + 290 * MS, DECODE)])
    # 150 of 400 ms with prefill work on the card: 250 ms on the host
    assert read("prefill_host_bound_pct", _run(trace)) == pytest.approx(62.5)


def test_prefill_host_bound_needs_half_a_prefill(rec):
    # 10.9-11.9 s: 100 of its 1000 ms inside the profile
    rec.record("vv.prefill", 10 * S + 900 * MS, 11 * S + 900 * MS, rid=1)
    trace = _trace([(10 * S + 950 * MS, 10 * S + 960 * MS, PREFILL)])
    assert read("prefill_host_bound_pct", _run(trace)) is None
    # a second prefill wholly inside: 1.1 prefills covered, one clipped
    rec.record("vv.prefill", 10 * S + 100 * MS, 10 * S + 200 * MS, rid=2)
    # 200 ms of prefill wall, 10 ms of it busy on the prefill stream
    assert read("prefill_host_bound_pct", _run(trace)) == pytest.approx(95.0)


def test_decode_idle_share_while_windows_are_in_flight(rec):
    d1 = rec.record("vv.window.dispatch", 10 * S + 100 * MS, 10 * S + 102 * MS)
    d2 = rec.record("vv.window.dispatch", 10 * S + 150 * MS, 10 * S + 152 * MS)
    rec.record("vv.window.process", 10 * S + 160 * MS, 10 * S + 170 * MS, parent=d1)
    rec.record("vv.window.process", 10 * S + 240 * MS, 10 * S + 250 * MS, parent=d2)
    # a window before the profile, a stray process and an idle stretch: not counted
    d0 = rec.record("vv.window.dispatch", 9 * S, 9 * S + MS)
    rec.record("vv.window.process", 9 * S + 50 * MS, 9 * S + 60 * MS, parent=d0)
    rec.record("vv.window.process", 10 * S + 600 * MS, 10 * S + 700 * MS, parent=12345)
    rec.record("vv.window.idle", 10 * S + 300 * MS, 10 * S + 900 * MS)
    # in flight 10.10-10.25 s (150 ms); the card busy 10.10-10.20 on any
    # stream and 10.30-10.40 (outside): 50 ms idle
    trace = _trace([(10 * S + 100 * MS, 10 * S + 160 * MS, DECODE),
                    (10 * S + 140 * MS, 10 * S + 200 * MS, PREFILL),
                    (10 * S + 300 * MS, 10 * S + 400 * MS, DECODE)])
    assert read("decode_idle_pct", _run(trace)) == pytest.approx(100.0 * 50 / 150)


def test_a_program_without_the_recorder_reads_nothing(rec, monkeypatch):
    rec.record("vv.prefill", 10 * S + 200 * MS, 10 * S + 600 * MS, rid=1)
    d = rec.record("vv.window.dispatch", 10 * S + 100 * MS, 10 * S + 102 * MS)
    rec.record("vv.window.process", 10 * S + 160 * MS, 10 * S + 170 * MS, parent=d)
    trace = _trace([(10 * S + 300 * MS, 10 * S + 350 * MS, PREFILL)])
    run = _run(trace)
    assert all(read(name, run) is not None for name in READERS)
    # a profiling module without the recorder
    monkeypatch.delattr(profiling, "spans")
    assert all(read(name, run) is None for name in READERS)
    # and an untraced run has no profile
    assert read("decode_idle_pct", _run()) is None


def test_interval_arithmetic():
    assert spans.union([(5, 7), (1, 3), (2, 4), (7, 8), (9, 9)]) == [(1, 4), (5, 8)]
    assert spans.length([(1, 4), (5, 8)]) == 6
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25), (28, 40)]) == 5 + 5 + 2
