"""The port's recorder of spans (vibevoice_tpu_torch/utils/profiling.py)
and the spans the serving engine records into it, on the CPU at the tiny
config: three requests served by a 2-slot engine, each with its stage
spans under its request id and its vv.request root, the stages adding up
to its time to first audio; the decode loop's window spans and its slot
occupancy; the recorder's bound, and no state left by threads that end;
phase() without and with a profile, whose event lands on its recorder
span once shifted by trace_clock_offset_ns()."""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.models import inference as inf
from vibevoice_tpu_torch.serving import Request, ServingEngine
from vibevoice_tpu_torch.utils import profiling
from vibevoice_tpu_torch.utils.params import init, speaking

CFG = tiny_config()
TOK = inf.SpecialTokens(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
STAGES = ("vv.queue", "vv.prefill", "vv.ready", "vv.join", "vv.first_window")
PREFILL_PHASES = ("vv.prefill.voice", "vv.prefill.negative", "vv.prefill.lm",
                  "vv.prefill.combine")
TIMEOUT = 120


def _request(seed, n):
    ids = np.random.RandomState(seed).randint(10, 100, (1, n)).astype(np.int64)
    ids[0, -1] = TOK.speech_start
    return Request(input_ids=ids, valid_mask=np.ones((1, n), bool), seed=seed)


@pytest.fixture(scope="module")
def served():
    """Three requests through a 2-slot engine (one waits for a slot), the
    engine's decode thread and the engine."""
    params = speaking(init(CFG, seed=0, device="cpu"), TOK, alpha=10.0, beta=10.0)
    eng = ServingEngine(CFG, params, tokens=TOK, max_batch=2, max_len=96,
                        opts=inf.GenerateOptions(ddpm_steps=2, max_length=96))
    try:
        handles = [eng.submit(_request(30 + i, 6 + 2 * i)) for i in range(3)]
        for h in handles:
            h.result(timeout=TIMEOUT)
    finally:
        eng.shutdown()
    return handles, eng._thread.native_id, eng


def _of(rid):
    return [s for s in profiling.spans() if s.rid == rid]


def test_every_request_has_its_stage_spans(served):
    handles, *_ = served
    for h in handles:
        mine = _of(h.rid)
        roots = [s for s in mine if s.name == "vv.request"]
        assert len(roots) == 1 and roots[0].sid == h.sid and roots[0].parent is None
        for name in STAGES:
            got = [s for s in mine if s.name == name]
            assert len(got) == 1, (name, got)
            assert got[0].parent == h.sid and got[0].t0 <= got[0].t1
        prefill = next(s for s in mine if s.name == "vv.prefill")
        for name in PREFILL_PHASES:
            got = [s for s in mine if s.name == name]
            assert len(got) == 1 and got[0].parent == prefill.sid, (name, got)
            assert prefill.t0 <= got[0].t0 <= got[0].t1 <= prefill.t1


def test_stage_spans_add_up_to_the_time_to_first_audio(served):
    handles, *_ = served
    for h in handles:
        stages = sorted((s for s in _of(h.rid) if s.name in STAGES), key=lambda s: s.t0)
        assert [s.name for s in stages] == list(STAGES)
        for a, b in zip(stages, stages[1:]):
            assert a.t1 == b.t0  # one stage ends where the next starts
        total_s = sum(s.t1 - s.t0 for s in stages) * 1e-9
        assert abs(total_s - (h.first_audio_time - h.submit_time)) < 1e-3
        assert stages[0].t0 == h.submit_ns
        rec = h.rec
        assert rec["queue_ms"] == pytest.approx((stages[0].t1 - stages[0].t0) * 1e-6)
        assert rec["prefill_ms"] == pytest.approx((stages[1].t1 - stages[1].t0) * 1e-6)
        assert rec["join_wait_ms"] == pytest.approx((stages[2].t1 - stages[2].t0) * 1e-6)


def test_window_spans_and_slot_occupancy(served):
    handles, thread, eng = served
    mine = [s for s in profiling.spans() if s.thread == thread]
    joins = [s for s in mine if s.name == "vv.join"]
    assert sorted(s.rid for s in joins) == sorted(h.rid for h in handles)
    dispatch = [s for s in mine if s.name == "vv.window.dispatch"]
    process = [s for s in mine if s.name == "vv.window.process"]
    assert eng._windows == len(dispatch) > 0
    assert len(dispatch) <= eng._window_slots <= eng.max_batch * len(dispatch)
    occupancy = eng.stats().window_occupancy_pct
    assert occupancy == pytest.approx(100.0 * eng._window_slots / (2 * len(dispatch)))
    assert 50.0 <= occupancy <= 100.0
    # every window is delivered once, under its dispatch's id, after it
    assert sorted(s.parent for s in process) == sorted(s.sid for s in dispatch)
    by_sid = {s.sid: s for s in dispatch}
    assert all(by_sid[p.parent].t1 <= p.t0 for p in process)
    waits = [s for s in mine if s.name == "vv.window.wait"]
    assert sorted(s.parent for s in waits) == sorted(s.sid for s in process)
    assert len([s for s in mine if s.name == "vv.window.admit"]) >= len(dispatch)
    assert any(s.name == "vv.window.idle" for s in mine)


def test_stats_give_the_stage_percentiles(served):
    handles, _, eng = served
    st = eng.stats()
    for key, name in (("queue_ms", "queue_wait"), ("prefill_ms", "prefill"),
                      ("join_wait_ms", "join_wait")):
        vals = sorted(h.rec[key] for h in handles)
        assert getattr(st, f"{name}_p50_ms") == vals[1]
        assert getattr(st, f"{name}_p95_ms") == vals[2]
    assert st.captures == eng.step_fn.captures == 0  # CPU windows run eagerly


def test_the_recorder_holds_at_most_its_bound():
    assert profiling.RECORDER._spans.maxlen == profiling.CAPACITY
    rec = profiling.Recorder(capacity=8)
    for i in range(20):
        rec.record("x", i, i + 1, rid=i)
    held = rec.spans()
    assert len(held) == 8 and [s.rid for s in held] == list(range(12, 20))
    assert [s.rid for s in rec.spans(since_ns=18)] == [17, 18, 19]


def test_threads_that_end_leave_no_state():
    """A server starts a thread a connection: what the recorder keeps for a
    thread goes with it, and a submit on the caller's thread keeps none."""
    rec = profiling.Recorder()
    states, kept = [], []

    def work(i):
        with rec.span("conn", rid=i):
            rec.record("inner", 0, 1)
        states.append(weakref.ref(rec._local.th))
        from vibevoice_tpu_torch.serving.engine import RequestHandle
        RequestHandle(_request(i, 4))
        kept.append(hasattr(profiling.RECORDER._local, "th"))

    for i in range(32):
        t = threading.Thread(target=work, args=(i,))
        t.start()
        t.join()
    gc.collect()
    assert len(states) == 32 and all(ref() is None for ref in states)
    assert kept == [False] * 32
    assert len(rec.spans()) == 64 and vars(rec).keys() == {"_spans", "_ids", "_local"}


def test_spans_nest_on_a_thread():
    rec = profiling.Recorder()
    with rec.span("outer", rid=3) as outer:
        with rec.span("inner") as inner:
            pass
        with rec.span("other", rid=4, parent=99):
            pass
    got = {s.name: s for s in rec.spans()}
    assert got["inner"].parent == outer.sid and got["inner"].rid == 3
    assert got["other"].parent == 99 and got["other"].rid == 4
    assert got["outer"].parent is None and got["outer"].t0 <= inner.t0 <= got["outer"].t1


def test_phase_calls_no_record_function_without_a_profile(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "record_function", lambda name: calls.append(name))
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.phase("vv.test.quiet") as sp:
        torch.ones(4) + 1
    assert calls == []
    assert any(s.name == "vv.test.quiet" and s.sid == sp.sid for s in profiling.spans())


def test_phase_event_lands_on_its_span_in_a_profile():
    with torch.autograd.profiler.profile(use_kineto=True) as p:
        with profiling.phase("vv.test.warm"):
            torch.ones(8) + 1
        with profiling.phase("vv.test.phase") as sp:
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = [e for e in p.kineto_results.events() if e.name() == "vv.test.phase"]
    assert len(events) == 1
    offset = profiling.trace_clock_offset_ns()
    e = events[0]
    assert abs(e.start_ns() - (sp.t0 + offset)) < 1_000_000
    assert abs(e.start_ns() + e.duration_ns() - (sp.t1 + offset)) < 1_000_000
