"""CPU tests of the benchmark's plumbing: the traffic generator, the
percentile and rate arithmetic, the bound and MFU arithmetic, the names in
BENCHMARK.json, and the import check.

    python3 -m pytest bench_port/tests -q
"""

import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import torch
import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))

from bplib import bounds, harness, spec, stats, traffic  # noqa: E402

TINY = BENCH_DIR / "tests" / "tiny.json"
CLIPS = BENCH_DIR / "traffic"


def _mixes():
    return sorted(p.stem for p in CLIPS.glob("*.json"))


@pytest.mark.parametrize("mix", _mixes())
def test_schedule_is_fixed_by_the_seed(mix):
    m = traffic.load(CLIPS / f"{mix}.json")
    a = traffic.schedule(m, 2 ** 31 + 11, 5.0, 3200)
    b = traffic.schedule(m, 2 ** 31 + 11, 5.0, 3200)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.due == y.due and x.frames == y.frames and x.seed == y.seed
        assert np.array_equal(x.input_ids, y.input_ids)
        assert all(np.array_equal(u, v) for u, v in zip(x.voices, y.voices))


@pytest.mark.parametrize("mix", _mixes())
def test_every_seed_sends_the_same_work(mix):
    """The seed draws the contents; the sizes and arrivals are the mix's."""
    m = traffic.load(CLIPS / f"{mix}.json")
    a = traffic.schedule(m, 1, 10.0, 3200)
    b = traffic.schedule(m, 2, 10.0, 3200)
    shape = lambda rs: [(r.phase, r.due, r.frames, len(r.input_ids),
                         tuple(len(v) for v in r.voices)) for r in rs]
    assert shape(a) == shape(b)
    assert not np.array_equal(a[0].input_ids, b[0].input_ids)
    window = [r for r in a if r.phase == "window"]
    assert len(window) == round(m["rate_per_s"] * 10.0)
    assert 10.0 - 3 / m["rate_per_s"] < window[-1].due - window[0].due < 10.0


def test_layout_matches_the_processor():
    """The generator's prompt has the processor's structure: the voice
    placeholders are exactly the <speech_diffusion> slots, one a hop of
    each voice, between <speech_start> and <speech_end>, and the prompt
    ends with <speech_start>."""
    m = traffic.load(CLIPS / f"{_mixes()[0]}.json")
    r = traffic.schedule(m, 5, 3.0, 3200)[0]
    ids = r.input_ids
    assert ids[-1] == spec.SPEECH_START
    assert r.speech_mask.sum() == sum(math.ceil(len(v) / 3200) for v in r.voices)
    starts = np.flatnonzero(ids == spec.SPEECH_START)[:-1]
    ends = np.flatnonzero(ids == spec.SPEECH_END)
    for s, e, v in zip(starts, ends, r.voices):
        assert e - s - 1 == math.ceil(len(v) / 3200)
        assert r.speech_mask[s + 1: e].all()
    text = ids[~np.isin(ids, spec.CANDIDATES)]
    assert text.max() < spec.EOS


def test_percentile_counts_a_missing_request_above_every_value():
    assert stats.percentile([5.0, 1.0, 3.0, 2.0, 4.0], 50) == 3.0
    assert stats.percentile(list(range(1, 101)), 95) == 95
    vals = list(range(1, 20)) + [math.inf]
    assert stats.percentile(vals, 95) == 19
    assert stats.percentile(vals, 99) == math.inf
    assert stats.percentile([], 95) is None


def _run(served, window, m=None, give_up=None):
    m = m or spec.load(TINY)
    return harness.Run(m=m, window=window, give_up=give_up or window[1],
                       served=served, setup_s=12.5, frames_per_dispatch=2, max_batch=4,
                       prefills=[], occupancy=[])


class _Handle:
    def __init__(self, first):
        self.first_audio_time = first


def test_window_rate_and_tails():
    m = spec.load(TINY)
    req = traffic.Request(0.0, "window", np.zeros(3, np.int64), np.zeros(3, bool), [], 4, 0)
    # K = 2 chunks a window; a window's chunks may be read in two polls
    s1 = harness.Served(req, due=10.0, handle=_Handle(10.5),
                        chunk_times=[10.5, 10.5, 10.6, 10.601, 10.9, 10.9, 20.5])
    s2 = harness.Served(req, due=11.0, handle=_Handle(None))
    s3 = harness.Served(req, due=9.0, handle=_Handle(9.2), chunk_times=[9.2, 10.2, 10.25, 10.3])
    run = _run([s1, s2, s3], (10.0, 20.0), m, give_up=21.0)
    e = harness.e2e(run)
    # 9 chunks inside [10, 20), each a frame of hop samples
    assert e["audio_s_per_s"] == pytest.approx(9 * m.hop / 24_000 / 10.0)
    # s2 never had audio: the p95 of two requests is the missing one,
    # reported above every measured value
    assert e["ttfa_p95_ms"] == pytest.approx(11_000.0)
    # gaps between windows only: s1's windows arrive at 10.5, 10.601, 10.9
    # (its last, one chunk, at 20.5: outside), s3's at 10.2 and 10.3
    assert sorted(harness.window_gaps_ms(run)) == pytest.approx([100.0, 101.0, 299.0])
    assert e["gap_p99_ms"] == pytest.approx(299.0)
    assert e["setup_s"] == 12.5


def test_bound_arithmetic_at_a_tiny_configuration():
    m = spec.load(TINY)
    h, kvw, i, n = m.hidden, m.kv_heads * m.head_dim, m.inter, m.layers
    rows = 8
    nb, nf = bounds.lm_frame(m, rows)
    shapes = [(h, h), (h, kvw), (h, kvw), (h, h), (h, i), (h, i), (i, h)]
    assert nf == n * sum(2 * rows * a * b for a, b in shapes)
    assert nb == n * sum(a * b + 4 * b + 2 * rows * (a + b) for a, b in shapes)
    hb, hf = bounds.head_call(m, rows)
    hh, ff, hl = m.head_hidden, m.head_ffn, m.head_layers
    assert hf == 2 * rows * hl * (hh * 2 * ff + ff * hh)
    assert bounds.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert bounds.least_seconds(0, 989e12) == pytest.approx(1.0)


def test_coder_and_mfu_arithmetic_by_hand():
    c = spec.Coder(dims=(4, 8), ratios=(2,), depths=(1, 1), in_ch=1, out_ch=3, eps=1e-5,
                   std=0.01, gamma=1e-6)
    block = lambda d: 2 * d * 7 + 2 * 2 * d * 4 * d
    # encoder: stem over 2 samples, a block at 2, the down conv (k 4) to 1
    # sample, a block at 1, the head conv at 1
    enc = 2 * 2 * 4 * 1 * 7 + 2 * block(4) + 2 * 1 * 4 * 8 * 4 + block(8) + 2 * 1 * 8 * 3 * 7
    assert bounds.coder_flops(c, False) == enc
    # decoder: stem at 1 sample, a block, the transposed conv (k 4) from 1
    # sample to 2, a block at 2, the head conv at 2
    dec = 2 * 1 * 4 * 1 * 7 + block(4) + 2 * 1 * 4 * 8 * 4 + 2 * block(8) + 2 * 2 * 8 * 3 * 7
    assert bounds.coder_flops(c, True) == dec
    m = spec.load(TINY)
    one = bounds.served_flops(m, [(10, 0)], [])
    two = bounds.served_flops(m, [(10, 0), (10, 1)], [(10, 3)])
    assert two - one == bounds.frame_flops(m, 10, 1) + bounds.prompt_flops(m, 10, 3)
    # each further frame attends one more key in both CFG streams
    step = bounds.frame_flops(m, 10, 1) - bounds.frame_flops(m, 10, 0)
    assert step == pytest.approx(2 * m.layers * 4 * m.heads * m.head_dim)


def test_mfu_reader_over_the_window():
    m = spec.load(TINY)
    req = traffic.Request(0.0, "window", np.zeros(7, np.int64), np.zeros(7, bool), [], 4, 0)
    s = harness.Served(req, due=0.0, handle=_Handle(1.0), chunk_times=[1.0, 2.0, 30.0])
    run = _run([s], (0.0, 10.0), m)
    run.prefills = [(0.5, 0.9, 7, 2), (20.0, 21.0, 7, 2)]
    want = 100 * bounds.served_flops(m, [(7, 0), (7, 1)], [(7, 2)]) / bounds.BF16_FLOPS / 10.0
    assert harness.load_reader(ROOT, "mfu.serve")(run) == pytest.approx(want)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_names_units_and_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = []
    for c in b["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_port/")
        spec.load(ROOT / c["file"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for mt in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(mt["name"]) and UNIT.match(mt["unit"])
        assert mt["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{mt['name']}.py").is_file()
        names.append(mt["name"])
    for mt in b["per_layer"]:
        assert mt["moves"] in {e["name"] for e in b["end_to_end"]}
    for e in b["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert len(names) == len(set(names))
    assert "setup_s" in names


def test_nothing_imported_is_jax_or_the_jax_package():
    import run  # noqa: F401
    from bplib import reference, trace_read, weights  # noqa: F401

    for name in ("audio_s_per_s", "mfu.serve", "lm_linears_roofline", "step_mfu"):
        harness.load_reader(ROOT, name)
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                           if m.split(".")[0] != "vibevoice_tpu_torch"]
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                               "vibevoice_tpu")]


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vibevoice_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtools", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vibevoice_tpu.models", object())
    assert harness.forbidden_modules() == ["vibevoice_tpu.models"]


class _Engine:
    """The engine's internals as the benchmark's hooks know them."""

    frames_per_dispatch, max_batch = 2, 4

    def __init__(self, up0_shape=(4, 3, 8)):
        self.slots, self._retiring = [None] * 4, []
        self.carry = type("Carry", (), {"dec_state": {"up0": torch.zeros(up0_shape)}})()

    def _draw_noise(self): ...
    def _prefill(self, r): ...
    def _admit(self): ...
    def _dispatch(self, ext): ...
    def _process(self, fetched, snap): ...


def test_the_hooks_refuse_an_engine_they_do_not_know():
    harness.Recorder(_Engine(), latent=8)
    with pytest.raises(RuntimeError, match="up0"):
        harness.Recorder(_Engine((4, 3, 16)), latent=8)
    gone = _Engine()
    gone._admit = None  # the method renamed or moved away
    with pytest.raises(RuntimeError, match="_admit"):
        harness.Recorder(gone, latent=8)
