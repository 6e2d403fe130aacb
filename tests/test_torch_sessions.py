"""The port's multi-session StreamingSessionEngine (vibevoice_tpu_torch/
serving/streaming_sessions.py) on the tiny streaming config, on the CPU:
sessions against the JAX package's StreamingSessionEngine in inject mode on
the same presets, texts and noise banks (1e-5 of the peak), a live session
that parks on EOS and resumes against its batch-1 continuation, and the
engine's behaviour mirrored from tests/test_streaming_sessions.py.

The weights are tests/test_torch_streaming.py's (the JAX init randomised
with numpy, carried over by from_jax). EOS is held off (the classifier's
output bias at -30) wherever sessions end by max_new_frames, so that an
EOS probability near 0.5 cannot flip between the frameworks; the park test
sets the bias so that EOS fires at a chosen frame. Every wait has its own
bound (result(timeout=...), events), none sleeps and polls."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from vibevoice_tpu.models import streaming as jst
from vibevoice_tpu.models.inference import GenerateOptions as JOpts
from vibevoice_tpu.serving.streaming_sessions import StreamingSessionEngine as JaxEngine

from vibevoice_tpu_torch.models import streaming as tst
from vibevoice_tpu_torch.models.inference import GenerateOptions as TOpts
from vibevoice_tpu_torch.serving.streaming_sessions import StreamingSessionEngine
from vibevoice_tpu_torch.utils.params import from_jax

from test_torch_streaming import JCFG, TCFG, VAE, HEAD_DIM, _randomize, _with_eos_bias

HOP = TCFG.acoustic_tokenizer_config.hop_length
MAX_LEN = 256
TOL = 1e-5  # of the peak
# int8 KV against the JAX package: a K/V element that lies within f32
# rounding of an int8 level's edge quantizes to neighbouring levels in the
# two frameworks. Their solo generate() runs of SESSIONS differ by up to
# 3.6e-5 of the peak at int8 KV (4e-7 at f32 caches), so sessions are held
# to the JAX package at 1e-4 there and to the port's own solo runs at TOL.
TOL_INT8_JAX = 1e-4
TIMEOUT = 120
STEPS = 3  # DPM-Solver steps


def _opts(kv_int8=False):
    return dict(cfg_scale=1.5, ddpm_steps=STEPS, kv_int8=kv_int8)


@pytest.fixture(scope="module")
def models():
    """tests/test_torch_streaming.py's weights: _randomize draws from the
    tree's shapes alone, so the JAX init's shapes stand in for it (its two
    scalars at their init values, 1 and 0)."""
    shapes = jax.eval_shape(lambda: jst.init(jax.random.PRNGKey(0), JCFG))
    shapes = {**shapes, "speech_scaling_factor": jax.numpy.float32(1.0),
              "speech_bias_factor": jax.numpy.float32(0.0)}
    jp = _randomize(shapes, 1)
    tp = from_jax(jax.tree.map(np.asarray, jp), TCFG, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def quiet(models):
    """Both trees with EOS held off."""
    return tuple(_with_eos_bias(t, -30.0) for t in models)


@pytest.fixture(scope="module")
def presets(models):
    """Two voices of different prompt lengths: the port's presets, and the
    JAX package's VoicePreset of the same arrays."""
    _, tp = models
    out = []
    for seed, n in ((0, 12), (1, 19)):
        prompt = np.random.RandomState(seed).randint(10, 200, (1, n))
        tpre = tst.build_voice_preset(TCFG, tp, prompt, neg_prompt_id=3, max_len=MAX_LEN)
        out.append((jst.VoicePreset(**{f.name: getattr(tpre, f.name)
                                       for f in dataclasses.fields(tst.VoicePreset)}), tpre))
    return out


def _bank(seed, n_frames=60):
    return {"init": np.random.RandomState(seed).randn(n_frames, 1, VAE).astype(np.float32)}


def _text(seed, n):
    return np.random.RandomState(seed).randint(10, 200, (n,))


def _close(got, want, what, tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert peak > 0 and err <= tol * peak, f"{what}: {err:.3e} of peak {peak:.3e}"


# (text seed, length, voice, bank seed, max_new_frames)
SESSIONS = [(2, 9, 0, 10, 12), (3, 14, 1, 11, 18), (4, 7, 0, 12, 12), (5, 11, 1, 13, 6)]


def _run_sessions(engine, presets, side):
    """Submit SESSIONS to a 3-slot engine: two at once, two more after the
    first session's first frame (the last queues for a slot); every
    session's audio."""
    def submit(i):
        ts, n, voice, bs, frames = SESSIONS[i]
        return engine.submit(_text(ts, n), presets[voice][side], noise_bank=_bank(bs),
                             max_new_frames=frames)

    handles = [submit(0), submit(1)]
    first = handles[0].frames(timeout=TIMEOUT)
    head = [next(first)]
    handles += [submit(2), submit(3)]
    audio = [np.concatenate(head + list(first))]
    audio += [h.result(timeout=TIMEOUT) for h in handles[1:]]
    return audio, handles


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("quantum", [3, 6])
def test_sessions_match_jax(quiet, presets, quantum, kv_int8):
    """Four sessions (two voices) over three slots, staggered and queued,
    through the port's engine and the JAX package's, in inject mode with
    the same banks: every session's audio within 1e-5 of the peak, the same
    frame counts (its max_new_frames rounded up to the quantum), and stats
    counting them."""
    jp, tp = quiet
    outs = []
    for side, (cls, cfg, params, opts) in enumerate((
            (JaxEngine, JCFG, jp, JOpts(**_opts(kv_int8))),
            (StreamingSessionEngine, TCFG, tp, TOpts(**_opts(kv_int8))))):
        eng = cls(cfg, params, n_slots=3, max_len=MAX_LEN, opts=opts, inject=True,
                  quantum=quantum)
        try:
            outs.append(_run_sessions(eng, presets, side))
        finally:
            eng.shutdown(drain=False)
    (want, _), (got, handles) = outs
    for i, (g, w) in enumerate(zip(got, want)):
        frames = -(-SESSIONS[i][4] // quantum) * quantum
        assert len(w) == len(g) == frames * HOP, (i, len(w), len(g))
        _close(g, w, f"session {i} against JAX", TOL_INT8_JAX if kv_int8 else TOL)
        if kv_int8:
            ts, n, voice, bs, _ = SESSIONS[i]
            solo = tst.generate(TCFG, tp, tts_text_ids=_text(ts, n)[None],
                                preset=presets[voice][1], opts=TOpts(**_opts(True)),
                                max_len=MAX_LEN, noise_bank=_bank(bs), seed=0,
                                stop_check_fn=iter([False] * (frames // 6 + 1) + [True]).__next__)
            _close(g, solo.speech_outputs[0][: len(g)], f"session {i} against its solo run")
    st = eng.stats()
    assert st["submitted"] == st["completed"] == 4
    assert st["frames_emitted"] == sum(len(g) for g in got) // HOP
    assert all(h.reach_max_step and h.ttfa_ms is not None for h in handles)


# ---------------------------------------------------------------------------
# a live session parks on EOS and resumes
# ---------------------------------------------------------------------------


def _continuation(tp, preset, text1, text2, bank, quantum, max_frames):
    """The batch-1 run a live session must equal: text1's window, quanta
    until the first EOS frame (kept), then, with the session's finished
    flag cleared, text2's windows and quanta until the next EOS or
    max_frames is reached at a quantum's start, as max_new_frames stops a
    session. Returns (frames, EOS logits of every computed frame, the frame
    count at the park or None)."""
    text_fn, session_fn = tst.make_session_fns(TCFG, TOpts(**_opts()), quantum=quantum)
    state = tst.admit_session(tst.init_session_state(TCFG, tp, 1, MAX_LEN), 0,
                              **tst.preset_admit_arrays(preset, HEAD_DIM, max_len=MAX_LEN))
    text, pos, cycle, counter = np.asarray(text1), 0, 0, 0
    frames, logits, parked_at = [], [], None
    active = torch.tensor([True])
    while len(frames) < max_frames:
        if cycle == 0 and pos < text.size:
            chunk = text[pos: pos + 5]
            ids, valid = np.zeros((1, 5), np.int64), np.zeros((1, 5), bool)
            ids[0, : chunk.size], valid[0, : chunk.size] = chunk, True
            pos += chunk.size
            state = text_fn(tp, state, torch.from_numpy(ids), torch.from_numpy(valid))
        init = torch.from_numpy(bank["init"][counter: counter + quantum])
        state, audio, eos = session_fn(tp, state, active, tst.inf.FrameNoise(init, None, None))
        counter += quantum
        cycle = (cycle + quantum) % 6
        p = eos[:, 0].double().numpy()
        logits += list(np.log(p) - np.log1p(-p))
        hit = np.nonzero(p > 0.5)[0]
        keep = int(hit[0]) + 1 if hit.size else quantum
        frames += [audio[f, 0, :, 0].float().numpy() for f in range(keep)]
        if hit.size:
            if parked_at is not None:
                break  # the stream is closed: the session ends
            parked_at, cycle = len(frames), 0
            text, pos = np.concatenate([text1, text2]), len(text1)
            state = tst.clear_finished(state, 0)
    return frames, np.asarray(logits), parked_at


def _park_case(models, preset, quantum):
    """The EOS bias and bank with which a 5-token live session parks after
    3 to 8 frames and speaks 3 frames or more after it resumes: the bias
    sits between the largest EOS logit of the frames before the chosen
    frame and that frame's (the first bank seed from 40 that allows it)."""
    _, tp = models
    text1, text2 = _text(50, 5), _text(51, 9)
    for seed in range(40, 60):
        bank = _bank(seed, 90)
        _, z, _ = _continuation(_with_eos_bias(tp, -30.0), preset, text1, text2, bank, quantum, 9)
        z = z[:9] + 30.0
        p = 2 + int(np.argmax(z[2:8]))
        below = float(z[:p].max())
        if z[p] - below < 1e-3:
            continue
        bias = -(z[p] + below) / 2
        frames, _, parked_at = _continuation(_with_eos_bias(tp, bias), preset, text1, text2,
                                             bank, quantum, 30)
        if parked_at == p + 1 and len(frames) >= parked_at + 3:
            return bias, bank, text1, text2, frames, parked_at
    pytest.fail("no bank seed parks the session where the test needs it")


@pytest.mark.parametrize("quantum", [3, 6])
def test_parked_live_session_resumes_as_its_continuation(models, presets, quantum):
    """A live session (5 tokens) parks at its EOS frame; append_text (9
    tokens) and end_text resume it. Its audio equals the batch-1
    continuation with the finished flag cleared (1e-5 of the peak), frames
    after the resume included: with the flag left set, as the JAX engine
    leaves it, those frames would come from a frozen hidden state. At the
    park its steps count the committed frames only (the text and the frames
    through EOS), not whole quanta."""
    _, preset = presets[0]
    bias, bank, text1, text2, want, parked_at = _park_case(models, preset, quantum)
    tp = _with_eos_bias(models[1], bias)
    eng = StreamingSessionEngine(TCFG, tp, n_slots=2, max_len=MAX_LEN, opts=TOpts(**_opts()),
                                 inject=True, quantum=quantum)
    try:
        h = eng.submit(text1, preset, noise_bank=bank, live=True, max_new_frames=30)
        assert h.parked.wait(TIMEOUT), "the session never parked"
        slot = next(s for s in eng.slots if s is not None)
        assert h.n_frames == parked_at and slot.steps == len(text1) + parked_at
        assert eng.stats()["parked"] == 1
        h.append_text(text2)
        h.end_text()
        got = h.result(timeout=TIMEOUT)
    finally:
        eng.shutdown(drain=False)
    assert h.error is None and h.rec["outcome"] == "completed"
    assert len(got) == len(want) * HOP and len(want) >= parked_at + 3
    _close(got, np.concatenate(want), "resumed session")


# ---------------------------------------------------------------------------
# behaviour (tests/test_streaming_sessions.py's, on the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine(quiet):
    _, tp = quiet
    eng = StreamingSessionEngine(TCFG, tp, n_slots=2, max_len=MAX_LEN, opts=TOpts(**_opts()),
                                 inject=True)
    yield eng
    eng.shutdown(drain=False)


def test_live_full_text_session_matches_its_solo_run(engine, quiet, presets):
    """A live session whose text is all there (submit, then end_text) and a
    plain one give the first frames of streaming.generate() with the same
    bank (1e-5 of the peak)."""
    _, tp = quiet
    _, preset = presets[1]
    text, bank = _text(60, 11), _bank(61)
    solo = tst.generate(TCFG, tp, tts_text_ids=text[None], preset=preset,
                        opts=TOpts(**_opts()), max_len=MAX_LEN, noise_bank=bank,
                        stop_check_fn=iter([False] * 3 + [True]).__next__)
    want = solo.speech_outputs[0][: 15 * HOP]
    for live in (True, False):
        h = engine.submit(text, preset, noise_bank=bank, live=live, max_new_frames=15)
        if live:
            h.end_text()
        _close(h.result(timeout=TIMEOUT), want, f"live={live}")


def test_queueing_cancel_and_frame_caps(engine, presets):
    """Three sessions over two slots: the third queues and runs when a slot
    frees; a cancelled session ends early as cancelled and frees its slot;
    max_new_frames caps at the quantum that reaches it."""
    _, preset = presets[0]
    long = engine.submit(_text(70, 30), preset, noise_bank=_bank(70), max_new_frames=48)
    frames = long.frames(timeout=TIMEOUT)
    next(frames)
    short = engine.submit(_text(71, 6), preset, noise_bank=_bank(71), max_new_frames=6)
    queued = engine.submit(_text(72, 6), preset, noise_bank=_bank(72), max_new_frames=7)
    long.cancel()
    rest = list(frames)
    assert len(rest) + 1 < 48 and long.rec["outcome"] == "cancelled"
    assert len(short.result(timeout=TIMEOUT)) == 6 * HOP
    assert len(queued.result(timeout=TIMEOUT)) == 9 * HOP  # 7 rounded up to quanta of 3
    assert queued.reach_max_step and queued.rec["outcome"] == "completed"


def test_capacity_stop(quiet, presets):
    """A session whose cache cannot take the next text + speech window
    retires with reach_max_step, as generate()'s capacity stop does."""
    _, tp = quiet
    _, preset = presets[0]
    tts_len = int(np.asarray(preset.tts_kv[2]).reshape(-1)[0])
    max_len = tts_len + 5 + 6 + 5 + 6 + 3  # two windows fit, a third does not
    eng = StreamingSessionEngine(TCFG, tp, n_slots=1, max_len=max_len, opts=TOpts(**_opts()),
                                 inject=True)
    try:
        h = eng.submit(_text(80, 30), preset, noise_bank=_bank(80))
        assert len(h.result(timeout=TIMEOUT)) == 12 * HOP and h.reach_max_step
    finally:
        eng.shutdown(drain=False)


def test_priority_express_slot(quiet, presets, monkeypatch):
    """reserved_slots=1: bulk sessions never take slot 0; a priority one
    does (every admission is recorded with its slot)."""
    _, tp = quiet
    (_, preset), (_, other) = presets  # the priority session speaks with the other voice
    eng = StreamingSessionEngine(TCFG, tp, n_slots=2, max_len=MAX_LEN, opts=TOpts(**_opts()),
                                 inject=True, reserved_slots=1)
    admitted = []  # (slot, the preset's TTS length): which voice took which slot
    real = tst.admit_session

    def recording_admit(state, slot, **kw):
        admitted.append((int(slot), kw["tts_len"]))
        return real(state, slot, **kw)

    monkeypatch.setattr(tst, "admit_session", recording_admit)
    try:
        bulk = [eng.submit(_text(90 + i, 8), preset, noise_bank=_bank(90 + i),
                           max_new_frames=30) for i in range(2)]
        frames = bulk[0].frames(timeout=TIMEOUT)
        next(frames)
        pr = eng.submit(_text(95, 8), other, noise_bank=_bank(95), max_new_frames=6,
                        priority=True)
        assert len(pr.result(timeout=TIMEOUT)) == 6 * HOP
        assert 1 + len(list(frames)) == 30 and len(bulk[1].result(timeout=TIMEOUT)) == 30 * HOP
    finally:
        eng.shutdown(drain=False)
    bulk_len, pr_len = (int(np.asarray(p.tts_kv[2]).reshape(-1)[0]) for p in (preset, other))
    assert sorted(admitted) == sorted([(1, bulk_len), (1, bulk_len), (0, pr_len)])


@pytest.mark.parametrize("kw, match", [(dict(reserved_slots=2), "reserved_slots"),
                                       (dict(quantum=4), "quantum")])
def test_engine_refuses(quiet, kw, match):
    with pytest.raises(ValueError, match=match):
        StreamingSessionEngine(TCFG, quiet[1], n_slots=2, max_len=MAX_LEN,
                               opts=TOpts(**_opts()), **kw)


def test_live_append_validation_and_drain(quiet, presets):
    """append_text refuses a session that is not live and one whose stream
    closed; shutdown(drain=True) closes a parked live session's stream, so
    it completes at once instead of holding the drain."""
    _, tp = quiet
    _, preset = presets[0]
    loud = _with_eos_bias(tp, 30.0)  # EOS at the first frame: parks at once
    eng = StreamingSessionEngine(TCFG, loud, n_slots=1, max_len=MAX_LEN, opts=TOpts(**_opts()),
                                 inject=True)
    h0 = eng.submit(_text(100, 4), preset, noise_bank=_bank(100))
    with pytest.raises(RuntimeError, match="non-live"):
        h0.append_text(np.array([1, 2]))
    assert len(h0.result(timeout=TIMEOUT)) == HOP  # the EOS frame, then retired
    h1 = eng.submit(_text(101, 4), preset, noise_bank=_bank(101), live=True)
    assert h1.parked.wait(TIMEOUT)
    eng.shutdown(drain=True, timeout=TIMEOUT)
    assert h1.done.is_set() and h1.error is None and h1.rec["outcome"] == "completed"
    with pytest.raises(RuntimeError, match="end_text"):
        h1.append_text(np.array([1, 2]))
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit(_text(102, 4), preset, noise_bank=_bank(102))


def test_warmup_stays_out_of_stats(quiet, presets):
    """warmup() runs one short session of the default preset (inject mode
    on zero draws) and leaves no record in stats()."""
    _, tp = quiet
    _, preset = presets[0]
    eng = StreamingSessionEngine(TCFG, tp, n_slots=2, max_len=MAX_LEN, opts=TOpts(**_opts()),
                                 inject=True, default_preset=preset)
    try:
        assert eng.warmup(frames=3, timeout=TIMEOUT) > 0
        st = eng.stats()
        assert st["submitted"] == 0 and st["frames_emitted"] == 0 and eng.windows_run >= 1
    finally:
        eng.shutdown(drain=False)


def test_drawn_noise_and_ignore_eos(quiet, presets):
    """Without inject the engine draws each quantum's noise from its seed:
    one seed gives the same audio twice, another other audio. ignore_eos
    keeps a session going through its EOS frames (bias +30: EOS at every
    frame) up to max_new_frames, one committed frame a quantum."""
    jp, tp = quiet
    _, preset = presets[0]
    audio = []
    for seed in (1, 1, 2):
        eng = StreamingSessionEngine(TCFG, tp, n_slots=2, max_len=MAX_LEN, opts=TOpts(**_opts()),
                                     seed=seed)
        try:
            audio.append(eng.submit(_text(110, 8), preset, max_new_frames=9).result(TIMEOUT))
        finally:
            eng.shutdown(drain=False)
    np.testing.assert_array_equal(audio[0], audio[1])
    assert audio[0].shape == audio[2].shape and np.abs(audio[0] - audio[2]).max() > 0
    eng = StreamingSessionEngine(TCFG, _with_eos_bias(tp, 30.0), n_slots=1, max_len=MAX_LEN,
                                 opts=TOpts(**_opts()), ignore_eos=True)
    try:
        h = eng.submit(_text(111, 8), preset, max_new_frames=4)
        assert len(h.result(TIMEOUT)) == 4 * HOP and h.rec["outcome"] == "completed"
    finally:
        eng.shutdown(drain=False)
