"""The port's continuous-batching ServingEngine (vibevoice_tpu_torch/serving/
engine.py) on the tiny config, on the CPU: join_slot against the JAX
package's _join_slot (a copy: bit-equal), a batched request against its
solo generate() run on the same noise rows (tokens equal, audio within 1e-4
of the peak), the engine's carry kept across windows and joins, and the
engine's behaviour mirrored from tests/test_serving.py (cancel, deadline,
priority, crash drains, drain, warmup).

Random tiny weights choose <speech_start> at every frame, so the engine
tests run utils.params.speaking's copy of the weights: one hidden
dimension held at a constant through the layers, which the LM head reads
to favour <speech_diffusion> over EOS. Greedy, every frame diffuses and a
request ends at its frame cap; sampled (do_sample), the tokens mix speech,
<speech_end> and <speech_start> frames.

Every wait has its own bound and waits on the engine's state (wait_for_state,
result(timeout=...)), never on a sleep."""

import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.serving.engine import _join_slot as jax_join_slot

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.models import inference as inf
from vibevoice_tpu_torch.models import qwen2 as tq
from vibevoice_tpu_torch.models import vibevoice as tvv
from vibevoice_tpu_torch.serving import Request, ServingEngine
from vibevoice_tpu_torch.serving.engine import join_slot
from vibevoice_tpu_torch.utils.params import init
from vibevoice_tpu_torch.utils.params import speaking as params_speaking

CFG = tiny_config()
HOP = CFG.acoustic_tokenizer_config.hop_length
VAE = CFG.acoustic_vae_dim
TOK = inf.SpecialTokens(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
MAX_LEN = 128
TIMEOUT = 120


def speaking(params, alpha: float, beta: float):
    """utils.params.speaking's weights, with the vocoder's and the semantic
    encoder's layer scales at 0.3, so that their blocks work."""
    p = params_speaking(params, TOK, alpha=alpha, beta=beta)
    for name, part in (("acoustic_tokenizer", "decoder"), ("semantic_tokenizer", "encoder")):
        tree = inf._tree_map(lambda t: t.clone(), p[name][part])
        for blk in (b for stage in tree["stages"] for b in stage):
            blk["gamma"].fill_(0.3)
            blk["ffn_gamma"].fill_(0.3)
        p[name] = {**p[name], part: tree}
    return p


@pytest.fixture(scope="module")
def greedy():
    """Weights whose greedy choice is <speech_diffusion> at every frame."""
    return speaking(init(CFG, seed=0, device="cpu"), alpha=10.0, beta=10.0)


@pytest.fixture(scope="module")
def mixed():
    """Weights whose sampled choice mixes speech, end and start frames."""
    return speaking(init(CFG, seed=0, device="cpu"), alpha=0.2, beta=2.0)


def _request(seed, n=10, **kw):
    ids = np.random.RandomState(seed).randint(10, 100, (1, n)).astype(np.int64)
    ids[0, -1] = TOK.speech_start
    return Request(input_ids=ids, valid_mask=np.ones((1, n), bool), seed=seed, **kw)


def _engine(params, **kw):
    kw = {"max_batch": 2, "max_len": MAX_LEN, **kw}
    opts = kw.pop("opts", inf.GenerateOptions(ddpm_steps=2, max_length=kw["max_len"]))
    return ServingEngine(CFG, params, tokens=TOK, opts=opts, **kw)


def _cap(n, max_len=MAX_LEN, times=2.0):
    return min(max_len - n, int(times * n))


@pytest.fixture(scope="module")
def engine(greedy):
    eng = _engine(greedy)
    yield eng
    eng.shutdown()


# ---------------------------------------------------------------------------
# join_slot against the JAX package's _join_slot
# ---------------------------------------------------------------------------


def _carries(batch, quantized, seed):
    """A batched carry and a prefilled batch-1 carry (cache rows 2B and 2)
    as numpy arrays of bf16 values in the layout both packages share."""
    rng = np.random.RandomState(seed)
    lm = CFG.decoder_config
    bf16 = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16().float().numpy()
    dec = {k: v.shape[1:] for k, v in inf.tok.init_decoder_state(
        CFG.acoustic_tokenizer_config, 1).items()}
    sem = {k: v.shape[1:] for k, v in inf.tok.init_encoder_state(
        CFG.semantic_tokenizer_config, 1).items()}

    def carry(rows):
        shape = (2 * rows, lm.num_key_value_heads, 24, lm.head_dim)
        layers = range(lm.num_hidden_layers)
        kv = (lambda: rng.randint(-127, 128, shape).astype(np.int8)) if quantized else (
            lambda: bf16(*shape))
        scales = lambda: rng.rand(2 * rows, lm.num_key_value_heads, 1, 24).astype(np.float32)
        return dict(
            k=[kv() for _ in layers], v=[kv() for _ in layers],
            ks=[scales() for _ in layers] if quantized else None,
            vs=[scales() for _ in layers] if quantized else None,
            length=rng.randint(1, 24, 2 * rows).astype(np.int32),
            dec={k: bf16(rows, *s) for k, s in dec.items()},
            sem={k: bf16(rows, *s) for k, s in sem.items()},
            h_pos=bf16(rows, lm.hidden_size), h_neg=bf16(rows, lm.hidden_size),
            finished=rng.rand(rows) < 0.5, n_diff=rng.randint(0, 9, rows))

    return carry(batch), carry(1)


def _jax_carry(c):
    kv = lambda xs: tuple(jnp.asarray(x, jnp.int8 if x.dtype == np.int8 else jnp.bfloat16)
                          for x in xs)
    sc = lambda xs: None if xs is None else tuple(jnp.asarray(x) for x in xs)
    return jinf.DecodeCarry(
        cache=jq.KVCache(k=kv(c["k"]), v=kv(c["v"]), length=jnp.asarray(c["length"]),
                         k_scale=sc(c["ks"]), v_scale=sc(c["vs"])),
        dec_state={k: jnp.asarray(v, jnp.bfloat16) for k, v in c["dec"].items()},
        sem_state={k: jnp.asarray(v, jnp.bfloat16) for k, v in c["sem"].items()},
        h_pos=jnp.asarray(c["h_pos"], jnp.bfloat16), h_neg=jnp.asarray(c["h_neg"], jnp.bfloat16),
        finished=jnp.asarray(c["finished"]), n_diff=jnp.asarray(c["n_diff"], jnp.int32))


def _torch_carry(c):
    t = lambda x: torch.from_numpy(np.array(x)) if x.dtype in (np.int8, np.int32, np.bool_) \
        else torch.from_numpy(np.array(x)).bfloat16()
    sc = lambda xs: None if xs is None else tuple(torch.from_numpy(x.copy()) for x in xs)
    return inf.DecodeCarry(
        cache=tq.KVCache(k=tuple(map(t, c["k"])), v=tuple(map(t, c["v"])),
                         length=t(c["length"]), k_scale=sc(c["ks"]), v_scale=sc(c["vs"])),
        dec_state={k: t(v) for k, v in c["dec"].items()},
        sem_state={k: t(v) for k, v in c["sem"].items()},
        h_pos=t(c["h_pos"]), h_neg=t(c["h_neg"]), finished=t(c["finished"]),
        n_diff=torch.from_numpy(c["n_diff"].astype(np.int64)))


def _leaves(carry):
    out = []
    inf._tree_map(lambda x: out.append(x), carry)
    return out


def _fields(carry):
    """Every array of a carry of either package as f32 (or integer) numpy,
    by name."""
    as_np = lambda x: (x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()) \
        if isinstance(x, torch.Tensor) else np.asarray(x).astype(
            np.float32 if x.dtype == jnp.bfloat16 else np.asarray(x).dtype)
    c = carry.cache
    out = {f"{name}{i}": as_np(x) for name in ("k", "v", "k_scale", "v_scale")
           for i, x in enumerate(getattr(c, name) or ())}
    out["length"] = as_np(c.length)
    for part in ("dec_state", "sem_state"):
        out.update({f"{part}.{k}": as_np(v) for k, v in getattr(carry, part).items()})
    for name in ("h_pos", "h_neg", "finished", "n_diff"):
        out[name] = as_np(getattr(carry, name))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("slot", [0, 2])
def test_join_slot_matches_jax(quantized, slot):
    """Every field of the batched carry (B 3) after joining a batch-1
    carry into slot 0 and slot B-1 equals the JAX package's _join_slot on
    the same arrays, bit for bit; the port writes in place: each tensor of
    the carry is the one it was, and join_slot returns the carry itself."""
    batch = 3
    big, single = _carries(batch, quantized, seed=slot + 10 * quantized)
    want = _fields(jax_join_slot(_jax_carry(big), _jax_carry(single), slot, batch))
    carry = _torch_carry(big)
    before = [x.data_ptr() for x in _leaves(carry)]
    assert join_slot(carry, _torch_carry(single), slot, batch) is carry
    assert [x.data_ptr() for x in _leaves(carry)] == before
    got = _fields(carry)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w.astype(got[name].dtype), err_msg=name)
    # the slot's rows changed, the other slots' did not
    assert not np.array_equal(got["k0"][slot], _fields(_torch_carry(big))["k0"][slot])
    other = (slot + 1) % batch
    np.testing.assert_array_equal(got["h_pos"][other], _fields(_torch_carry(big))["h_pos"][other])


# ---------------------------------------------------------------------------
# a batched request against its solo run
# ---------------------------------------------------------------------------


def _solo_draws(seed, frames):
    """The draws generate(seed=...) makes for a batch-1 request without a
    voice prompt, frame by frame: the initial latent, then the uniform of
    the token choice (inference._fill_noise's order)."""
    g = torch.Generator().manual_seed(seed)
    init_, uni = [], []
    for _ in range(frames):
        init_.append(torch.empty(1, VAE).normal_(generator=g)[0])
        uni.append(torch.empty(1).uniform_(generator=g)[0])
    return torch.stack(init_), torch.stack(uni)


def _hand_out_solo_draws(eng, monkeypatch):
    """Replace the engine's draw: each slot gets the rows its request's solo
    run reads at the frames of this window."""
    draws = {}

    def draw():
        k = eng.frames_per_dispatch
        init_ = torch.zeros(k, eng.max_batch, VAE)
        uni = torch.zeros(k, eng.max_batch)
        for i, h in enumerate(eng.slots):
            if h is None:
                continue
            if h not in draws:
                draws[h] = _solo_draws(h.request.seed, MAX_LEN)
            s = int(eng.slot_steps[i])
            init_[:, i] = draws[h][0][s: s + k]
            uni[:, i] = draws[h][1][s: s + k]
        return inf.FrameNoise(init_, None, uni)

    monkeypatch.setattr(eng, "_draw_noise", draw)


@pytest.mark.parametrize("k", [1, 4])
def test_batched_request_equals_its_solo_run(mixed, monkeypatch, k):
    """Three sampled requests through a 2-slot engine (the third takes a
    freed slot) at K frames a window, each slot given its request's solo
    draws: every request's tokens equal those of generate() with its seed
    (the engine runs one more token where generate() stops at a window
    boundary before the cap frame), its audio has the same length and lies
    within 1e-4 of the solo run's peak."""
    opts = inf.GenerateOptions(ddpm_steps=2, max_length=MAX_LEN, do_sample=True,
                               frames_per_dispatch=k)
    eng = _engine(mixed, opts=opts, frames_per_dispatch=k)
    _hand_out_solo_draws(eng, monkeypatch)
    reqs = [_request(20 + i, n=8 + 3 * i) for i in range(3)]
    try:
        handles = [eng.submit(r) for r in reqs]
        got = [h.result(timeout=TIMEOUT) for h in handles]
    finally:
        eng.shutdown()
    mixes = set()
    for r, h, audio in zip(reqs, handles, got):
        solo = inf.generate(CFG, mixed, input_ids=r.input_ids, tokens=TOK, opts=opts, seed=r.seed)
        want_toks = solo.sequences[0, r.input_ids.shape[1]:].tolist()
        assert h.tokens[: len(want_toks)] == want_toks
        assert len(h.tokens) - len(want_toks) in (0, 1)
        want = solo.speech_outputs[0]
        assert want is not None and audio.shape == want.shape
        peak = float(np.abs(want).max())
        assert peak > 0 and float(np.abs(audio - want).max()) <= 1e-4 * peak
        mixes |= set(want_toks)
    assert {TOK.speech_diffusion, TOK.speech_start} <= mixes  # not a run of one token


class _StaticStep:
    """A stand-in for the card's graphed step on the CPU: one static carry
    that the step runs in, a caller's other carry copied in (counted), the
    returned carry the static one, as inference.StepFn replays."""

    def __init__(self, real):
        self.real, self.static, self.copies = real, None, 0

    def __call__(self, params, carry, noise, ext):
        if self.static is None:
            self.static = inf._tree_map(lambda t: t.clone(), carry)
        if carry is not self.static:
            self.copies += 1
            inf._copy_into(self.static, carry)
        new, out = self.real.eager(params, self.static, noise, ext)
        inf._copy_into(self.static, new)
        return self.static, out


def test_engine_keeps_the_step_carry_and_joins_in_place(greedy):
    """The engine passes the carry a window returned to the next window and
    joins requests into it in place: over five requests through two slots
    the static carry is copied in once (the first window), the engine's
    carry is the static one, and its tensors never change."""
    eng = _engine(greedy, frames_per_dispatch=2)
    step = eng.step_fn = _StaticStep(eng.step_fn)
    try:
        handles = [eng.submit(_request(30 + i, n=6 + i)) for i in range(5)]
        for h, i in zip(handles, range(5)):
            assert len(h.result(timeout=TIMEOUT)) == _cap(6 + i) * HOP
        assert eng.wait_for_state(lambda: all(s is None for s in eng.slots), TIMEOUT)
    finally:
        eng.shutdown()
    assert step.copies == 1 and eng.carry is step.static
    assert [x.data_ptr() for x in _leaves(eng.carry)] == [
        x.data_ptr() for x in _leaves(step.static)]


# ---------------------------------------------------------------------------
# behaviour (tests/test_serving.py's, on the port)
# ---------------------------------------------------------------------------


def test_requests_complete_concurrently_and_stream(engine):
    """One request, four at once over two slots, and a streamed one: every
    waveform is its frame cap of hop-sized frames, and a stream's chunks
    add up to its result."""
    one = engine.submit(_request(0)).result(timeout=TIMEOUT)
    assert one.dtype == np.float32 and len(one) == _cap(10) * HOP
    handles = [engine.submit(_request(i, n=8 + i)) for i in range(4)]
    for i, h in enumerate(handles):
        assert len(h.result(timeout=TIMEOUT)) == _cap(8 + i) * HOP
    h = engine.submit(_request(9))
    chunks = list(h.stream())
    assert all(len(c) == HOP for c in chunks)
    np.testing.assert_array_equal(np.concatenate(chunks), h.result(timeout=TIMEOUT))
    assert np.isfinite(one).all() and np.abs(one).max() > 0


def test_prefill_does_not_stall_active_streams(engine, monkeypatch):
    """While a second request's prefill is held on the prefill thread, an
    active stream keeps stepping (the decode loop never waits on it)."""
    real = inf.prefill_request
    release, held = threading.Event(), threading.Event()

    def slow(*a, **kw):
        held.set()
        assert release.wait(TIMEOUT)
        return real(*a, **kw)

    h1 = engine.submit(_request(20, n=40))  # cap 80 frames
    assert engine.wait_for_state(lambda: any(s is h1 for s in engine.slots), TIMEOUT)
    slot = engine.slots.index(h1)
    monkeypatch.setattr(inf, "prefill_request", slow)
    h2 = engine.submit(_request(21, n=8))
    try:
        assert held.wait(TIMEOUT)
        start = int(engine.slot_steps[slot])
        assert engine.wait_for_state(lambda: engine.slot_steps[slot] >= start + 4, TIMEOUT), \
            "the active stream stalled while another request prefilled"
    finally:
        release.set()
    h1.result(timeout=TIMEOUT)
    h2.result(timeout=TIMEOUT)


def test_bad_request_surfaces_error(engine):
    """Voice frames that do not match the tokenizer's hop fail that request
    only; the engine goes on serving."""
    bad = Request(input_ids=np.full((1, 4), 20, np.int64), valid_mask=np.ones((1, 4), bool),
                  speech_tensors=np.zeros((1, 64), np.float32),
                  speech_frame_valid=np.ones((1, 3), bool),  # 64 / 8 = 8 frames, not 3
                  speech_input_mask=np.zeros((1, 4), bool))
    with pytest.raises(ValueError, match="frames"):
        engine.submit(bad).result(timeout=TIMEOUT)
    engine.submit(_request(3)).result(timeout=TIMEOUT)


@pytest.mark.parametrize("k, kv_int8", [(1, False), (3, True), (4, False)])
def test_frame_caps_and_slot_reuse_any_window(greedy, k, kv_int8):
    """Requests of many lengths churn through two slots (free, join again
    while a window is in flight) at K frames a window, bf16 or int8 KV:
    each gets exactly its frame cap of audio, finite."""
    eng = _engine(greedy, frames_per_dispatch=k,
                  opts=inf.GenerateOptions(ddpm_steps=2, max_length=MAX_LEN, kv_int8=kv_int8))
    assert (eng.carry.cache.k[0].dtype == torch.int8) == kv_int8
    lens = [7, 12, 9, 21, 8, 15]
    try:
        handles = [eng.submit(_request(100 + i, n=n)) for i, n in enumerate(lens)]
        for h, n in zip(handles, lens):
            audio = h.result(timeout=TIMEOUT)
            assert len(audio) == _cap(n) * HOP and np.isfinite(audio).all()
        assert eng.wait_for_state(lambda: all(s is None for s in eng.slots), TIMEOUT)
    finally:
        eng.shutdown()


def test_request_cancellation(greedy):
    """cancel(): an active stream stops early and keeps the audio it had; a
    queued one finishes with at most a few frames; the sibling runs to its
    cap."""
    eng = _engine(greedy, frames_per_dispatch=2)
    try:
        h1, h2 = eng.submit(_request(50, n=30)), eng.submit(_request(51, n=30))
        assert eng.wait_for_state(lambda: len(h1._audio) > 0, TIMEOUT)
        h1.cancel()
        a1 = h1.result(timeout=TIMEOUT)
        assert 0 < len(a1) < _cap(30) * HOP and h1.rec["outcome"] == "cancelled"
        h3 = eng.submit(_request(52))
        h3.cancel()
        assert len(h3.result(timeout=TIMEOUT)) <= 3 * 2 * HOP
        assert len(h2.result(timeout=TIMEOUT)) == _cap(30) * HOP
    finally:
        eng.shutdown()


def test_cancel_staged_while_slots_full(greedy):
    """A prefilled request that waits for a slot (both busy with long
    requests) finishes at once on cancel(), without a slot."""
    eng = _engine(greedy, frames_per_dispatch=2, max_len=1024,
                  opts=inf.GenerateOptions(ddpm_steps=2, max_length=1024))
    try:
        long = [_request(60 + i, n=30, max_length_times=30.0) for i in range(2)]
        h1, h2 = (eng.submit(r) for r in long)
        assert eng.wait_for_state(lambda: h1 in eng.slots and h2 in eng.slots, TIMEOUT)
        h3 = eng.submit(_request(62, n=30))
        assert eng.wait_for_state(lambda: eng.ready.qsize() > 0 or eng._ready_local, TIMEOUT)
        assert all(s is not None for s in eng.slots)
        h3.cancel()
        assert len(h3.result(timeout=30)) == 0
        assert all(s is not None for s in eng.slots)
    finally:
        eng.shutdown()


def test_stats_and_deadline(greedy):
    """stats() counts outcomes, frames and TTFA; a request already past its
    deadline at submit finishes as deadline_expired, without an error."""
    eng = _engine(greedy, frames_per_dispatch=2)
    try:
        audio = eng.submit(_request(41)).result(timeout=TIMEOUT)
        st = eng.stats()
        assert (st.submitted, st.completed, st.active, st.queued) == (1, 1, 0, 0)
        assert st.frames_emitted == len(audio) // HOP and st.audio_seconds_emitted > 0
        assert 0 < st.ttfa_p50_ms <= st.ttfa_p95_ms and st.uptime_s > 0
        h = eng.submit(_request(42, deadline_s=0.0))
        out = h.result(timeout=TIMEOUT)
        assert h.error is None and h.deadline_expired and isinstance(out, np.ndarray)
        assert eng.stats().deadline_expired == 1
    finally:
        eng.shutdown()


def _exploding(eng, when):
    real = eng.step_fn

    def step(p, c, noise, ext):
        if when():
            raise RuntimeError("injected device fault")
        return real(p, c, noise, ext)

    eng.step_fn = step


def test_decode_loop_crash_drains_all_requests(greedy):
    """A dead decode loop fails every active and queued request with its
    error, and later submissions fail at once."""
    eng = _engine(greedy, frames_per_dispatch=2)
    calls = iter(range(10 ** 6))
    _exploding(eng, lambda: next(calls) >= 2)
    try:
        h1, h2 = eng.submit(_request(70, n=20)), eng.submit(_request(71, n=20))
        for h in (h1, h2):
            with pytest.raises(RuntimeError, match="injected device fault"):
                h.result(timeout=TIMEOUT)
        assert eng.stats().failed == 2
        eng._thread.join(TIMEOUT)
        assert eng._stop.is_set()
        with pytest.raises(RuntimeError, match="engine is stopped"):
            eng.submit(_request(72)).result(timeout=30)
    finally:
        eng.shutdown()


def test_retiring_handle_fails_on_decode_crash(greedy):
    """A slot freed at dispatch (a predicted cap finish) whose last window
    is in flight: a fault then fails that handle too."""
    eng = _engine(greedy, frames_per_dispatch=2)
    _exploding(eng, lambda: bool(eng._retiring))
    try:
        h1, h2 = eng.submit(_request(80, n=8)), eng.submit(_request(81, n=30))
        for h in (h1, h2):
            with pytest.raises(RuntimeError, match="injected device fault"):
                h.result(timeout=TIMEOUT)
        assert eng.stats().failed == 2 and not eng._retiring
    finally:
        eng.shutdown()


def test_prefill_thread_crash_fails_queued_requests(greedy):
    """A fault of the prefill worker itself stops the engine and fails the
    queued requests promptly."""
    eng = _engine(greedy, max_batch=1)

    def fault(handle):
        raise RuntimeError("injected prefill-worker fault")

    eng._prefill_one = fault
    try:
        hs = [eng.submit(_request(80 + i)) for i in range(2)]
        for h in hs:
            with pytest.raises(RuntimeError,
                               match="prefill-worker fault|engine is stopped|engine shut down"):
                h.result(timeout=TIMEOUT)
        assert eng._stop.is_set()
    finally:
        eng.shutdown()


def test_submit_put_races_stop(greedy):
    """A submit whose put lands after a stop's drains settles its own handle."""
    eng = _engine(greedy, max_batch=1)
    orig = eng.pending.put

    def racing_put(item, *a, **k):
        eng._stop.set()
        orig(item, *a, **k)

    eng.pending.put = racing_put
    try:
        with pytest.raises(RuntimeError, match="engine is stopped|engine shut down"):
            eng.submit(_request(90)).result(timeout=30)
    finally:
        eng.pending.put = orig
        eng.shutdown()


def test_priority_lane_express_slot(greedy):
    """reserved_slots=1: bulk requests never take slot 0, a priority request
    does, and every request completes."""
    eng = _engine(greedy, reserved_slots=1)
    slots = {}  # handle -> the slots it decoded in, read at every window's draw
    draw = eng._draw_noise

    def recording_draw():
        for i, h in enumerate(eng.slots):
            if h is not None:
                slots.setdefault(h, set()).add(i)
        return draw()

    eng._draw_noise = recording_draw
    try:
        bulk = [eng.submit(_request(60 + i, n=24)) for i in range(3)]
        assert eng.wait_for_state(lambda: eng.slots[1] is not None, TIMEOUT)
        hp = eng.submit(_request(70, n=8, priority=True))
        hp.result(timeout=TIMEOUT)
        for h in bulk:
            h.result(timeout=TIMEOUT)
        assert all(h.rec["outcome"] == "completed" for h in bulk + [hp])
        assert slots[hp] == {0} and all(slots[h] == {1} for h in bulk)
        st = eng.stats()
        assert st.priority_submitted == 1 and st.priority_ttfa_p50_ms is not None
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kw, err", [({"reserved_slots": 2}, ValueError),
                                     ({"mesh": object()}, ValueError)])
def test_engine_refuses(greedy, kw, err):
    """reserved_slots must leave a bulk slot; tensor-parallel serving shards
    a dense LM and refuses an int8 one, as the JAX engine does (the mesh
    itself is never reached)."""
    params = tvv.quantize_for_inference(greedy) if "mesh" in kw else greedy
    with pytest.raises(err, match="reserved_slots|TP serving shards dense"):
        _engine(params, **kw)


def test_request_seed_drives_prefill_noise(greedy):
    """Request.seed seeds the voice prompt's VAE draw as generate(seed=...)
    does: the engine's prefilled carry equals prefill_request's with a
    generator seeded so, and another seed draws another carry."""
    eng = _engine(greedy, max_batch=1)
    try:
        rng = np.random.RandomState(7)
        n, samples = 12, 27
        frames = -(-samples // HOP)
        mask = np.zeros((1, n), bool)
        mask[0, 2: 2 + frames] = True
        voice = dict(speech_tensors=(rng.randn(1, samples) * 0.1).astype(np.float32),
                     speech_frame_valid=np.ones((1, frames), bool), speech_input_mask=mask)
        carries = {}
        for seed in (3, 11):
            r = _request(seed, n=n, **voice)
            carries[seed] = eng._prefill(r)[0]
            want = inf.prefill_request(
                CFG, greedy, r.input_ids, r.valid_mask, r.speech_tensors, r.speech_frame_valid,
                r.speech_input_mask, MAX_LEN, TOK, eng.opts, torch.Generator().manual_seed(seed))
            for a, b in zip(_leaves(carries[seed]), _leaves(want)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(carries[3].h_pos, carries[11].h_pos)
    finally:
        eng.shutdown()


def test_warmup_stays_out_of_stats(greedy):
    """warmup() runs a synthetic request (with and without a voice prompt)
    and leaves no record in stats()."""
    eng = _engine(greedy)
    try:
        assert eng.warmup(prompt_tokens=8, timeout=TIMEOUT) > 0
        assert eng.warmup(prompt_tokens=8, voice_samples=64, timeout=TIMEOUT) > 0
        st = eng.stats()
        assert st.submitted == 0 and st.active == 0
        eng.submit(_request(3)).result(timeout=TIMEOUT)
        assert eng.stats().submitted == 1
    finally:
        eng.shutdown()


def test_graceful_drain_shutdown(greedy):
    """shutdown(drain=True): the accepted request completes with its audio;
    a submission meanwhile fails at once with "engine is draining"."""
    eng = _engine(greedy)
    h = eng.submit(_request(11))
    t = threading.Thread(target=eng.shutdown, kwargs=dict(timeout=TIMEOUT, drain=True))
    t.start()
    assert len(h.result(timeout=TIMEOUT)) == _cap(10) * HOP and h.error is None
    assert eng._draining.wait(TIMEOUT)
    with pytest.raises(RuntimeError, match="draining|stopped"):
        eng.submit(_request(12)).result(timeout=30)
    t.join(TIMEOUT)
    assert eng._stop.is_set() and not t.is_alive()
