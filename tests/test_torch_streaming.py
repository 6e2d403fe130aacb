"""The port's streaming 0.5B model (vibevoice_tpu_torch/models/streaming.py,
tts.StreamingTTS, processor/streaming_processor.py, utils/preset_convert.py)
against the JAX package's on the tiny streaming config, with the same
weights (JAX ``streaming.init``, randomised with numpy, carried over by
``from_jax``) and the same noise (``noise_bank`` rows for the initial
latents and the SDE noise). The JAX package runs on the CPU as its own
tests run it (its fused vocoder in interpret mode); the port runs its
kernels' plain versions on CPU tensors.

Tolerances: integers (lengths, stopping frames, int8 cache rows) are equal;
dense f32 values agree to 1e-5 of their peak (f32 summation order). The
int8 fused vocoder (``fuse_vocoder(quantize=True)``, kernel D's plain
version against the JAX kernel in interpret mode) differs in one place: the
JAX kernel's GELU uses the Abramowitz-Stegun erf (|error| <= 1.5e-7), the
port's torch.erf; its waveform is held at 1e-5 of the peak too.
"""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu import configs as JC
from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import streaming as jst
from vibevoice_tpu.models.inference import GenerateOptions as JOpts
from vibevoice_tpu.utils import preset_convert as jconvert

from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.models import inference as tinf
from vibevoice_tpu_torch.models import qwen2 as tq
from vibevoice_tpu_torch.models import streaming as tst
from vibevoice_tpu_torch.models.inference import GenerateOptions as TOpts
from vibevoice_tpu_torch.tts import StreamingTTS
from vibevoice_tpu_torch.utils import preset_convert as tconvert
from vibevoice_tpu_torch.utils.params import from_jax, init_streaming

TOL = 1e-5  # of the peak: dense f32 (and the int8 fused vocoder, see above)
MAX_LEN = 96
PROMPT_LEN = 12


def _cfg(C):
    return C.VibeVoiceStreamingConfig(
        acoustic_tokenizer_config=C.AcousticTokenizerConfig(
            vae_dim=16, encoder_n_filters=4, encoder_ratios=(4, 2), encoder_depths=(1, 1, 2),
            decoder_n_filters=4),
        decoder_config=C.Qwen2Config(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024,
            rope_theta=10_000.0),
        diffusion_head_config=C.DiffusionHeadConfig(hidden_size=64, head_layers=2,
                                                    latent_size=16),
        tts_backbone_num_hidden_layers=2)


JCFG, TCFG = _cfg(JC), _cfg(TC)
HOP = TCFG.acoustic_tokenizer_config.hop_length
VAE = TCFG.acoustic_vae_dim
HEAD_DIM = TCFG.decoder_config.head_dim


def _randomize(tree, seed):
    """Every matrix N(0, 0.7 / sqrt(fan-in)), vectors (biases, norms, the
    scaling scalars' neighbours) perturbed, layer scales 0.3: every part of
    the model does work."""
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return jnp.full(x.shape, 0.3, x.dtype)
        if x.ndim == 0:
            return x
        if x.ndim == 1:
            return jnp.asarray(rng.randn(*x.shape) * 0.1 + (1.0 if "norm" in name else 0.0),
                               x.dtype)
        return jnp.asarray(rng.randn(*x.shape) * (0.7 / np.sqrt(np.prod(x.shape[:-1]))), x.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _with_eos_bias(tree, bias):
    """The tree (JAX or the port's) with the EOS classifier's output bias
    set to ``bias``."""
    full = (lambda: torch.full((1,), float(bias))) if isinstance(
        tree["speech_scaling_factor"], torch.Tensor) else (
        lambda: jnp.full((1,), bias, jnp.float32))
    eos = tree["tts_eos_classifier"]
    return {**tree, "tts_eos_classifier": {**eos, "fc2": {**eos["fc2"], "b": full()}}}


@pytest.fixture(scope="module")
def models():
    jp = _randomize(jst.init(jax.random.PRNGKey(0), JCFG), 1)
    tp = from_jax(jax.tree.map(np.asarray, jp), TCFG, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def presets(models):
    """(JAX preset, the port's preset built from it, the port's own)."""
    jp, tp = models
    prompt = np.random.RandomState(0).randint(10, 200, (1, PROMPT_LEN))
    jpre = jst.build_voice_preset(JCFG, jp, prompt, neg_prompt_id=3, max_len=MAX_LEN)
    same = tst.VoicePreset(**{f.name: getattr(jpre, f.name)
                              for f in dataclasses.fields(tst.VoicePreset)})
    own = tst.build_voice_preset(TCFG, tp, prompt, neg_prompt_id=3, max_len=MAX_LEN)
    return jpre, same, own


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{what}: max |diff| {err:.3e} over peak {peak:.3e}"


def _rows(cache, b, n):
    """The first n valid rows of sample b of every layer, K then V."""
    return [_np(x)[b, :, :n] for x in tuple(cache.k) + tuple(cache.v)]


def _same_cache(tc, jc, what):
    lengths = _np(jc.length).astype(int)
    np.testing.assert_array_equal(_np(tc.length).astype(int), lengths, err_msg=what)
    for b, n in enumerate(lengths):
        for i, (got, want) in enumerate(zip(_rows(tc, b, n), _rows(jc, b, n))):
            _close(got, want, what=f"{what} sample {b} buffer {i}")


def _same_state(ts, js, tol=TOL, rows=None):
    """Every part of the carried state; ``rows`` limits the comparison to
    those batch rows (the live sessions)."""
    rows = slice(None) if rows is None else rows
    for name in ("lm_cache", "tts_cache", "neg_tts_cache"):
        tc, jc = getattr(ts, name), getattr(js, name)
        lengths = _np(jc.length).astype(int)
        np.testing.assert_array_equal(_np(tc.length).astype(int)[rows], lengths[rows],
                                      err_msg=name)
        for b in np.arange(len(lengths))[rows]:
            for i, (got, want) in enumerate(zip(_rows(tc, b, lengths[b]),
                                                _rows(jc, b, lengths[b]))):
                _close(got, want, tol, f"{name} sample {b} buffer {i}")
    for k in js.dec_state:
        _close(_np(ts.dec_state[k])[rows], _np(js.dec_state[k])[rows], tol, f"dec_state {k}")
    _close(_np(ts.tts_h)[rows], _np(js.tts_h)[rows], tol, "tts_h")
    _close(_np(ts.neg_tts_h)[rows], _np(js.neg_tts_h)[rows], tol, "neg_tts_h")
    np.testing.assert_array_equal(_np(ts.finished)[rows], _np(js.finished)[rows])


def _noise(rng, frames, batch, sde, steps=3):
    init = rng.randn(frames, batch, VAE).astype(np.float32)
    return init, (rng.randn(frames, steps, batch, VAE).astype(np.float32) if sde else None)


def _jnoise(init, sde):
    return {"init": jnp.asarray(init), **({} if sde is None else {"sde": jnp.asarray(sde)})}


def _tnoise(init, sde):
    return tinf.FrameNoise(torch.from_numpy(init), None if sde is None else torch.from_numpy(sde),
                           None)


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cached", [True, False])
def test_forward_skip_final_norm_matches_jax(models, cached):
    """The lower LM's forward without its final norm, cached (a right-padded
    chunk of 7 with 5 valid over an empty cache) and no-cache: hidden states
    within 1e-5 of the peak; with the norm the two outputs differ."""
    jp, tp = models
    lcfg_j = dataclasses.replace(JCFG.decoder_config, num_hidden_layers=JCFG.lm_num_hidden_layers)
    lcfg_t = dataclasses.replace(TCFG.decoder_config, num_hidden_layers=TCFG.lm_num_hidden_layers)
    ids = np.random.RandomState(4).randint(10, 200, (1, 7))
    valid = np.ones((1, 7), bool)
    valid[:, 5:] = False
    jkw, tkw = dict(valid_mask=jnp.asarray(valid)), dict(valid_mask=torch.from_numpy(valid))
    if cached:
        jkw["cache"] = jq.make_cache(lcfg_j, 1, 32, jnp.float32)
        tkw["cache"] = tq.make_cache(lcfg_t, 1, 32, torch.float32)
    jemb = jq.embed_tokens(jp["language_model"], jnp.asarray(ids))
    temb = tq.embed_tokens(tp["language_model"], torch.from_numpy(ids))
    outs = {}
    for skip in (True, False):
        jh, jc = jq.forward(lcfg_j, jp["language_model"], jemb, skip_final_norm=skip,
                            **{**jkw, **({"cache": jq.make_cache(lcfg_j, 1, 32, jnp.float32)}
                                         if cached else {})})
        th, tc = tq.forward(lcfg_t, tp["language_model"], temb, skip_final_norm=skip,
                            **{**tkw, **({"cache": tq.make_cache(lcfg_t, 1, 32, torch.float32)}
                                         if cached else {})})
        _close(th[:, :5], jh[:, :5], what=f"hidden, skip_final_norm={skip}")
        if cached:
            _same_cache(tc, jc, "lower LM cache")
        outs[skip] = _np(th)
    assert np.abs(outs[True] - outs[False]).max() > 1e-2


def test_eos_logit_matches_jax(models):
    jp, tp = models
    h = np.random.RandomState(2).randn(3, 64).astype(np.float32)
    _close(tst.eos_logit(tp, torch.from_numpy(h)), jst.eos_logit(jp, jnp.asarray(h)), what="logit")


def test_init_streaming_has_the_reference_shapes():
    """init_streaming's tree has the JAX init's keys, shapes and dtypes."""
    want = jax.tree_util.tree_flatten_with_path(jst.init(jax.random.PRNGKey(0), JCFG))[0]
    got = init_streaming(TCFG, seed=0, device="cpu")
    # the JAX package keeps convs as TIO; from_jax gives the port's layouts
    conv = from_jax(jax.tree.map(np.asarray, jst.init(jax.random.PRNGKey(0), JCFG)), TCFG,
                    device="cpu")
    flat = lambda t: {jax.tree_util.keystr(p): tuple(np.shape(x)) for p, x in
                      jax.tree_util.tree_flatten_with_path(
                          jax.tree.map(lambda a: np.zeros(a.shape), t))[0]}
    assert flat(got) == flat(conv)
    assert len(flat(got)) == len(want)
    assert len(got["language_model"]["layers"]) == 2 and len(got["tts_language_model"]["layers"]) == 2
    assert got["tts_input_types"].dtype == torch.float32


def test_init_streaming_and_smoke_want_a_card():
    """Without device="cpu" the constructors build on the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_streaming(TCFG)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingTTS.smoke()


def test_build_voice_preset_matches_jax(presets):
    """KV arrays, lengths and the three last hidden states."""
    jpre, _, own = presets
    for name in ("lm_kv", "tts_kv", "neg_tts_kv"):
        want, got = getattr(jpre, name), getattr(own, name)
        _close(got[0], want[0], what=f"{name} k")
        _close(got[1], want[1], what=f"{name} v")
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == want[2].dtype
    assert int(own.tts_kv[2][0]) == PROMPT_LEN and int(own.neg_tts_kv[2][0]) == 1
    for name in ("lm_h", "tts_h", "neg_tts_h"):
        _close(getattr(own, name), getattr(jpre, name), what=name)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_init_stream_state_matches_jax(models, presets, kv):
    """The preset's rows in the caches: bf16 weights give bf16 caches with
    the same bits (one rounding of the same f32 rows), int8 caches the same
    int8 rows and f32 row scales; lengths, hidden states and the zero
    vocoder state equal."""
    jp, tp = models
    jpre, same, _ = presets
    if kv == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim else a, jp)
        tp = from_jax(jax.tree.map(np.asarray, jp), TCFG, device="cpu")
    js = jst.init_stream_state(JCFG, jp, jpre, MAX_LEN, kv_int8=kv == "int8")
    ts = tst.init_stream_state(TCFG, tp, same, MAX_LEN, kv_int8=kv == "int8")
    for name in ("lm_cache", "tts_cache", "neg_tts_cache"):
        jc, tc = getattr(js, name), getattr(ts, name)
        np.testing.assert_array_equal(_np(tc.length), _np(jc.length))
        pairs = list(zip(tc.k + tc.v, jc.k + jc.v))
        if kv == "int8":
            pairs += list(zip(tc.k_scale + tc.v_scale, jc.k_scale + jc.v_scale))
            assert tc.k[0].dtype == torch.int8
        else:
            assert tc.k[0].dtype == torch.bfloat16
        for got, want in pairs:
            assert got.shape == want.shape  # head_dim lanes, no padding
            np.testing.assert_array_equal(_np(got), _np(want))
    for k in js.dec_state:
        np.testing.assert_array_equal(_np(ts.dec_state[k]), _np(js.dec_state[k]))
    np.testing.assert_array_equal(_np(ts.tts_h), _np(js.tts_h))
    np.testing.assert_array_equal(_np(ts.neg_tts_h), _np(js.neg_tts_h))


# ---------------------------------------------------------------------------
# the windows
# ---------------------------------------------------------------------------


def _two_sessions(jp, tp, jpre, same):
    """A 2-slot session state with the preset admitted to both slots."""
    js = jst.init_session_state(JCFG, jp, 2, MAX_LEN)
    ts = tst.init_session_state(TCFG, tp, 2, MAX_LEN)
    ja = jst.preset_admit_arrays(jpre, lane_dim=HEAD_DIM, max_len=MAX_LEN)
    ta = tst.preset_admit_arrays(same, lane_dim=HEAD_DIM, max_len=MAX_LEN)
    for slot in (0, 1):
        js = jst.admit_session(js, slot, **ja)
        ts = tst.admit_session(ts, slot, **ta)
    return js, ts


@pytest.mark.parametrize("n_valid", [5, 2])
def test_text_window_matches_jax(models, presets, n_valid):
    """A full window and a right-padded one (2 of 5 valid), in a batch of 2
    whose second row is all invalid: tts_h (the invalid row keeps its own),
    the cache rows the window commits, and lengths (the invalid row's do
    not move)."""
    jp, tp = models
    jpre, same, _ = presets
    js, ts = _two_sessions(jp, tp, jpre, same)
    ids = np.random.RandomState(6).randint(10, 200, (2, 5))
    valid = np.zeros((2, 5), bool)
    valid[0, :n_valid] = True
    opts = dict(cfg_scale=1.5, ddpm_steps=3)
    jtext, _ = jst.make_session_fns(JCFG, JOpts(**opts), inject=True)
    ttext, _ = tst.make_session_fns(TCFG, TOpts(**opts), inject=True)
    h_before = _np(ts.tts_h).copy()
    js = jtext(jp, js, jnp.asarray(ids), jnp.asarray(valid))
    ts = ttext(tp, ts, torch.from_numpy(ids), torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(ts.lm_cache.length), [PROMPT_LEN + n_valid, PROMPT_LEN])
    np.testing.assert_array_equal(_np(ts.tts_cache.length), [PROMPT_LEN + n_valid, PROMPT_LEN])
    np.testing.assert_array_equal(_np(ts.tts_h)[1], h_before[1])
    assert np.abs(_np(ts.tts_h)[0] - h_before[0]).max() > 1e-3
    _same_state(ts, js)


@pytest.mark.parametrize("sde", [False, True], ids=["dpmsolver++", "sde-dpmsolver++"])
@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fuse_vocoder"])
def test_speech_window_matches_jax(models, presets, sde, fused):
    """A text window, then two speech windows of 6 frames from a noise
    bank: audio and EOS probabilities of every frame, and the carried state
    (caches, vocoder state, hidden states, finished)."""
    jp, tp = models
    jpre, same, _ = presets
    if fused:
        jp, tp = jst.fuse_vocoder(jp, JCFG, True), tst.fuse_vocoder(tp, TCFG, True)
    opts = dict(cfg_scale=1.5, ddpm_steps=3, sde=sde)
    jtext, jspeech, _ = jst.make_window_fns(JCFG, JOpts(**opts), inject=True)
    ttext, tspeech, _ = tst.make_window_fns(TCFG, TOpts(**opts), inject=True)
    js = jst.init_stream_state(JCFG, jp, jpre, MAX_LEN)
    ts = tst.init_stream_state(TCFG, tp, same, MAX_LEN)
    ids = np.random.RandomState(7).randint(10, 200, (1, 5))
    js = jtext(jp, js, jnp.asarray(ids), jnp.ones((1, 5), bool))
    ts = ttext(tp, ts, torch.from_numpy(ids), torch.ones(1, 5, dtype=torch.bool))
    rng = np.random.RandomState(8)
    for _ in range(2):
        init, sde_n = _noise(rng, 6, 1, sde)
        js, jaudio, jeos = jspeech(jp, js, jax.random.PRNGKey(0), _jnoise(init, sde_n))
        ts, taudio, teos = tspeech(tp, ts, _tnoise(init, sde_n))
        assert taudio.shape == (6, 1, HOP, 1) and teos.shape == (6, 1)
        _close(taudio, jaudio, what="audio")
        _close(teos, jeos, what="eos probabilities")
        _same_state(ts, js)
    assert _np(jaudio).std() > 1e-4


def _eos_logits(jp, jpre, text, bank, windows):
    """The JAX package's EOS logits of every frame of `windows` windows at
    an EOS bias of 0 (batch 1: EOS changes nothing the frames compute)."""
    jp = _with_eos_bias(jp, 0.0)
    jtext, jspeech, _ = jst.make_window_fns(JCFG, JOpts(cfg_scale=1.5, ddpm_steps=3), inject=True)
    js = jst.init_stream_state(JCFG, jp, jpre, MAX_LEN)
    probs = []
    for wi in range(windows):
        chunk = text[:, 5 * wi: 5 * wi + 5]
        js = jtext(jp, js, jnp.asarray(chunk), jnp.ones(chunk.shape, bool))
        js, _, eos = jspeech(jp, js, jax.random.PRNGKey(0),
                             {"init": jnp.asarray(bank["init"][6 * wi: 6 * wi + 6])})
        probs.append(np.asarray(eos, np.float64)[:, 0])
    p = np.concatenate(probs)
    return np.log(p) - np.log1p(-p)


@pytest.mark.parametrize("stop", ["eos", "capacity"])
def test_generate_matches_jax(models, presets, stop):
    """generate() end to end with a noise bank. "eos": the EOS bias is set
    (in both trees) between the largest logit of the first window and the
    first larger one of the second, so EOS fires inside the second window
    (the first bank seed from 9 whose logits allow that is used);
    "capacity": EOS never fires (bias -30) and the cache's capacity stops
    the run after three windows. The same audio (1e-5 of the peak), the
    same stop and the same reach_max_step_sample."""
    jp, tp = models
    jpre, same, _ = presets
    text = np.random.RandomState(9).randint(10, 200, (1, 15))
    max_len = MAX_LEN
    for seed in range(9, 29):
        bank = {"init": np.random.RandomState(seed).randn(60, 1, VAE).astype(np.float32)}
        if stop == "capacity":
            bias, max_len = -30.0, PROMPT_LEN + 33  # three full text + speech windows of 11
            want_frames = 18
            break
        z = _eos_logits(jp, jpre, text, bank, 2)
        first = float(z[:6].max())
        later = [f for f in range(6, 12) if z[f] > first + 1e-3]  # far above f32 differences
        if later:
            bias = -(first + float(z[later[0]])) / 2
            want_frames = later[0] + 1
            break
    else:
        pytest.fail("no bank seed gives a frame of the second window above the first's logits")
    jp, tp = _with_eos_bias(jp, bias), _with_eos_bias(tp, bias)
    kw = dict(tts_text_ids=text, max_len=max_len, seed=0, noise_bank=bank)
    jo = jst.generate(JCFG, jp, preset=jpre, opts=JOpts(cfg_scale=1.5, ddpm_steps=3), **kw)
    to = tst.generate(TCFG, tp, preset=same, opts=TOpts(cfg_scale=1.5, ddpm_steps=3), **kw)
    assert len(jo.speech_outputs[0]) == want_frames * HOP
    _close(to.speech_outputs[0], jo.speech_outputs[0], what="audio")
    np.testing.assert_array_equal(to.sequences, jo.sequences)
    np.testing.assert_array_equal(to.reach_max_step_sample, jo.reach_max_step_sample)
    assert bool(to.reach_max_step_sample[0]) == (stop == "capacity")


def test_generate_streams_each_frame_and_draws_from_the_seed(models, presets):
    """Without a noise bank the host draws each window's noise from the
    seeded generator: the same seed gives the same audio, another seed
    other audio; the streamer gets each kept frame and the end."""
    from vibevoice_tpu_torch.streamer import AudioStreamer

    _, tp = models
    _, same, _ = presets
    tp = _with_eos_bias(tp, -30.0)
    kw = dict(tts_text_ids=np.arange(10, 17)[None], preset=same, max_len=PROMPT_LEN + 22,
              opts=TOpts(cfg_scale=1.5, ddpm_steps=3, sde=True))
    streamer = AudioStreamer(batch_size=1)
    a = tst.generate(TCFG, tp, seed=1, audio_streamer=streamer, **kw)
    b = tst.generate(TCFG, tp, seed=1, **kw)
    c = tst.generate(TCFG, tp, seed=2, **kw)
    np.testing.assert_array_equal(a.speech_outputs[0], b.speech_outputs[0])
    assert np.abs(a.speech_outputs[0] - c.speech_outputs[0]).max() > 1e-4
    chunks = list(streamer.get_stream(0))
    assert len(chunks) == 12 and all(len(x) == HOP for x in chunks)
    np.testing.assert_array_equal(np.concatenate(chunks), a.speech_outputs[0])


@pytest.mark.parametrize("quantum", [1, 2, 3, 6])
def test_session_windows_match_jax(models, presets, quantum):
    """Session windows of `quantum` frames in a 3-slot state: the preset
    admitted into slot 1 (then slot 0), a text window for the live slots,
    a window with slots 0 and 1 active, then one with slot 1 alone active.
    The live rows' audio, EOS probabilities and state equal the JAX
    package's (1e-5 of the peak), and the admitted rows equal its admit.
    The inactive slot 0 keeps its vocoder state bit for bit across the
    second window (the port commits dec_state for live rows only); the JAX
    package overwrites it (models/streaming.py:527). EOS is kept from
    firing (bias -30): a finished row is not live either, and its vocoder
    state would differ from the JAX package's in the same way."""
    jp, tp = (_with_eos_bias(t, -30.0) for t in models)
    jpre, same, _ = presets
    opts = dict(cfg_scale=1.5, ddpm_steps=3)
    jtext, jsession = jst.make_session_fns(JCFG, JOpts(**opts), inject=True, quantum=quantum)
    ttext, tsession = tst.make_session_fns(TCFG, TOpts(**opts), inject=True, quantum=quantum)
    js = jst.init_session_state(JCFG, jp, 3, MAX_LEN)
    ts = tst.init_session_state(TCFG, tp, 3, MAX_LEN)
    ja = jst.preset_admit_arrays(jpre, lane_dim=HEAD_DIM, max_len=MAX_LEN)
    ta = tst.preset_admit_arrays(same, lane_dim=HEAD_DIM, max_len=MAX_LEN)
    for slot in (1, 0):
        js = jst.admit_session(js, slot, **ja)
        ts = tst.admit_session(ts, slot, **ta)
        _same_state(ts, js)
    np.testing.assert_array_equal(_np(ts.finished), [False, False, True])
    ids = np.random.RandomState(10).randint(10, 200, (3, 5))
    valid = np.zeros((3, 5), bool)
    valid[:2] = True
    js = jtext(jp, js, jnp.asarray(ids), jnp.asarray(valid))
    ts = ttext(tp, ts, torch.from_numpy(ids), torch.from_numpy(valid))
    rng = np.random.RandomState(11)
    for active in ([True, True, False], [False, True, False]):
        live = np.asarray(active)
        dec_before = {k: _np(v).copy() for k, v in ts.dec_state.items()}
        jdec_before = {k: _np(v).copy() for k, v in js.dec_state.items()}
        for _ in range(6 // quantum):
            init, _ = _noise(rng, quantum, 3, False)
            js, jaudio, jeos = jsession(jp, js, jax.random.PRNGKey(0), jnp.asarray(live),
                                        _jnoise(init, None))
            ts, taudio, teos = tsession(tp, ts, torch.from_numpy(live), _tnoise(init, None))
            assert taudio.shape == (quantum, 3, HOP, 1)
            _close(_np(taudio)[:, live], _np(jaudio)[:, live], what="audio")
            _close(_np(teos)[:, live], _np(jeos)[:, live], what="eos")
        _same_state(ts, js, rows=np.nonzero(live)[0])
        if not active[0]:
            for k in dec_before:
                np.testing.assert_array_equal(_np(ts.dec_state[k])[0], dec_before[k][0])
            assert any(np.abs(_np(js.dec_state[k])[0] - jdec_before[k][0]).max() > 0
                       for k in jdec_before)


def test_session_quanta_agree(models, presets):
    """One quantum of 1 against one of 6 over a window: every row the same
    bits (the same frames in other calls)."""
    jp, tp = models
    _, same, _ = presets
    outs = []
    for quantum in (1, 6):
        text, session = tst.make_session_fns(TCFG, TOpts(cfg_scale=1.5, ddpm_steps=3),
                                             quantum=quantum)
        ts = tst.admit_session(tst.init_session_state(TCFG, tp, 2, MAX_LEN), 1,
                               **tst.preset_admit_arrays(same, HEAD_DIM, max_len=MAX_LEN))
        init, _ = _noise(np.random.RandomState(12), 6, 2, False)
        active = torch.tensor([False, True])
        audio = []
        for f in range(0, 6, quantum):
            ts, a, _ = session(tp, ts, active, _tnoise(init[f: f + quantum], None))
            audio.append(a.clone())
        outs.append((torch.cat(audio), ts))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for k in outs[0][1].dec_state:
        torch.testing.assert_close(outs[0][1].dec_state[k], outs[1][1].dec_state[k], rtol=0,
                                   atol=0)


# ---------------------------------------------------------------------------
# presets on disk, the processor, the facade
# ---------------------------------------------------------------------------


def test_jax_npz_preset_loads(presets, tmp_path):
    jpre, _, _ = presets
    path = str(tmp_path / "voice.npz")
    jpre.save(path)
    back = tst.VoicePreset.load(path)
    for name in ("lm_kv", "tts_kv", "neg_tts_kv"):
        for got, want in zip(getattr(back, name), getattr(jpre, name)):
            np.testing.assert_array_equal(got, want)
    for name in ("lm_h", "tts_h", "neg_tts_h"):
        np.testing.assert_array_equal(getattr(back, name), getattr(jpre, name))
    back.save(str(tmp_path / "again.npz"))
    again = jst.VoicePreset.load(str(tmp_path / "again.npz"))
    np.testing.assert_array_equal(again.tts_kv[0], jpre.tts_kv[0])


def test_reference_pt_preset_converts_as_jax(tmp_path):
    """A reference-schema .pt (four streams, last_hidden_state (1, S, H),
    past_key_values as a list of per-layer (k, v) (1, KH, S, D)) gives the
    same arrays through both converters."""
    g = torch.Generator().manual_seed(0)
    d = {}
    for stream, (n_layers, s) in {"lm": (2, 9), "tts_lm": (2, 9), "neg_lm": (2, 1),
                                  "neg_tts_lm": (2, 1)}.items():
        d[stream] = {
            "last_hidden_state": torch.randn(1, s, 64, generator=g),
            "past_key_values": [(torch.randn(1, 2, s, HEAD_DIM, generator=g),
                                 torch.randn(1, 2, s, HEAD_DIM, generator=g))
                                for _ in range(n_layers)],
        }
    path = str(tmp_path / "voice.pt")
    torch.save(d, path)
    want, got = jconvert.convert_torch_preset(path), tconvert.convert_torch_preset(path)
    assert isinstance(got, tst.VoicePreset)
    for name in ("lm_kv", "tts_kv", "neg_tts_kv"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for name in ("lm_h", "tts_h", "neg_tts_h"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.tts_kv[0].shape == (2, 1, 2, 9, HEAD_DIM)


@pytest.fixture(scope="module")
def smoke():
    tts = StreamingTTS.smoke(device="cpu")
    tts.params = _with_eos_bias(tts.params, -30.0)  # the stream runs to the text's end
    return tts


def test_streaming_tts_synthesize_equals_generate(smoke):
    """The facade on the CPU: synthesize() gives generate()'s audio for the
    same text, options and seed."""
    text = "Hello streaming world, this is a test."
    audio = smoke.synthesize(text, seed=3)
    proc = smoke.processor.process_input_with_cached_prompt(text, smoke.preset)
    out = tst.generate(smoke.cfg, smoke.params, tts_text_ids=proc.tts_text_ids,
                       preset=smoke.preset, opts=TOpts(cfg_scale=1.5, ddpm_steps=5),
                       max_len=smoke.max_len, seed=3)
    np.testing.assert_array_equal(audio, out.speech_outputs[0])
    assert len(audio) % smoke.cfg.acoustic_tokenizer_config.hop_length == 0 and len(audio) > 0


def test_streaming_tts_stream_closed_early_stops_the_worker(smoke):
    """Closing stream() after two frames ends generation: the worker thread
    is joined and the instance is free for the next stream."""
    before = threading.active_count()
    it = smoke.stream("A long text that would run for many windows. " * 4, seed=0)
    frames = [next(it), next(it)]
    it.close()
    assert threading.active_count() == before
    assert smoke._lock.acquire(blocking=False)
    smoke._lock.release()
    assert all(len(f) == smoke.cfg.acoustic_tokenizer_config.hop_length for f in frames)
    assert list(smoke.stream("Short.", seed=0, stop_check_fn=lambda: True)) == []
