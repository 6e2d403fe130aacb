"""The port's generate() against the JAX package's on the tiny config: the
same weights, a voice prompt, and injected randomness (noise_bank for the
VAE and initial latents, forced_tokens for a script that crosses a
speech_end -> speech_start boundary and leaves one frame to the model).
Also: frames_per_dispatch invariance, the TTS facade, and that the port
never imports jax.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu.configs import tiny_config as jax_tiny_config
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.models import vibevoice as jvv

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.models import inference as tinf
from vibevoice_tpu_torch.models import vibevoice as tvv
from vibevoice_tpu_torch.processor.processor import VibeVoiceProcessor
from vibevoice_tpu_torch.processor.text_tokenizer import FallbackTextTokenizer
from vibevoice_tpu_torch.tts import VibeVoiceTTS
from vibevoice_tpu_torch.utils.params import from_jax, init

CFG, JCFG = tiny_config(), jax_tiny_config()  # the port's side, the JAX package's
HOP = CFG.acoustic_tokenizer_config.hop_length
TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
# -1: the model's own argmax picks that frame's token
SCRIPT = np.array([7, 7, 7, 6, 5, 7, 7, -1, 7, 7, 2], np.int64)[:, None]


def _randomize(tree, seed):
    rng = np.random.RandomState(seed)

    def fill(path, x):
        if "gamma" in jax.tree_util.keystr(path):
            return jnp.full(x.shape, 0.3, x.dtype)
        if x.ndim < 2:
            return x
        return jnp.asarray(rng.randn(*x.shape) * (0.7 / np.sqrt(np.prod(x.shape[:-1]))), x.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def models():
    jp = _randomize(jvv.init(jax.random.PRNGKey(0), JCFG), 1)
    tp = from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, tp


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 100, (1, 12)).astype(np.int64)
    ids[0, 2:6] = TOK["speech_diffusion"]
    ids[0, -1] = TOK["speech_start"]
    mask = np.zeros((1, 12), bool)
    mask[0, 2:6] = True
    bank = {
        "init": rng.randn(16, 1, CFG.acoustic_vae_dim).astype(np.float32),
        "vae_std": rng.randn(1).astype(np.float32),
        "vae_eps": rng.randn(1, 4, CFG.acoustic_vae_dim).astype(np.float32),
    }
    return dict(input_ids=ids, speech_tensors=rng.randn(1, 4 * HOP).astype(np.float32),
                speech_frame_valid=np.ones((1, 4), bool), speech_input_mask=mask,
                noise_bank=bank, forced_tokens=SCRIPT)


@pytest.mark.parametrize("serving", [False, True])
def test_generate_matches_jax(models, serving):
    """Dense f32: tokens equal, waveform to f32 summation order (1e-5 of
    the peak). Serving (int8 LM + lm_head, fuse_for_serving): the JAX CPU
    path runs tiny int8 linears through its XLA fallback, which rounds the
    dequantized weight and the product to bf16, where kernel A keeps f32;
    that bf16 rounding bounds the waveform at 2% of the peak."""
    jp, tp = models
    if serving:
        jp = jvv.fuse_for_serving(jvv.quantize_for_inference(jp), JCFG, quantize=True)
        tp = tvv.fuse_for_serving(tvv.quantize_for_inference(tp), CFG, quantize=True)
    kw = _inputs()
    jo = jinf.generate(JCFG, jp, tokens=jinf.SpecialTokens(**TOK),
                       opts=jinf.GenerateOptions(ddpm_steps=3, max_length=64), **kw)
    to = tinf.generate(CFG, tp, tokens=tinf.SpecialTokens(**TOK),
                       opts=tinf.GenerateOptions(ddpm_steps=3, max_length=64), **kw)
    np.testing.assert_array_equal(to.sequences, jo.sequences)
    a, b = np.asarray(jo.speech_outputs[0], np.float32), to.speech_outputs[0]
    assert a.shape == b.shape and len(a) >= 6 * HOP
    peak = np.abs(a).max()
    assert peak > 1e-3
    assert np.abs(a - b).max() <= (2e-2 if serving else 1e-5) * peak
    np.testing.assert_array_equal(to.reach_max_step_sample, jo.reach_max_step_sample)


def test_frames_per_dispatch_invariance(models):
    """K frames per window give the same sequences and audio as K=1, with a
    batch of two where one sample finishes first and the global step bound
    cuts the last window."""
    _, tp = models
    rng = np.random.RandomState(3)
    ids = rng.randint(10, 100, (2, 8)).astype(np.int64)
    ids[:, -1] = TOK["speech_start"]
    bank = {"init": rng.randn(16, 2, CFG.acoustic_vae_dim).astype(np.float32)}
    forced = np.full((9, 2), TOK["speech_diffusion"], np.int64)
    forced[4, 0] = TOK["eos"]
    outs = [tinf.generate(CFG, tp, input_ids=ids, tokens=tinf.SpecialTokens(**TOK),
                          opts=tinf.GenerateOptions(ddpm_steps=2, max_length=64,
                                                    max_length_times=1.1, frames_per_dispatch=k),
                          noise_bank=bank, forced_tokens=forced)
            for k in (1, 4)]
    np.testing.assert_array_equal(outs[0].sequences, outs[1].sequences)
    for a, b in zip(outs[0].speech_outputs, outs[1].speech_outputs):
        np.testing.assert_array_equal(a, b)
    assert len(outs[0].speech_outputs[0]) == 4 * HOP


def test_chunked_prefill_and_forced_only_injection(models):
    """A prompt prefilled in chunks of 5 gives the same run as one whole
    prefill; with forced_tokens and no noise bank the initial latents come
    from the seeded generator, so two runs with one seed agree."""
    _, tp = models
    kw = _inputs()
    kw.pop("noise_bank")
    runs = [tinf.generate(CFG, tp, tokens=tinf.SpecialTokens(**TOK), seed=4,
                          opts=tinf.GenerateOptions(ddpm_steps=2, max_length=64, prefill_chunk=c),
                          **kw)
            for c in (2048, 5, 5)]
    np.testing.assert_array_equal(runs[1].sequences, runs[0].sequences)
    np.testing.assert_allclose(runs[1].speech_outputs[0], runs[0].speech_outputs[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(runs[2].speech_outputs[0], runs[1].speech_outputs[0])
    assert len(runs[0].speech_outputs[0]) == int((SCRIPT[:, 0] == 7).sum()) * HOP


def test_tts_synthesize_and_stream():
    """The facade over the processor: the streamed frames concatenate to
    the synthesized waveform (same seed), and sampling with top-p runs."""
    params = tvv.fuse_for_serving(tvv.quantize_for_inference(init(CFG, seed=5, device="cpu")), CFG)
    proc = VibeVoiceProcessor(tokenizer=FallbackTextTokenizer(), speech_tok_compress_ratio=HOP)
    tts = VibeVoiceTTS(CFG, params, proc, tinf.SpecialTokens(**TOK))
    voice = np.random.RandomState(1).randn(3 * HOP).astype(np.float32)
    kw = dict(voices=[voice], seed=3, ddpm_steps=2, max_length=128)
    audio = tts.synthesize("Speaker 1: hello there", **kw)
    streamed = list(tts.stream("Speaker 1: hello there", **kw))
    joined = np.concatenate([np.asarray(c, np.float32).reshape(-1) for c in streamed]) \
        if streamed else np.zeros(0, np.float32)
    np.testing.assert_array_equal(joined, audio)
    assert np.isfinite(audio).all() and len(audio) % HOP == 0
    sampled = tts.synthesize("Speaker 1: hello there", do_sample=True, top_p=0.9, **kw)
    assert np.isfinite(sampled).all()


def _tie_inputs(tok):
    """A prompt, voice and forced script under the token ids `tok`; the
    frames marked -1 are left to the sampler."""
    kw = _inputs()
    ids = kw["input_ids"].copy()
    ids[0, 2:6], ids[0, -1] = tok["speech_diffusion"], tok["speech_start"]
    d, e = tok["speech_diffusion"], tok["eos"]
    return {**kw, "input_ids": ids, "forced_tokens": np.array([d, d, -1, d, -1, d, e], np.int64)[:, None]}


def tie_order_case(models):
    """An lm_head whose columns are all the same (0.5 on hidden unit 0), so
    every logit is the same number and the whole vocabulary ties. A stable
    descending sort then orders the nucleus by token id, and top_p 0.5
    keeps ids below half the vocabulary: of the candidates only
    speech_start (id 3, also the first of the tied candidates, which is the
    one always kept) survives; speech_end, speech_diffusion and eos hold the
    three highest ids. Returns (JAX params, port params, token ids)."""
    jp, tp = models
    v, h = CFG.decoder_config.vocab_size, CFG.decoder_config.hidden_size
    head = np.zeros((v, h), np.float32)
    head[:, 0] = 0.5
    tok = dict(speech_start=3, speech_end=v - 3, speech_diffusion=v - 2, eos=v - 1)
    return {**jp, "lm_head": jnp.asarray(head)}, {**tp, "lm_head": torch.from_numpy(head)}, tok


def test_nucleus_tie_order_matches_jax(models):
    """Sampling with top_p where the probabilities tie across the nucleus
    boundary: one candidate survives in the JAX package (jnp.argsort is
    stable: among equal probabilities the lower id comes first), so both
    draws are determined and the port must pick the same tokens. PyTorch's
    unstable sort does not keep ties in id order on the CPU: without
    stable=True in _choose_tokens this test fails. The same layout runs on
    the card in tests/test_torch_cuda.py (the card against the CPU)."""
    jp, tp, tok = tie_order_case(models)
    kw = _tie_inputs(tok)
    opts = dict(ddpm_steps=2, max_length=64, do_sample=True, top_p=0.5)
    jo = jinf.generate(JCFG, jp, tokens=jinf.SpecialTokens(**tok), seed=0,
                       opts=jinf.GenerateOptions(**opts), **kw)
    to = tinf.generate(CFG, tp, tokens=tinf.SpecialTokens(**tok), seed=0,
                       opts=tinf.GenerateOptions(**opts), **kw)
    picked = np.asarray(jo.sequences)[0, kw["input_ids"].shape[1]:][[2, 4]]
    np.testing.assert_array_equal(picked, [tok["speech_start"]] * 2)
    np.testing.assert_array_equal(to.sequences, jo.sequences)


def test_port_never_imports_jax():
    code = ("import sys; import vibevoice_tpu_torch.models.inference, vibevoice_tpu_torch.tts; "
            "import vibevoice_tpu_torch.utils.params; "
            "import vibevoice_tpu_torch.finetune.train, vibevoice_tpu_torch.finetune.train_step; "
            "import vibevoice_tpu_torch.finetune.loss, vibevoice_tpu_torch.finetune.data; "
            "import vibevoice_tpu_torch.finetune.lora, vibevoice_tpu_torch.finetune.ema; "
            "import vibevoice_tpu_torch.parallel; "
            "vibevoice_tpu_torch.finetune.train.parse_args(['--synthetic_data']); "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
