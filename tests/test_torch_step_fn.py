"""The port's compiled frame step (make_step_fn, make_multi_step_fn, the
step_fn argument of generate) on the tiny config, on the CPU, where the
step runs eagerly: one window against the JAX package's make_multi_step_fn
from the same prompt, prefilled by each side; generate() through a step
function against generate() itself; the token choice's inverse CDF.
"""

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
from vibevoice_tpu_torch.utils.params import from_jax

CFG, JCFG = tiny_config(), jax_tiny_config()
TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
STEPS = 3  # DPM-Solver steps
B, T, MAX_LEN, E = 2, 8, 64, 4  # batch, prompt tokens, cache slots, noise-bank events
# forced tokens of one window (K, B): speech frames, a speech_end ->
# speech_start crossing, and -1 frames left to the model's own argmax
FORCED = {1: [[7, -1]], 4: [[7, 7], [7, 7], [6, -1], [5, 7]]}


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
    js = jvv.fuse_for_serving(jvv.quantize_for_inference(jp), JCFG, quantize=True)
    ts = tvv.fuse_for_serving(tvv.quantize_for_inference(tp), CFG, quantize=True)
    return {False: (jp, tp), True: (js, ts)}


def _window_inputs(k, sde, seed=0):
    """Prompt, valid mask (sample 1 two tokens shorter), ext_finish (sample 1
    stopped from outside at the window's last frame when K > 1) and the
    hooks' noise banks, from numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(10, 100, (B, T)).astype(np.int64)
    mask = np.ones((B, T), bool)
    mask[1, T - 2:] = False
    ids[0, T - 1] = ids[1, T - 3] = TOK["speech_start"]
    ext = np.zeros((k, B), bool)
    if k > 1:
        ext[k - 1, 1] = True
    d = CFG.acoustic_vae_dim
    bank = {"init": rng.randn(E, B, d).astype(np.float32)}
    if sde:
        bank["sde"] = rng.randn(E, STEPS, B, d).astype(np.float32)
    return ids, mask, ext, bank, np.asarray(FORCED[k], np.int64)


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("sde", [False, True])
@pytest.mark.parametrize("k", [1, 4])
def test_multi_step_fn_matches_jax(models, k, sde, serving):
    """One window of K frames from each side's prefill of one prompt, with
    injected forced tokens and initial latents (and SDE noise): tokens,
    finished, diffusion-event counts and cache lengths equal; the window's
    audio within 1e-5 of its peak dense (f32 summation order) and 2e-2
    serving (int8 LM + fuse_for_serving, where the JAX CPU path rounds the
    dequantized int8 weight and its product to bf16 and kernel A's plain
    version keeps f32, as in test_torch_generate.test_generate_matches_jax);
    the next frame's h_pos within 1e-5 (dense) and 3e-2 (serving) of its
    peak. Readings: audio up to 6.4e-7 and h_pos up to 6.8e-7
    dense, 1.6e-2 and 1.9e-2 serving."""
    jp, tp = models[serving]
    ids, mask, ext, bank, forced = _window_inputs(k, sde)
    jtok, ttok = jinf.SpecialTokens(**TOK), tinf.SpecialTokens(**TOK)
    jopts = jinf.GenerateOptions(ddpm_steps=STEPS, max_length=MAX_LEN, sde=sde, kv_int8=serving)
    topts = tinf.GenerateOptions(ddpm_steps=STEPS, max_length=MAX_LEN, sde=sde, kv_int8=serving)

    jcarry = jinf.prefill_fn(JCFG, jp, jnp.asarray(ids, jnp.int32), MAX_LEN, jnp.asarray(mask),
                             None, False, jtok, "audio", serving)
    jhooks = {**{n: jnp.asarray(v) for n, v in bank.items()},
              "forced": jnp.asarray(forced, jnp.int32)}
    jcarry, jout = jinf.make_multi_step_fn(JCFG, jtok, jopts, k, inject=True)(
        jp, jcarry, jax.random.PRNGKey(0), jnp.asarray(ext), jhooks)

    tcarry = tinf.prefill_fn(CFG, tp, torch.from_numpy(ids), MAX_LEN, torch.from_numpy(mask),
                             None, ttok, kv_int8=serving)
    thooks = {**{n: torch.from_numpy(v) for n, v in bank.items()},
              "forced": torch.from_numpy(forced)}
    noise = tinf.draw_noise(CFG, topts, B, torch.Generator().manual_seed(0), frames=k,
                            inject=True)
    tcarry, tout = tinf.make_multi_step_fn(CFG, ttok, topts, k, inject=True)(
        tp, tcarry, noise, torch.from_numpy(ext), thooks)

    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.finished.numpy(), np.asarray(jout.finished))
    np.testing.assert_array_equal(tout.audio_mask.numpy(), np.asarray(jout.audio_mask))
    np.testing.assert_array_equal(tcarry.n_diff.numpy(), np.asarray(jcarry.n_diff))
    np.testing.assert_array_equal(tcarry.cache.length.numpy(), np.asarray(jcarry.cache.length))
    assert tout.tokens.shape == (k, B) and tout.audio.shape[:2] == (k, B)
    a, b = np.asarray(jout.audio, np.float32), tout.audio.float().numpy()
    peak = np.abs(a).max()
    assert peak > 1e-3 and np.abs(a - b).max() <= (2e-2 if serving else 1e-5) * peak
    hj, ht = np.asarray(jcarry.h_pos, np.float32), tcarry.h_pos.float().numpy()
    assert np.abs(hj - ht).max() <= (3e-2 if serving else 1e-5) * np.abs(hj).max()


def test_step_fn_is_multi_step_fn_of_one_frame(models):
    """make_step_fn takes and returns one frame without the K axis and
    computes what make_multi_step_fn does at K = 1; host-only options
    (max_length, prefill_chunk, frames_per_dispatch) share one memo entry."""
    _, tp = models[False]
    ids, mask, ext, bank, forced = _window_inputs(1, False)
    ttok = tinf.SpecialTokens(**TOK)
    opts = tinf.GenerateOptions(ddpm_steps=STEPS, max_length=MAX_LEN)
    single = tinf.make_step_fn(CFG, ttok, opts, inject=True)
    assert single is tinf.make_step_fn(
        CFG, ttok, tinf.GenerateOptions(ddpm_steps=STEPS, max_length=128, prefill_chunk=4,
                                        frames_per_dispatch=3), inject=True)
    outs = []
    for fn, k in ((single, None), (tinf.make_multi_step_fn(CFG, ttok, opts, 1, inject=True), 1)):
        carry = tinf.prefill_fn(CFG, tp, torch.from_numpy(ids), MAX_LEN, torch.from_numpy(mask),
                                None, ttok)
        hooks = {"init": torch.from_numpy(bank["init"]), "forced": torch.from_numpy(forced)}
        ext_k = torch.from_numpy(ext)
        if k is None:
            hooks["forced"], ext_k = hooks["forced"][0], ext_k[0]
        noise = tinf.draw_noise(CFG, opts, B, torch.Generator(), frames=k, inject=True)
        carry, out = fn(tp, carry, noise, ext_k, hooks)
        outs.append((carry.h_pos, out if k is None else tinf.StepOut(*(t[0] for t in out))))
    assert outs[0][1].tokens.shape == (B,)
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    for x, y in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _prompt(seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(10, 100, (B, T)).astype(np.int64)
    ids[:, -1] = TOK["speech_start"]
    return ids


@pytest.mark.parametrize("sample", [False, True])
def test_generate_step_fn_argument_and_any_k(models, sample):
    """Without injection, the draws come from the seeded generator: the
    default generate(), generate() through make_multi_step_fn and through
    its eager call give the same bits, and so do K = 1 and K = 3 (the host
    loop draws each frame's noise in one order whatever the window). With
    `sample`, tokens are drawn (top-p 0.9) and the DPM solver is the SDE
    one, so every draw of the step is read."""
    _, tp = models[False]
    ttok = tinf.SpecialTokens(**TOK)
    kw = dict(ddpm_steps=STEPS, max_length=24, max_length_times=2.0)
    if sample:
        kw.update(do_sample=True, top_p=0.9, sde=True)
    opts3 = tinf.GenerateOptions(frames_per_dispatch=3, **kw)
    fn = tinf.make_multi_step_fn(CFG, ttok, opts3, 3)
    runs = [tinf.generate(CFG, tp, input_ids=_prompt(), tokens=ttok, opts=o, seed=4, step_fn=s)
            for o, s in ((opts3, None), (opts3, fn), (opts3, fn.eager),
                         (tinf.GenerateOptions(**kw), None))]
    assert runs[0].sequences.shape[1] > T + 6  # three windows or more
    for r in runs[1:]:
        np.testing.assert_array_equal(r.sequences, runs[0].sequences)
        for a, b in zip(r.speech_outputs, runs[0].speech_outputs):
            np.testing.assert_array_equal(a, b)
    assert fn.replays == 0  # CPU tensors never capture


def test_do_sample_same_seed_same_bits(models):
    """do_sample runs of one seed give the same bits; another seed draws
    other latents."""
    _, tp = models[False]
    ttok = tinf.SpecialTokens(**TOK)
    opts = tinf.GenerateOptions(ddpm_steps=STEPS, max_length=24, do_sample=True,
                                temperature=2.0, frames_per_dispatch=2)
    kw = dict(input_ids=_prompt(5), tokens=ttok, opts=opts, show_progress_bar=True)
    a, b, c = (tinf.generate(CFG, tp, seed=s, **kw) for s in (3, 3, 4))
    np.testing.assert_array_equal(a.sequences, b.sequences)
    for x, y in zip(a.speech_outputs, b.speech_outputs):
        np.testing.assert_array_equal(x, y)
    picked = [x is not None for x in a.speech_outputs]
    assert any(picked)
    assert any(not np.array_equal(x, y) for x, y in zip(a.speech_outputs, c.speech_outputs)
               if x is not None and y is not None) or not np.array_equal(a.sequences, c.sequences)


def test_inverse_cdf_picks_the_interval():
    """Index i exactly when u falls in [cdf[i - 1], cdf[i]), on
    probabilities that sum to 1 exactly (binary fractions); entries of
    probability 0 are never picked, at the edges and inside."""
    probs = torch.tensor([[0.0, 0.25, 0.0, 0.5, 0.125, 0.125, 0.0]])
    cdf = probs.cumsum(-1)[0]
    below = lambda x: float(np.nextafter(np.float32(x), np.float32(0)))
    for i in range(probs.shape[1]):
        lo = 0.0 if i == 0 else float(cdf[i - 1])
        if probs[0, i] == 0:
            continue
        for u in (lo, (lo + float(cdf[i])) / 2, below(cdf[i])):
            got = int(tinf._inverse_cdf(probs, torch.tensor([u]))[0])
            assert got == i, (u, got, i)
    us = torch.rand(4096, generator=torch.Generator().manual_seed(0))
    picks = tinf._inverse_cdf(probs.expand(4096, -1), us)
    assert (probs[0, picks] > 0).all()
    # unnormalised rows are scaled by their total
    half = tinf._inverse_cdf(probs * 0.5, torch.tensor([0.5]))
    assert int(half[0]) == 3
