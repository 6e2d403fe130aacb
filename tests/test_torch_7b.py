"""The 7B configuration's geometry on the CPU, against the JAX package.

vibevoice_tpu_torch/configs/qwen2.5_7b_32k.json differs from the 1.5B in
ways a narrow model can carry: 7 query heads a KV head (28 over 4), an
untied lm_head, and a diffusion head whose FFN is 3x its width. The
"7B-geometry" config here keeps those at CPU size: 14 query heads over 2 KV
heads (G 7, head_dim 16), hidden 224, FFN 448, 2 layers, vocab 1024, an
untied lm_head, head FFN ratio 3, tiny tokenizers. The weights come from
one numpy seed on the JAX tree's shapes (``jax.eval_shape`` of its init),
every leaf random and nonzero, and cross as numpy arrays.

- the serving path: int8 LM and lm_head (the untied head quantized into
  ``lm_head_q``), int8 KV cache, ``fuse_for_serving(quantize=True)``, a
  forced ``generate()``: tokens equal, the waveform within 2% of the peak
  (test_torch_generate's serving bound: the JAX CPU int8 fallback rounds
  the dequantized weight and the product to bf16 where kernel A keeps f32);
- one QLoRA train step over an int8 base: the loss parts within 2% and the
  adapter gradients within 3% of their peak (test_torch_train_step's int8
  bounds, for the same fallback), then the port's train step on those
  draws, whose loss is the gradient function's;
- kernel B's plain version against the Pallas kernel
  (``flash_cached_attention``, interpret mode, as tests/test_flash_attention
  runs it) at the 7B's own head layout, 28 query heads over 4 KV heads of
  128, bf16 and int8 K/V, a decode row and a prefill chunk over several
  query tiles that straddle query positions: within 1e-2 of the
  peak (the card check's bound for kernel B, bf16 outputs).
"""

import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu import configs as jconfigs
from vibevoice_tpu.finetune import loss as jloss
from vibevoice_tpu.finetune import lora as jlora
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.ops import flash_attention as jfa
from vibevoice_tpu.ops import quant as jquant

from vibevoice_tpu_torch import configs as tconfigs
from vibevoice_tpu_torch.finetune import loss as tloss
from vibevoice_tpu_torch.finetune import lora as tlora
from vibevoice_tpu_torch.finetune import train_step as tts
from vibevoice_tpu_torch.models import inference as tinf
from vibevoice_tpu_torch.models import vibevoice as tvv
from vibevoice_tpu_torch.ops import flash_attention as tfa
from vibevoice_tpu_torch.ops import quant as tquant
from vibevoice_tpu_torch.utils.params import from_jax, lora_from_jax


def geometry_7b(mod):
    """tiny_config() with the 7B's attention layout, untied lm_head and head
    FFN ratio, in the JAX package's or the port's config classes."""
    cfg = mod.tiny_config()
    lm = dataclasses.replace(cfg.decoder_config, hidden_size=224, intermediate_size=448,
                             num_attention_heads=14, num_key_value_heads=2,
                             tie_word_embeddings=False)
    head = dataclasses.replace(cfg.diffusion_head_config, hidden_size=224, head_ffn_ratio=3.0)
    return dataclasses.replace(cfg, decoder_config=lm, diffusion_head_config=head)


CFG, JCFG = geometry_7b(tconfigs), geometry_7b(jconfigs)  # the port's side, the JAX package's
HOP = CFG.acoustic_tokenizer_config.hop_length
TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
# 7 speech frames across a speech_end -> speech_start boundary, then one
# frame whose token the model's own argmax picks (-1), then eos
SCRIPT = np.array([7, 7, 7, 6, 5, 7, 7, 7, 7, -1, 2], np.int64)[:, None]
LCFG = jlora.LoraConfig(r=4)


def random_tree(seed):
    """The JAX model's tree on its init's shapes, every leaf random: matrices
    ~N(0, 0.7 / sqrt(fan_in)), norm weights 1 + 0.1 N, biases 0.05 N, layer
    scales 0.3; the two speech factors 1 and 0."""
    shapes = jax.eval_shape(lambda k: jvv.init(k, JCFG), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, x):
        key = jax.tree_util.keystr(path)
        if x.ndim == 0:
            return jnp.asarray(1.0 if "scaling" in key else 0.0, x.dtype)
        if "gamma" in key:
            return jnp.full(x.shape, 0.3, x.dtype)
        if x.ndim == 1:
            a = 1 + 0.1 * rng.randn(*x.shape) if key.endswith("['w']") else 0.05 * rng.randn(
                *x.shape)
            return jnp.asarray(a, x.dtype)
        return jnp.asarray(rng.randn(*x.shape) * (0.7 / np.sqrt(np.prod(x.shape[:-1]))), x.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def models():
    jp = random_tree(1)
    assert jp["lm_head"].shape == (1024, 224)  # untied: its own (V, H) matrix
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def test_geometry_is_the_7b_layout():
    """The narrow config keeps what the 7B JSON sets apart from the 1.5B."""
    big = tconfigs.VibeVoiceConfig.from_json_file(
        str(Path(__file__).resolve().parent.parent / "vibevoice_tpu_torch" / "configs"
            / "qwen2.5_7b_32k.json"))
    for cfg in (CFG, big):
        lm = cfg.decoder_config
        assert lm.num_attention_heads // lm.num_key_value_heads == 7
        assert not lm.tie_word_embeddings
        assert cfg.diffusion_head_config.head_ffn_ratio == 3.0
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


def test_generate_serving_matches_jax(models):
    """int8 LM and untied lm_head, int8 KV, fuse_for_serving, a forced run
    with one frame left to the model: tokens equal, waveform within 2% of
    the peak."""
    jp, tp = models
    jp = jvv.fuse_for_serving(jvv.quantize_for_inference(jp), JCFG, quantize=True)
    tp = tvv.fuse_for_serving(tvv.quantize_for_inference(tp), CFG, quantize=True)
    assert "lm_head" not in tp and tp["lm_head_q"]["w8"].shape == (224, 1024)
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 100, (1, 12)).astype(np.int64)
    ids[0, 2:6] = TOK["speech_diffusion"]
    ids[0, -1] = TOK["speech_start"]
    mask = np.zeros((1, 12), bool)
    mask[0, 2:6] = True
    bank = {"init": rng.randn(16, 1, CFG.acoustic_vae_dim).astype(np.float32),
            "vae_std": rng.randn(1).astype(np.float32),
            "vae_eps": rng.randn(1, 4, CFG.acoustic_vae_dim).astype(np.float32)}
    kw = dict(input_ids=ids, speech_tensors=rng.randn(1, 4 * HOP).astype(np.float32),
              speech_frame_valid=np.ones((1, 4), bool), speech_input_mask=mask, noise_bank=bank,
              forced_tokens=SCRIPT)
    jo = jinf.generate(JCFG, jp, tokens=jinf.SpecialTokens(**TOK),
                       opts=jinf.GenerateOptions(ddpm_steps=2, max_length=64, kv_int8=True), **kw)
    to = tinf.generate(CFG, tp, tokens=tinf.SpecialTokens(**TOK),
                       opts=tinf.GenerateOptions(ddpm_steps=2, max_length=64, kv_int8=True), **kw)
    np.testing.assert_array_equal(to.sequences, jo.sequences)
    a, b = np.asarray(jo.speech_outputs[0], np.float32), to.speech_outputs[0]
    assert a.shape == b.shape and len(a) >= 7 * HOP
    peak = np.abs(a).max()
    assert peak > 1e-3
    assert np.abs(a - b).max() <= 2e-2 * peak
    np.testing.assert_array_equal(to.reach_max_step_sample, jo.reach_max_step_sample)


def _batch():
    b, t, f = 2, 32, 4
    rng = np.random.RandomState(0)
    am = np.zeros((b, t), bool)
    am[:, 8:8 + f] = True
    valid = np.ones((b, t), bool)
    valid[1, 26:] = False  # right padding
    return jloss.Batch(
        input_ids=rng.randint(10, 100, (b, t)).astype(np.int32), attention_mask=valid,
        speech_tensors=rng.randn(b, HOP * f).astype(np.float32), speech_masks=np.ones((b, f), bool),
        speech_semantic_tensors=rng.randn(b, f, CFG.semantic_vae_dim).astype(np.float32),
        speeches_loss_input=np.ones((b,), bool), acoustic_input_mask=am, acoustic_loss_mask=am)


def _draws(key, batch, mul=4):
    """The numbers JAX's train_forward draws from `key`, for the port."""
    n, f = batch.speech_masks.shape
    b, t = batch.input_ids.shape
    hcfg = CFG.diffusion_head_config
    k_vae, k_noise, k_t = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_vae)
    std = jax.random.normal(k1, (n, 1, 1), jnp.float32)
    eps = jax.random.normal(k2, (n, f, CFG.acoustic_vae_dim), jnp.float32)
    noise = jax.random.normal(k_noise, (b * t * mul, hcfg.latent_size), jnp.float32)
    ts = jax.random.randint(k_t, (b * t * mul,), 0, hcfg.ddpm_num_steps)
    t_ = lambda a: torch.from_numpy(np.array(a))
    return tloss.Draws(t_(std).reshape(n), t_(eps), t_(noise), t_(ts).long())


def test_qlora_step_matches_jax(models):
    """One QLoRA step over the int8 base (the LM's linears int8, the untied
    lm_head dense and frozen): the loss parts and every adapter gradient
    against the JAX package, JAX's draws injected; then the port's train
    step on the same draws gives the gradient function's loss."""
    jp, tp = models
    jp = {**jp, "speech_scaling_factor": jnp.asarray(float("nan")),
          "speech_bias_factor": jnp.asarray(float("nan"))}
    tp = {**tp, "speech_scaling_factor": torch.tensor(float("nan")),
          "speech_bias_factor": torch.tensor(float("nan"))}
    jl = jlora.init_lora(jax.random.PRNGKey(1), jp, LCFG)
    rng = np.random.RandomState(7)  # non-zero B factors: every adapter leaf gets a gradient
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.randn(*x.shape) * 0.05, jnp.float32)
        if jax.tree_util.keystr(p).endswith("['b']") else x, jl)
    jp = {**jp, "lm": jquant.quantize_lm(jp["lm"], quantize_lm_head=False)}
    tp = {**tp, "lm": tquant.quantize_lm(tp["lm"])}
    batch, key = _batch(), jax.random.PRNGKey(5)

    def jloss_fn(lora):
        out = jloss.train_forward(JCFG, jlora.apply_lora(jp, lora, LCFG),
                                  jax.tree.map(jnp.asarray, batch), key, jloss.TrainOptions())
        return out.loss, out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jl)
    tl = lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    lcfg = tlora.LoraConfig(r=4)
    _, tout, tgrads = tts.make_lora_grad_fn(CFG, lcfg)(tl, tp, batch, _draws(key, batch))

    std = 1.0 / float(jout.speech_scaling_factor)  # the latents' spread
    for name in ("loss", "ce_loss", "diffusion_loss", "speech_scaling_factor",
                 "speech_bias_factor"):
        want, got = float(getattr(jout, name)), float(getattr(tout, name))
        ref = max(abs(want), std) if name == "speech_bias_factor" else abs(want)  # -mean ~ 0
        assert abs(got - want) <= 2e-2 * ref, (name, got, want)
    want = dict(tts.tree_leaves_with_path(lora_from_jax(jax.tree.map(np.asarray, jgrads),
                                                        device="cpu")))
    assert set(want) == set(tgrads)
    assert {p[0] for p in want} == {"lm_layers", "diffusion_head_layers"}
    for path, w in want.items():
        g, w = tgrads[path].numpy(), w.numpy()
        assert np.abs(w).max() > 0, path
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < 3e-2, (path, err)

    opt = tts.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state, out = tts.make_lora_train_step(CFG, opt, lcfg)(tts.init_train_state(tl, opt), tp,
                                                          batch, _draws(key, batch))
    assert state.step == 1 and float(out.loss) == float(tout.loss)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("w,lens,q_rows", [
    (1, [100, 255], None),  # decode: 7 of a tile's rows live
    (80, [64, 130], 64),    # 560 folded rows over 9 query tiles that straddle positions
])
def test_kernel_b_plain_matches_pallas_at_28_4_heads(kv, w, lens, q_rows, monkeypatch):
    """Kernel B's plain version (what the port runs on the CPU, and what
    the card holds the kernel to) against the Pallas kernel in interpret
    mode, 28 query heads over 4 KV heads, head_dim 128, S 256, bf16 q."""
    if q_rows:
        monkeypatch.setattr(jfa, "MAX_Q_ROWS", q_rows)  # force several query tiles
    b, nh, kh, d, s = len(lens), 28, 4, 128, 256
    rng = np.random.RandomState(42)
    q = jnp.asarray(rng.randn(b, w, nh, d), jnp.bfloat16)
    base = np.asarray(lens, np.int32)
    if kv == "int8":
        k8, v8 = (rng.randint(-127, 128, (b, kh, s, d)).astype(np.int8) for _ in range(2))
        ks, vs = (((rng.rand(b, kh, 1, s) + 0.5) / 127).astype(np.float32) for _ in range(2))
        jk, jv, kw = jnp.asarray(k8), jnp.asarray(v8), dict(k_scale=jnp.asarray(ks),
                                                          v_scale=jnp.asarray(vs))
        tkw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        tk, tv = torch.from_numpy(k8), torch.from_numpy(v8)
    else:
        jk, jv = (jnp.asarray(rng.randn(b, kh, s, d), jnp.bfloat16) for _ in range(2))
        kw, tkw = {}, {}
        tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                  for x in (jk, jv))
    want = jfa.flash_cached_attention(q, jk, jv, jnp.asarray(base), block_k=128, interpret=True,
                                      **kw)
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(torch.bfloat16)
    got = tfa.flash_cached_attention(tq, tk, tv, torch.from_numpy(base), **tkw)  # CPU: plain
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, w, nh, d)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    peak = np.abs(want).max()
    assert peak > 0
    assert np.abs(got - want).max() <= 1e-2 * peak
