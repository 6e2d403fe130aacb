"""The port's training loss, LoRA gradients, optimizer and LoRA train step
against the JAX package on the tiny config, with JAX's random draws (σ-VAE,
diffusion noise, timesteps) injected into the port.

Tolerances: the dense-f32 base computes the same function in another
summation order: the loss to 1e-5 and every gradient leaf to 1e-4 of its
peak (the backward crosses the LM, the head and the tokenizer statistics).
The int8 base differs by the bf16 rounding of the JAX CPU int8 fallback
(its products round to bf16; the port keeps the kernels' f32 sums): the
loss to 2% (the bound test_torch_generate uses for int8 serving) and the
gradients to 3% of the peak (the fallback alone puts JAX's int8 gradients
~2% off the exact function, test_torch_finetune).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vibevoice_tpu.configs import tiny_config as jax_tiny_config
from vibevoice_tpu.finetune import loss as jloss
from vibevoice_tpu.finetune import lora as jlora
from vibevoice_tpu.finetune import train_step as jts
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.ops import quant as jquant

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.finetune import loss as tloss
from vibevoice_tpu_torch.finetune import lora as tlora
from vibevoice_tpu_torch.finetune import train_step as tts
from vibevoice_tpu_torch.ops import quant as tquant
from vibevoice_tpu_torch.utils.params import from_jax, lora_from_jax

CFG, JCFG = tiny_config(), jax_tiny_config()  # the port's side, the JAX package's
HOP = CFG.acoustic_tokenizer_config.hop_length
LCFG = jlora.LoraConfig(r=4)


def _randomize(tree, seed):
    rng = np.random.RandomState(seed)

    def fill(path, x):
        if "gamma" in jax.tree_util.keystr(path):
            return jnp.full(x.shape, 0.3, x.dtype)
        if x.ndim < 2:
            return x
        return jnp.asarray(rng.randn(*x.shape) * (0.7 / np.sqrt(np.prod(x.shape[:-1]))), x.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


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
    """The numbers jax train_forward draws from `key` (loss.py:174, tokenizer
    sample_latents 'gaussian', loss.py:278-279)."""
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


@pytest.fixture(scope="module")
def setup():
    jp = dict(_randomize(jvv.init(jax.random.PRNGKey(0), JCFG), 1))
    jp["speech_scaling_factor"] = jnp.asarray(float("nan"))
    jp["speech_bias_factor"] = jnp.asarray(float("nan"))
    tp = from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    jl = jlora.init_lora(jax.random.PRNGKey(1), jp, LCFG)
    return jp, tp, jl


def _leaves(tree):
    return dict(tts.tree_leaves_with_path(tree))


@pytest.mark.parametrize("int8", [False, True])
def test_train_forward_and_lora_grads_match_jax(setup, int8):
    """train_forward's loss parts and the LoRA gradients, JAX's draws
    injected. The int8 case also runs the memory levers (remat, chunked CE,
    a head position budget), which are exact."""
    jp, tp, jl = setup
    rng = np.random.RandomState(7)  # non-zero B factors: every adapter leaf gets a gradient
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.randn(*x.shape) * 0.05, jnp.float32)
        if jax.tree_util.keystr(p).endswith("['b']") else x, jl)
    opts = dict(remat=True, ce_chunk_size=8, head_position_budget=8) if int8 else {}
    if int8:
        jp = {**jp, "lm": jquant.quantize_lm(jp["lm"], quantize_lm_head=False)}
        tp = {**tp, "lm": tquant.quantize_lm(tp["lm"])}
    batch, key = _batch(), jax.random.PRNGKey(5)

    def jloss_fn(lora):
        out = jloss.train_forward(JCFG, jlora.apply_lora(jp, lora, LCFG),
                                  jax.tree.map(jnp.asarray, batch), key,
                                  jloss.TrainOptions(**opts))
        return out.loss, out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jl)
    grad_fn = tts.make_lora_grad_fn(CFG, tlora.LoraConfig(r=4), tloss.TrainOptions(**opts))
    _, tout, tgrads = grad_fn(lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu"), tp,
                              batch, _draws(key, batch))

    tol_loss, tol_grad = (2e-2, 3e-2) if int8 else (1e-5, 1e-4)
    std = 1.0 / float(jout.speech_scaling_factor)  # the latents' spread
    for name in ("loss", "ce_loss", "diffusion_loss", "speech_scaling_factor",
                 "speech_bias_factor", "ce_max", "ce_accuracy"):
        want, got = float(getattr(jout, name)), float(getattr(tout, name))
        ref = max(abs(want), std) if name == "speech_bias_factor" else abs(want)  # -mean ~ 0
        assert abs(got - want) <= tol_loss * ref, (name, got, want)
    for name in ("ce_token_count", "speech_frame_count"):
        assert int(getattr(tout, name)) == int(getattr(jout, name))
    want = _leaves(lora_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu"))
    assert set(want) == set(tgrads)
    for path, w in want.items():
        g, w = tgrads[path].numpy(), w.numpy()
        assert np.abs(w).max() > 0, path
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < tol_grad, (path, err)


def test_lora_train_steps_match_jax(setup):
    """Three make_lora_train_step updates on a dense f32 base against the
    JAX step: the learning rate is 0 on step 1 (nothing moves), the B
    factors move on step 2 and the A factors first get gradients on step 3.
    Adam divides those first, tiny A gradients by sqrt(v) + eps, where the
    f32 summation order moves an element by up to ~0.2% of one step; so the
    adapters agree to 1% of the learning rate (atol 1e-5 at lr 1e-3)."""
    jp, tp, jl = setup
    batch = _batch()
    jopt = jts.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=20)
    topt = tts.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=20)
    jstep = jax.jit(jts.make_lora_train_step(JCFG, jopt, LCFG))
    tstep = tts.make_lora_train_step(CFG, topt, tlora.LoraConfig(r=4))
    jstate = jts.init_train_state(jl, jopt)
    tl0 = lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    tstate = tts.init_train_state(tl0, topt)
    jb = jax.tree.map(jnp.asarray, batch)
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        jstate, jout = jstep(jstate, jp, jb, key)
        tstate, tout = tstep(tstate, tp, batch, _draws(key, batch))
        assert abs(float(tout.loss) - float(jout.loss)) <= 1e-5 * abs(float(jout.loss))
        want = _leaves(lora_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu"))
        got = _leaves(tstate.params)
        for path, w in want.items():
            np.testing.assert_allclose(got[path].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                       err_msg=str((i, path)))
        moved = max(float((got[p] - x).abs().max()) for p, x in _leaves(tl0).items()
                    if p[-1] == "b")
        assert (moved == 0) if i == 0 else (moved > 1e-4), (i, moved)
    assert tstate.step == 3 and tstate.opt_state.count == 3


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax(accum):
    """The written-out optimizer against the optax chain the JAX package
    builds (warmup cosine, global-norm clip, adamw, set_to_zero on frozen
    leaves, MultiSteps), on a small tree over five updates with gradients
    large enough to clip: equal to f32 order."""
    rng = np.random.RandomState(accum)
    params = {"lm": {"embed": rng.randn(6, 4), "layers": [{"w": rng.randn(4, 3)}]},
              "diffusion_head": {"w": rng.randn(3, 5), "b": rng.randn(5)}}
    params = jax.tree.map(lambda x: x.astype(np.float32), params)
    filt = jts.build_trainable_filter()  # the embedding is frozen
    kw = dict(learning_rate=0.05, warmup_steps=2, total_steps=6, accumulation_steps=accum,
              trainable_filter=filt, grad_clip=1.0)
    jopt, topt = jts.make_optimizer(**kw), tts.make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = lora_from_jax(params, device="cpu")
    tstate = topt.init(tparams)
    for step in range(5 * accum):
        grads = jax.tree.map(lambda x: (rng.randn(*x.shape) * 3).astype(np.float32), params)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        new, tstate = topt.update(_leaves(lora_from_jax(grads, device="cpu")), tstate, tparams)
        tparams = tts.tree_replace(tparams, new)
        want = lora_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        for path, w in _leaves(want).items():
            np.testing.assert_allclose(_leaves(tparams)[path].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=str((step, path)))
    np.testing.assert_array_equal(tparams["lm"]["embed"].numpy(), params["lm"]["embed"])


def test_lora_from_jax_wants_a_card():
    """Without device="cpu" the LoRA tree is built on the card, as from_jax
    builds the weights, and the call raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lora_from_jax({"a": np.zeros((2, 2), np.float32)})


def test_component_and_filtered_full_steps(setup):
    """make_component_train_step over a frozen int8 LM (only the head and
    connectors are differentiated) against make_train_step with the LM and
    embeddings frozen by build_trainable_filter on the dense base: the loss
    agrees to the int8 weights' error (5%, as test_qlora), the trained
    components move on step 2, and the frozen leaves do not move."""
    _, tp, _ = setup
    tp = {**tp, "speech_scaling_factor": torch.tensor(1.0), "speech_bias_factor": torch.tensor(0.0)}
    batch, nl = _batch(), CFG.decoder_config.num_hidden_layers
    opts = tloss.TrainOptions()
    filt = tts.build_trainable_filter(train_connectors=True, lm_layers_to_freeze=tuple(range(nl)))
    dopt = tts.make_optimizer(warmup_steps=1, trainable_filter=filt)
    dstep = tts.make_train_step(CFG, dopt, opts, trainable_filter=filt)
    dstate, dout = dstep(tts.init_train_state(tp, dopt), batch, _draws(jax.random.PRNGKey(2), batch))
    # trainable: the head, the connectors and (as in the JAX filter) the LM's final norm
    assert all(p[0] in ("diffusion_head", "acoustic_connector", "semantic_connector")
               or p[:2] == ("lm", "final_norm") for p in dstate.opt_state.mu)

    keys = ("diffusion_head", "acoustic_connector", "semantic_connector")
    qp = {**tp, "lm": tquant.quantize_lm(tp["lm"])}
    sub, frozen = {k: qp[k] for k in keys}, {k: v for k, v in qp.items() if k not in keys}
    opt = tts.make_optimizer(warmup_steps=1)
    step = tts.make_component_train_step(CFG, opt, opts)
    state, out = step(tts.init_train_state(sub, opt), frozen, batch,
                      _draws(jax.random.PRNGKey(2), batch))
    assert np.isfinite(float(out.loss))
    assert abs(float(out.loss) - float(dout.loss)) <= 0.05 * abs(float(dout.loss))
    state, _ = step(state, frozen, batch, _draws(jax.random.PRNGKey(3), batch))  # lr > 0
    w = lambda p: p["diffusion_head"]["layers"][0]["ffn"]["gate"]["w"]
    assert float((w(state.params) - w(sub)).abs().max()) > 0
    dstate, _ = dstep(dstate, batch, _draws(jax.random.PRNGKey(3), batch))
    assert float((w(dstate.params) - w(tp)).abs().max()) > 0
    lm_w = lambda p: p["lm"]["layers"][0]["attn"]["q"]["w"]
    assert torch.equal(lm_w(dstate.params), lm_w(tp))
