"""Parity of the PyTorch port's models against the JAX package on the CPU,
at tiny_config sizes in float32, with every weight random and nonzero (the
reference zero-initialises the AdaLN and final layers, which would hide the
head). Inputs and weights come from numpy seeds and cross as numpy arrays.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu.configs import Qwen2Config as JQwen2Config
from vibevoice_tpu.configs import tiny_config as jax_tiny_config
from vibevoice_tpu.models import diffusion_head as jdh
from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import tokenizer as jtok
from vibevoice_tpu.models import vibevoice as jvv

from vibevoice_tpu_torch.configs import Qwen2Config, tiny_config
from vibevoice_tpu_torch.models import diffusion_head as tdh
from vibevoice_tpu_torch.models import qwen2 as tq
from vibevoice_tpu_torch.models import tokenizer as ttok
from vibevoice_tpu_torch.models import vibevoice as tvv
from vibevoice_tpu_torch.utils.params import from_jax

CFG, JCFG = tiny_config(), jax_tiny_config()  # the port's side, the JAX package's


def T(a):
    return torch.from_numpy(np.array(a))


def close(a, b, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def randomize(tree, seed):
    """Nonzero random weights: matrices ~N(0, 0.7/sqrt(fan_in)), layer
    scales 0.3, everything else as initialised."""
    rng = np.random.RandomState(seed)

    def fill(path, x):
        if "gamma" in jax.tree_util.keystr(path):
            return jnp.full(x.shape, 0.3, x.dtype)
        if x.ndim < 2:
            return x
        fan = int(np.prod(x.shape[:-1]))
        return jnp.asarray(rng.randn(*x.shape) * (0.7 / np.sqrt(fan)), x.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def params():
    jp = randomize(jvv.init(jax.random.PRNGKey(0), JCFG), 1)
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


# ---------------------------------------------------------------------------
# Qwen2 with the cache
# ---------------------------------------------------------------------------

LM_KW = dict(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024,
             rope_theta=10_000.0)
LM, JLM = Qwen2Config(**LM_KW), JQwen2Config(**LM_KW)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_qwen2_prefill_decode_matches_jax_flash(kv_int8):
    """Right-padded prefill, a speculative decode (advance 0), a committed
    decode, and a step of a sample whose length sits at S (the write clamps
    to S-1, as dynamic_update_slice does). Held against the JAX flash path
    (Pallas in interpret mode): hidden states in f32 to summation order;
    int8 rows bit-equal except where a row max lands on a rounding tie."""
    jp = randomize(jq.init(jax.random.PRNGKey(2), JLM), 3)
    tp = from_jax(jax.tree.map(np.asarray, jp), None, device="cpu")
    rng = np.random.RandomState(4)
    s = 512
    e1 = rng.randn(2, 7, 256).astype(np.float32)
    valid = np.ones((2, 7), bool)
    valid[1, 4:] = False
    steps = [
        (e1, valid, None),
        (rng.randn(2, 1, 256).astype(np.float32), None, np.zeros(2, np.int32)),
        (rng.randn(2, 1, 256).astype(np.float32), None, None),
    ]
    tc = tq.make_cache(LM, 2, s, torch.float32, quantized=kv_int8)
    try:
        jq.set_attention_impl("flash")
        # head_dim 64: the JAX flash path lane-pads its cache to 128
        jc = jq.make_cache(JLM, 2, s, jnp.float32, quantized=kv_int8)
        for emb, vm, adv in steps:
            hj, jc = jq.forward(JLM, jp, jnp.asarray(emb),
                                valid_mask=None if vm is None else jnp.asarray(vm), cache=jc,
                                advance=None if adv is None else jnp.asarray(adv))
            ht, tc = tq.forward(LM, tp, T(emb), valid_mask=None if vm is None else T(vm),
                                cache=tc, advance=None if adv is None else T(adv))
            rows = np.ones(hj.shape[:2], bool) if vm is None else vm
            close(np.asarray(ht)[rows], np.asarray(hj)[rows], 1e-4, 1e-4)
            np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
        # a sample at length S: its write clamps to slot S-1
        jc = jc._replace(length=jnp.asarray([s, 3], jnp.int32))
        tc = tc._replace(length=torch.tensor([s, 3], dtype=torch.int32))
        last = rng.randn(2, 1, 256).astype(np.float32)
        hj, jc = jq.forward(JLM, jp, jnp.asarray(last), cache=jc)
        ht, tc = tq.forward(LM, tp, T(last), cache=tc)
        close(ht, hj, 1e-4, 1e-4)
    finally:
        jq.set_attention_impl("auto")
    d = LM.head_dim
    for li in range(LM.num_hidden_layers):
        if kv_int8:
            diff = tc.k[li].numpy().astype(int) - np.asarray(jc.k[li])[..., :d].astype(int)
            assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
            close(tc.k_scale[li], jc.k_scale[li], 1e-5, 1e-7)
            close(tc.v_scale[li], jc.v_scale[li], 1e-5, 1e-7)
        else:
            close(tc.k[li], np.asarray(jc.k[li])[..., :d], 1e-5, 1e-5, f"k layer {li}")
            close(tc.v[li], np.asarray(jc.v[li])[..., :d], 1e-5, 1e-5, f"v layer {li}")
    assert np.abs(tc.k[0][0, :, s - 1].float().numpy()).max() > 0  # the clamped write landed


def test_quantize_kv_rows_bit_equal():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 2, 16).astype(np.float32)
    x[0, 1, 1] = 0.0
    qj, sj = jq.quantize_kv_rows(jnp.asarray(x))
    qt, st = tq.quantize_kv_rows(T(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# ---------------------------------------------------------------------------
# diffusion head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [None, "dense", "int8"])
def test_diffusion_head_matches_jax(params, fused):
    """apply, precompute_mods + apply_with_mods, and the fused FFN stack
    (kernel C's plain version against the Pallas kernel in interpret mode):
    f32, summation order only."""
    jp, tp = params
    hcfg, jhcfg = CFG.diffusion_head_config, JCFG.diffusion_head_config
    jh, th = jp["diffusion_head"], tp["diffusion_head"]
    rng = np.random.RandomState(6)
    noisy = rng.randn(4, CFG.acoustic_vae_dim).astype(np.float32)
    cond = rng.randn(4, CFG.decoder_config.hidden_size).astype(np.float32)
    ts = np.array([900.0, 500.0, 10.0], np.float32)
    if fused is None:
        t4 = np.array([1.0, 300.0, 600.0, 999.0], np.float32)
        close(tdh.apply(th, hcfg, T(noisy), T(t4), T(cond)),
              jdh.apply(jh, jhcfg, jnp.asarray(noisy), jnp.asarray(t4), jnp.asarray(cond)),
              1e-5, 1e-5)
    else:
        jh = jdh.fuse_head(jh, jhcfg, quantize=fused == "int8")
        th = tdh.fuse_head(th, hcfg, quantize=fused == "int8")
    jm = jdh.precompute_mods(jh, jhcfg, jnp.asarray(ts), jnp.asarray(cond))
    tm = tdh.precompute_mods(th, hcfg, T(ts), T(cond))
    for i in range(len(ts)):
        ref = jdh.apply_with_mods(jh, jhcfg, jnp.asarray(noisy),
                                  {"layers": [m[i] for m in jm["layers"]], "final": jm["final"][i]})
        out = tdh.apply_with_mods(th, hcfg, T(noisy), tdh.step_mods(tm, i))
        close(out, ref, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [None, "dense", "int8"])
def test_streaming_tokenizers_match_jax(params, fused):
    """Frame-by-frame vocode (acoustic decoder) and semantic re-encode with
    carried states, plain and with the T=1 stacks packed for kernel D (its
    plain version against the Pallas kernel in interpret mode), with a
    reset_state in between. f32; the TPU kernel's polynomial erf differs
    from exact erf by 1.5e-7."""
    jp, tp = params
    acfg, scfg = CFG.acoustic_tokenizer_config, CFG.semantic_tokenizer_config
    jacfg, jscfg = JCFG.acoustic_tokenizer_config, JCFG.semantic_tokenizer_config
    ja, jsem = jp["acoustic_tokenizer"], jp["semantic_tokenizer"]
    ta, tsem = tp["acoustic_tokenizer"], tp["semantic_tokenizer"]
    if fused is not None:
        q = fused == "int8"
        ja = {**ja, **jtok.fuse_hot_stages({"decoder": ja["decoder"]}, jacfg, q)}
        jsem = {**jsem, **jtok.fuse_hot_stages({"encoder": jsem["encoder"]}, jscfg, q)}
        ta = {**ta, **ttok.fuse_hot_stages({"decoder": ta["decoder"]}, acfg, q)}
        tsem = {**tsem, **ttok.fuse_hot_stages({"encoder": tsem["encoder"]}, scfg, q)}
    rng = np.random.RandomState(7)
    jds, jes = jtok.init_decoder_state(jacfg, 2), jtok.init_encoder_state(jscfg, 2)
    tds, tes = ttok.init_decoder_state(acfg, 2), ttok.init_encoder_state(scfg, 2)
    for f in range(4):
        if f == 2:
            m = np.array([True, False])
            jds, jes = jtok.reset_state(jds, jnp.asarray(m)), jtok.reset_state(jes, jnp.asarray(m))
            tds, tes = ttok.reset_state(tds, T(m)), ttok.reset_state(tes, T(m))
        lat = rng.randn(2, 1, acfg.vae_dim).astype(np.float32)
        aj, jds = jtok.decode(jacfg, ja, jnp.asarray(lat), jds)
        at, tds = ttok.decode(acfg, ta, T(lat), tds)
        close(at, aj, 1e-4, 1e-5, f"audio frame {f}")
        sj, jes = jtok.encode(jscfg, jsem, aj, jes)
        st, tes = ttok.encode(scfg, tsem, T(np.asarray(aj)), tes)
        close(st, sj, 1e-4, 1e-5, f"semantic frame {f}")
    for k in jds:
        close(tds[k], jds[k], 1e-4, 1e-5, k)


def test_voice_features_match_jax(params):
    """Batch-mode acoustic encode of a right-padded voice prompt, σ-VAE
    sample from injected noise, connector and the row-major splice."""
    jp, tp = params
    acfg = CFG.acoustic_tokenizer_config
    hop = acfg.hop_length
    rng = np.random.RandomState(8)
    wav = rng.randn(2, 5 * hop).astype(np.float32)
    wav[1, 3 * hop:] = 0.0
    std_eps = rng.randn(2).astype(np.float32)
    eps = rng.randn(2, 5, acfg.vae_dim).astype(np.float32)
    fj = jvv.encode_voice_features(JCFG, jp, jnp.asarray(wav),
                                   vae_noise=(jnp.asarray(std_eps), jnp.asarray(eps)))
    ft = tvv.encode_voice_features(CFG, tp, T(wav), vae_noise=(T(std_eps), T(eps)))
    close(ft, fj, 1e-4, 1e-5)

    embeds = rng.randn(2, 12, CFG.decoder_config.hidden_size).astype(np.float32)
    mask = np.zeros((2, 12), bool)
    mask[0, 2:7], mask[1, 1:4] = True, True
    fvalid = np.array([[True] * 5, [True] * 3 + [False] * 2])
    close(tvv.splice_speech_features(T(embeds), T(mask), ft, T(fvalid)),
          jvv.splice_speech_features(jnp.asarray(embeds), jnp.asarray(mask), fj,
                                     jnp.asarray(fvalid)), 1e-4, 1e-5)


def test_serving_quantization_bit_equal(params):
    """quantize_for_inference + fuse_for_serving: every int8 tensor and scale
    of the port equals the JAX package's (same f32 max/127, division and
    round-half-even). The port's head pack holds the gate and up weights side
    by side (wgu): their halves equal the JAX pack's wg and wu."""
    jp, tp = params
    jq_ = jvv.fuse_for_serving(jvv.quantize_for_inference(jp), JCFG, quantize=True)
    tq_ = tvv.fuse_for_serving(tvv.quantize_for_inference(tp), CFG, quantize=True)
    pairs = [(jq_["lm_head_q"], tq_["lm_head_q"])]
    for jl, tl in zip(jq_["lm"]["layers"], tq_["lm"]["layers"]):
        pairs += [(jl[g][n], tl[g][n]) for g, ns in (("attn", "qkvo"), ("mlp", ("gate", "up", "down")))
                  for n in ns]
    for j, t in pairs:
        np.testing.assert_array_equal(t["w8"].numpy(), np.asarray(j["w8"]))
        np.testing.assert_array_equal(t["scale"].numpy(), np.asarray(j["scale"]))
    packs = [(jq_["diffusion_head"]["ffn_packed"], tq_["diffusion_head"]["ffn_packed"]),
             (jq_["acoustic_tokenizer"]["decoder"]["stage0_packed"],
              tq_["acoustic_tokenizer"]["decoder"]["stage0_packed"]),
             (jq_["semantic_tokenizer"]["encoder"]["stageN_packed"],
              tq_["semantic_tokenizer"]["encoder"]["stageN_packed"])]
    for jpk, tpk in packs:
        names = [k for k in jpk.arrays if k.endswith("_q") or k.endswith("_scale")]
        assert len(names) >= 4
        for k in names:
            if k.startswith(("wg_", "wu_")):  # the gate | up halves of wgu_*
                half = tpk["wgu" + k[2:]].chunk(2, dim=-1)[k.startswith("wu_")]
                np.testing.assert_array_equal(half.numpy(), np.asarray(jpk[k]), err_msg=k)
            else:
                np.testing.assert_array_equal(tpk[k].numpy(), np.asarray(jpk[k]), err_msg=k)
