"""The rest of the JAX package's surface in the port, against the JAX
package on the CPU: int8 quantization of the diffusion head and the
tokenizers and the packed int8 LM projections (``LM_PACK=1``), dynamic
thresholding of the DPM solver for every algorithm type, the "dots" remat
policy (one device, a gloo world of 2 at tp 2 and under FSDP, the GPipe
forward), ``lm_head_logits``, ``kl_loss``, the timestep samplers and the
profiling helpers.

The models are tiny_config, widened to 512 (hidden size and the
tokenizers' widest stage, 128 filters) where the JAX package's
quantization rule needs both dims of a linear divisible by 512. Weights
come from numpy seeds. Tolerances, each of the peak: trees bit-equal; the
solver 1e-5 (f32, summation order); int8 runs 2e-2 (the JAX CPU int8
fallback rounds its products to bf16, where the port's plain kernel A
keeps f32 sums: tests/test_torch_generate.py); f32 training 1e-5 for the
loss and 1e-4 for gradients (tests/test_torch_train_step.py).
"""

import contextlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu import configs as JC
from vibevoice_tpu.finetune import lora as jlora
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import tokenizer as jtok
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.ops import quant as jquant
from vibevoice_tpu.schedule import dpm_solver as jdpm
from vibevoice_tpu.utils import profiling as jprof

import torch_workers as W
from test_torch_hf_interop import _randomize
from test_torch_parallel import _draws, _with_buffers
from test_torch_parallel import _batch as _parallel_batch
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.finetune import loss as tloss
from vibevoice_tpu_torch.finetune import lora as tlora
from vibevoice_tpu_torch.finetune import train_step as tts
from vibevoice_tpu_torch.models import inference as tinf
from vibevoice_tpu_torch.models import qwen2 as tq
from vibevoice_tpu_torch.models import tokenizer as ttok
from vibevoice_tpu_torch.models import vibevoice as tvv
from vibevoice_tpu_torch.ops import quant as tquant
from vibevoice_tpu_torch.schedule import dpm_solver as tdpm
from vibevoice_tpu_torch.schedule.timestep_sampler import LogitNormalSampler, UniformSampler
from vibevoice_tpu_torch.utils import profiling as tprof
from vibevoice_tpu_torch.utils.params import from_jax, lora_from_jax

TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
# -1: the model's own argmax picks that frame's token
SCRIPT = np.array([7, 7, 7, 6, 5, 7, 7, -1, 7, 7, 2], np.int64)[:, None]
INT8_TOL = 2e-2
WIDE = dict(hidden_size=512, n_filters=128)
ALL = ("lm", "lm_head", "diffusion_head", "tokenizers")


_MODELS = {}


def _batch(cfg):
    """Two samples of 32 tokens, the second right-padded from 26."""
    return _parallel_batch(cfg, b=2, lengths=(32, 26))


def models(name):
    """(port cfg, JAX cfg, JAX params, port params): "wide" or "tiny"."""
    if name not in _MODELS:
        kw = WIDE if name == "wide" else {}
        cfg, jcfg = TC.tiny_config(**kw), JC.tiny_config(**kw)
        jp = dict(_randomize(jax.eval_shape(lambda k: jvv.init(k, jcfg), jax.random.PRNGKey(0)),
                             1))
        _MODELS[name] = (cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp), cfg,
                                                 device="cpu"))
    return _MODELS[name]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _quantized_equal(jtree, ttree):
    """Both trees have the same key paths; every int8 leaf and every scale
    (and, in a packed tree, every bias) is bit-equal. Returns the int8 paths."""
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert set(jl) == set(tl), set(jl) ^ set(tl)
    q = [p for p in tl if p[-1] in ("w8", "scale") or "qkv" in p or "gateup" in p]
    for p in q:
        assert _np(tl[p]).dtype == _np(jl[p]).dtype, p
        np.testing.assert_array_equal(_np(tl[p]), _np(jl[p]), err_msg=str(p))
    return [p for p in q if p[-1] == "w8"]


def test_quantize_for_inference_matches_jax():
    """quantize_for_inference with all four components: the JAX package's
    tree (the same key paths; int8 weights bit-equal, scales equal). Only
    the linears whose dims are both multiples of 512 are int8: the head's
    FFNs (512-1536-512) and AdaLN (512 x 1536), the decoder's stage 0 and
    the encoders' last stage (512-2048-512); smaller ones stay dense."""
    cfg, jcfg, jp, tp = models("wide")
    w8 = _quantized_equal(jvv.quantize_for_inference(jp, ALL), tvv.quantize_for_inference(tp, ALL))
    head = [p for p in w8 if p[0] == "diffusion_head"]
    assert len(head) == 2 * 4  # two layers: gate, up, down, adaln
    toks = {(p[0], p[1], p[3]) for p in w8 if p[0].endswith("tokenizer")}
    assert toks == {("acoustic_tokenizer", "decoder", 0), ("acoustic_tokenizer", "encoder", 2),
                    ("semantic_tokenizer", "encoder", 2)}
    # the tokenizers' small stages stay dense
    q = tquant.quantize_tokenizer(tp["acoustic_tokenizer"])
    assert "w" in q["encoder"]["stages"][0][0]["ffn"]["fc1"]


def test_pack_lm_projections_matches_jax():
    """pack_lm_projections on an int8 LM (and, through fuse_for_serving,
    only with LM_PACK=1): the JAX package's qkv / gateup entries bit for
    bit, the separate entries gone; a bf16 LM is left as it is."""
    cfg, jcfg, jp, tp = models("tiny")
    jl = jquant.pack_lm_projections(jquant.quantize_lm(jp["lm"], quantize_lm_head=False))
    tl = tquant.pack_lm_projections(tquant.quantize_lm(tp["lm"]))
    _quantized_equal(jl, tl)
    layer = tl["layers"][0]
    assert set(layer["attn"]) == {"qkv", "o"} and set(layer["mlp"]) == {"gateup", "down"}
    assert tquant.pack_lm_projections(tp["lm"])["layers"][0] is tp["lm"]["layers"][0]
    q = tvv.quantize_for_inference(tp)
    assert "q" in tvv.fuse_for_serving(q, cfg)["lm"]["layers"][0]["attn"]
    with _env(LM_PACK="1"):
        assert "qkv" in tvv.fuse_for_serving(q, cfg)["lm"]["layers"][0]["attn"]
        assert "q" in tvv.fuse_for_serving(tp, cfg)["lm"]["layers"][0]["attn"]  # bf16 LM


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _inputs(cfg):
    hop = cfg.acoustic_tokenizer_config.hop_length
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 100, (1, 12)).astype(np.int64)
    ids[0, 2:6] = TOK["speech_diffusion"]
    ids[0, -1] = TOK["speech_start"]
    mask = np.zeros((1, 12), bool)
    mask[0, 2:6] = True
    bank = {"init": rng.randn(16, 1, cfg.acoustic_vae_dim).astype(np.float32),
            "vae_std": rng.randn(1).astype(np.float32),
            "vae_eps": rng.randn(1, 4, cfg.acoustic_vae_dim).astype(np.float32)}
    return dict(input_ids=ids, speech_tensors=rng.randn(1, 4 * hop).astype(np.float32),
                speech_frame_valid=np.ones((1, 4), bool), speech_input_mask=mask,
                noise_bank=bank, forced_tokens=SCRIPT)


def _generate_both(cfg, jcfg, jp, tp, **gen):
    kw = _inputs(cfg)
    jo = jinf.generate(jcfg, jp, tokens=jinf.SpecialTokens(**TOK),
                       opts=jinf.GenerateOptions(ddpm_steps=3, max_length=64), **kw)
    to = tinf.generate(cfg, tp, tokens=tinf.SpecialTokens(**TOK),
                       opts=tinf.GenerateOptions(ddpm_steps=3, max_length=64), **kw, **gen)
    np.testing.assert_array_equal(to.sequences, jo.sequences)
    a, b = np.asarray(jo.speech_outputs[0], np.float32), to.speech_outputs[0]
    hop = cfg.acoustic_tokenizer_config.hop_length
    assert a.shape == b.shape and len(a) >= 6 * hop
    peak = np.abs(a).max()
    assert peak > 1e-3
    assert np.abs(a - b).max() <= INT8_TOL * peak
    return to


def test_generate_int8_head_and_tokenizers_matches_jax(monkeypatch):
    """The forced generate() under a noise bank with the LM, lm_head,
    diffusion head and tokenizers int8, against the JAX package's same run
    (tokens equal, audio within INT8_TOL of the peak). The int8 tokenizer
    FFNs stay unfused, so each frame runs the decoder's stage 0 (1 row) and
    the semantic encoder's last stage (1 row) through kernel A (quant.mm),
    in generate() and in the frame step's eager body alike; the head's
    AdaLN projections run at K x 2B rows (3 steps x 2: 6)."""
    cfg, jcfg, jp, tp = models("wide")
    jq8, tq8 = jvv.quantize_for_inference(jp, ALL), tvv.quantize_for_inference(tp, ALL)
    assert "stage0_packed" not in tvv.fuse_vocoder(tq8, cfg)["acoustic_tokenizer"]["decoder"]
    rows = {}
    plain = tquant.int8_matmul

    def counted(x, w8, scale):
        key = tuple(w8.shape)
        rows.setdefault(key, set()).add(x.reshape(-1, w8.shape[0]).shape[0])
        return plain(x, w8, scale)

    monkeypatch.setattr(tquant, "int8_matmul", counted)
    _generate_both(cfg, jcfg, jq8, tq8)
    assert 1 in rows[(512, 2048)] and 1 in rows[(2048, 512)]  # the T = 1 stages
    assert 6 in rows[(512, 1536)]  # AdaLN at K x 2B rows
    rows.clear()
    kw = _inputs(cfg)
    step = tinf.make_step_fn(cfg, tinf.SpecialTokens(**TOK),
                             tinf.GenerateOptions(ddpm_steps=3, max_length=64), inject=True)
    eager = tinf.generate(cfg, tq8, tokens=tinf.SpecialTokens(**TOK),
                          opts=tinf.GenerateOptions(ddpm_steps=3, max_length=64),
                          step_fn=step.eager, **kw)
    assert 1 in rows[(512, 2048)] and 1 in rows[(2048, 512)]
    assert eager.sequences.shape[1] > kw["input_ids"].shape[1]


def test_generate_lm_pack_matches_jax():
    """LM_PACK=1: both packages' fuse_for_serving pack the int8 LM's q|k|v
    and gate|up; the forced generate() equals the JAX package's (tokens
    equal, audio within INT8_TOL) and the port's unpacked run (tokens
    equal; audio to f32 summation order, 1e-5 of the peak: the packed
    product's columns are the separate products' columns)."""
    cfg, jcfg, jp, tp = models("tiny")
    jq8, tq8 = jvv.quantize_for_inference(jp), tvv.quantize_for_inference(tp)
    unpacked = tvv.fuse_for_serving(tq8, cfg)
    with _env(LM_PACK="1"):
        jpk, tpk = jvv.fuse_for_serving(jq8, jcfg), tvv.fuse_for_serving(tq8, cfg)
    assert "qkv" in jpk["lm"]["layers"][0]["attn"] and "gateup" in tpk["lm"]["layers"][1]["mlp"]
    packed = _generate_both(cfg, jcfg, jpk, tpk)
    ref = tinf.generate(cfg, unpacked, tokens=tinf.SpecialTokens(**TOK),
                        opts=tinf.GenerateOptions(ddpm_steps=3, max_length=64), **_inputs(cfg))
    np.testing.assert_array_equal(packed.sequences, ref.sequences)
    a, b = ref.speech_outputs[0], packed.speech_outputs[0]
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


def test_serving_engine_takes_a_packed_lm():
    """ServingEngine over an int8 LM packed by LM_PACK=1 serves two
    requests at once with the tokens of the same engine unpacked and
    audio to f32 summation order (1e-5 of the peak)."""
    from vibevoice_tpu_torch.serving import Request, ServingEngine
    from vibevoice_tpu_torch.utils.params import speaking

    cfg, _, _, tp = models("tiny")
    toks = tinf.SpecialTokens(**TOK)
    q8 = speaking(tvv.fuse_for_serving(tvv.quantize_for_inference(tp), cfg), toks)
    runs = []
    for params in (q8, {**q8, "lm": tquant.pack_lm_projections(q8["lm"])}):
        eng = ServingEngine(cfg, params, tokens=toks, max_batch=2, max_len=64,
                            opts=tinf.GenerateOptions(ddpm_steps=2, max_length=64),
                            frames_per_dispatch=2)
        draws = {}

        def draw(eng=eng, draws=draws):  # each slot its request's own draws
            init = torch.zeros(2, 2, cfg.acoustic_vae_dim)
            for i, h in enumerate(eng.slots):
                if h is not None:
                    if h not in draws:
                        g = torch.Generator().manual_seed(h.request.seed)
                        draws[h] = torch.randn(64, cfg.acoustic_vae_dim, generator=g)
                    s = int(eng.slot_steps[i])
                    init[:, i] = draws[h][s:s + 2]
            return tinf.FrameNoise(init, None, None)

        eng._draw_noise = draw
        try:
            reqs = []
            for i in range(2):
                ids = np.random.RandomState(i).randint(10, 100, (1, 6 + 2 * i)).astype(np.int64)
                ids[0, -1] = TOK["speech_start"]
                reqs.append(eng.submit(Request(input_ids=ids, valid_mask=np.ones_like(ids, bool),
                                               seed=i)))
            runs.append([(h.result(timeout=120), list(h.tokens)) for h in reqs])
        finally:
            eng.shutdown()
    for (a, ta), (b, tb) in zip(*runs):
        assert ta == tb and len(a) == len(b) > 0
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


def test_fuse_refuses_an_int8_head_in_both():
    """An int8 diffusion head cannot be packed for kernel C: the JAX
    package's fuse_head fails on the missing dense weight, the port's
    refuses by name; the int8 head stays unfused and runs through A."""
    cfg, jcfg, jp, tp = models("wide")
    jq8 = jvv.quantize_for_inference(jp, ("diffusion_head",))
    tq8 = tvv.quantize_for_inference(tp, ("diffusion_head",))
    with pytest.raises(KeyError):
        jvv.fuse_for_serving(jq8, jcfg)
    with pytest.raises(ValueError, match="int8 head"):
        tvv.fuse_for_serving(tq8, cfg)


ALGOS = ("dpmsolver++", "sde-dpmsolver++", "dpmsolver", "sde-dpmsolver")


@pytest.mark.parametrize("thresholding", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_sample_matches_jax(algo, thresholding):
    """The multistep solve over a toy model whose x0 estimates reach past 1
    (so that dynamic thresholding clamps them), with injected SDE noise,
    for every algorithm type (the epsilon-space ones through the x0 round
    trip), with and without thresholding: JAX's lax.scan to 1e-5 of the
    peak. The epsilon-space ODE table's last step multiplies x and m0 by
    ~3,149 and subtracts, so f32 rounding grows: both packages' solves lie
    2.0e-4 / 2.5e-4 of the peak from a float64 solve of the same function,
    and they are held to 5e-4 of each other."""
    rng = np.random.RandomState(11)
    n, b, d = 10, 3, 16
    kw = dict(algorithm_type=algo, final_sigmas_type="zero" if algo.endswith("++") else "sigma_min")
    jc, tc = jdpm.make_solver(n, **kw), tdpm.make_solver(n, **kw)
    w = rng.randn(d, d).astype(np.float32)
    x0 = rng.randn(b, d).astype(np.float32)
    noise = rng.randn(n, b, d).astype(np.float32) if algo.startswith("sde") else None
    kw = dict(thresholding=thresholding, dynamic_thresholding_ratio=0.9, sample_max_value=2.5,
              eps_space=algo in ("dpmsolver", "sde-dpmsolver"))

    def jhead(x, t):
        return 3.0 * jnp.tanh(x @ jnp.asarray(w)) * (t[:, None] / 1000 + 0.5)

    def thead(x, t):
        return 3.0 * torch.tanh(x @ torch.from_numpy(w)) * (t[:, None] / 1000 + 0.5)

    ref = jdpm.sample(jc, jhead, jnp.asarray(x0),
                      noise=None if noise is None else jnp.asarray(noise), **kw)
    out = tdpm.sample(tc, thead, torch.from_numpy(x0),
                      noise=None if noise is None else torch.from_numpy(noise), **kw)
    ref = np.asarray(ref)
    tol = 5e-4 if algo == "dpmsolver" else 1e-5
    assert np.abs(out.numpy() - ref).max() <= tol * np.abs(ref).max()
    if thresholding:  # it changed the trajectory
        off = tdpm.sample(tc, thead, torch.from_numpy(x0),
                          noise=None if noise is None else torch.from_numpy(noise))
        assert (off - out).abs().max() > 1e-3


def test_threshold_x0_matches_jax():
    """_threshold_x0 (the quantile, its floor at 1 and cap, the clamp) on
    samples spread across the floor."""
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 3, 8) * np.array([0.2, 1.0, 3.0, 10.0])[:, None, None]).astype(np.float32)
    for ratio, cap in ((0.995, 1.0), (0.9, 4.0), (0.5, 100.0)):
        ref = np.asarray(jdpm._threshold_x0(jnp.asarray(x), ratio, cap))
        np.testing.assert_allclose(tdpm._threshold_x0(torch.from_numpy(x), ratio, cap).numpy(),
                                   ref, rtol=1e-6, atol=1e-7)


def test_unknown_remat_policy_and_component_refused():
    """An unknown remat policy (the LM forward, the loss) and an unknown
    quantize_for_inference component raise ValueError naming them."""
    cfg, _, _, tp = models("tiny")
    with pytest.raises(ValueError, match="components"):
        tvv.quantize_for_inference(tp, ("lm", "vocoder"))
    x = torch.zeros(1, 4, cfg.decoder_config.hidden_size)
    with pytest.raises(ValueError, match="remat_policy"):
        tq.forward(cfg.decoder_config, tp["lm"], x, remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        tloss.train_forward(cfg, tp, None, opts=tloss.TrainOptions(remat_policy="all"))


@pytest.mark.parametrize("int8", [False, True])
def test_dots_loss_and_grads_match(int8):
    """remat with remat_policy="dots" (the matmul outputs kept, the rest
    recomputed) on the LM layers and the diffusion head: the loss and the
    LoRA gradients equal the port's run without remat (the same function;
    1e-6 of the peak), over a dense f32 base and an int8 one (QLoRA: the
    int8 plain version's products are kept too). The run without remat is
    JAX's (tests/test_torch_train_step.py), and the LM forward with "dots"
    is held against JAX's "dots" in
    tests/test_torch_finetune.py::test_no_cache_forward_matches_jax."""
    cfg, _, jp, tp = models("tiny")
    jp, tp = _with_buffers(jp, tp)
    lcfg = jlora.LoraConfig(r=4)
    rng = np.random.RandomState(7)  # non-zero B factors: every adapter leaf gets a gradient
    jl = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape) * 0.05, jnp.float32),
                      jax.eval_shape(lambda k: jlora.init_lora(k, jp, lcfg),
                                     jax.random.PRNGKey(1)))
    if int8:
        tp = {**tp, "lm": tquant.quantize_lm(tp["lm"])}
    batch, key = _batch(cfg), jax.random.PRNGKey(5)
    dots = dict(remat=True, remat_policy="dots")
    tl = lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    runs = {}
    for name, opts in (("dots", dots), ("none", {})):
        grad_fn = tts.make_lora_grad_fn(cfg, tlora.LoraConfig(r=4), tloss.TrainOptions(**opts))
        loss, _, grads = grad_fn(tl, tp, batch, _draws(cfg, key, batch))
        runs[name] = (float(loss), grads)
    (loss, grads), (loss0, grads0) = runs["dots"], runs["none"]
    assert abs(loss - loss0) <= 1e-6 * abs(loss0)
    for path, g0 in grads0.items():
        assert np.abs(grads[path].numpy() - g0.numpy()).max() <= 1e-6 * g0.abs().max(), path


@pytest.fixture(scope="module")
def dots_world(tmp_path_factory):
    """One gloo world of 2 running three jobs with remat and "dots": two
    training steps (full fine-tune, f32) at tensor parallel 2 (the f32
    all-reduces after o and down inside each recomputed block) and under
    FSDP over dp 2 (each layer's shards gathered inside its block, again in
    the backward), and the GPipe forward over 2 stages; beside each, the
    port's one-device run without remat."""
    cfg, _, jp, tp = models("tiny")
    jp, tp = _with_buffers(jp, tp)
    batch = _batch(cfg)
    draws = _draws(cfg, jax.random.PRNGKey(1), batch)
    tb = tloss.Batch(*(np.asarray(x) for x in batch))
    rng = np.random.RandomState(6)
    b, t, h = 4, 16, cfg.decoder_config.hidden_size
    valid = np.ones((b, t), bool)
    valid[1, 11:] = False
    pp_args = (cfg.decoder_config, tp["lm"], rng.randn(b, t, h).astype(np.float32), valid,
               rng.randn(b, t, h).astype(np.float32), 2)
    jobs = {name: (spec, W.train_steps, (cfg, tp, tb, draws, 2, fsdp, None, None, None, True,
                                         "dots"))
            for name, spec, fsdp in (("tp", ("mesh", 1, 2), 0), ("fsdp", ("mesh", 2, 1), 1024))}
    jobs["pp"] = (("pp", 2, 1), W.pp_forward, pp_args + (True, "dots"))
    ranks = W.run_world(2, tmp_path_factory.mktemp("dots"), jobs, timeout=240.0)
    dense = {"train": W.train_steps(None, cfg, tp, tb, draws, 2, 0),
             "pp": W.pp_forward(None, *pp_args)}
    return dense, ranks


def test_dots_in_gloo_worlds(dots_world):
    """Tensor parallel 2 and FSDP over dp 2 with remat and "dots": the
    losses and the updated tree equal the port's one-device run without
    remat (1e-5 of the peak), as test_torch_parallel holds remat=True."""
    dense, ranks = dots_world
    for r in ranks:
        for name in ("tp", "fsdp"):
            got = r[name]
            assert np.allclose(got["losses"], dense["train"]["losses"], rtol=1e-5, atol=0), \
                (name, got["losses"], dense["train"]["losses"])
            for p, x in got["tree"].items():
                want = dense["train"]["tree"][p]
                assert np.abs(x - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30), (name, p)
    assert ranks[0]["fsdp"]["fsdp_split"]


def test_gpipe_forward_with_dots(dots_world):
    """The GPipe forward over 2 stages with remat and "dots" against the
    dense forward without remat: the hidden states equal, the gradients of
    x and of every layer leaf within 1e-5 of the peak."""
    dense, ranks = dots_world
    dense = dense["pp"]
    for r in ranks:
        got = r["pp"]
        assert np.abs(got["h"] - dense["h"]).max() <= 1e-5 * np.abs(dense["h"]).max()
        assert np.abs(got["dx"] - dense["dx"]).max() <= 1e-5 * np.abs(dense["dx"]).max()
    stage_grads = {**ranks[0]["pp"]["grads"]}
    for name, g in ranks[1]["pp"]["grads"].items():
        stage_grads[name] = np.concatenate([stage_grads[name], g], axis=1)
    for name, g in dense["grads"].items():
        assert np.abs(stage_grads[name] - g).max() <= 1e-5 * np.abs(g).max(), name


def test_lm_head_logits_and_kl_loss_match_jax():
    """qwen2.lm_head_logits (tied: the embedding; untied: a given head) and
    tokenizer.kl_loss against the JAX package's, f32 to 1e-6."""
    cfg, jcfg, jp, tp = models("tiny")
    rng = np.random.RandomState(3)
    hidden = rng.randn(2, 5, cfg.decoder_config.hidden_size).astype(np.float32)
    head = rng.randn(cfg.decoder_config.vocab_size, cfg.decoder_config.hidden_size).astype(
        np.float32)
    for lm_head in (None, head):
        ref = jq.lm_head_logits(jp["lm"], jnp.asarray(hidden),
                                None if lm_head is None else jnp.asarray(lm_head))
        out = tq.lm_head_logits(tp["lm"], torch.from_numpy(hidden),
                                None if lm_head is None else torch.from_numpy(lm_head))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    mean = rng.randn(3, 7, 16).astype(np.float32)
    np.testing.assert_allclose(ttok.kl_loss(torch.from_numpy(mean)).numpy(),
                               np.asarray(jtok.kl_loss(jnp.asarray(mean))), rtol=1e-6)


@pytest.mark.parametrize("kind", ["uniform", "logit_normal"])
def test_timestep_samplers(kind):
    """Range, dtype (JAX's int32) and shape, and the statistics of 200,000
    draws: uniform's mean and variance, the logit-normal's median in the
    middle of the schedule and its mass there above uniform's. The bits
    are torch's (an explicit generator), not JAX's."""
    n = 1000
    gen = torch.Generator().manual_seed(0)
    sampler = UniformSampler(n) if kind == "uniform" else LogitNormalSampler(n, 0.0, 1.0)
    t = sampler.sample(gen, (400, 500))
    assert t.shape == (400, 500) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) <= n - 1
    x = t.double()
    if kind == "uniform":
        assert abs(float(x.mean()) - (n - 1) / 2) < 3.0
        assert abs(float(x.var()) - (n * n - 1) / 12) < 0.01 * (n * n - 1) / 12
        assert int(t.min()) == 0 and int(t.max()) == n - 1
    else:
        assert abs(float(x.median()) - n / 2) < 5.0
        assert float(((x >= 250) & (x < 750)).double().mean()) > 0.6  # uniform: 0.5
        shifted = LogitNormalSampler(n, 1.0, 0.5).sample(gen, (10000,))
        assert float(shifted.double().median()) > 0.65 * n  # sigmoid(1) = 0.73
    again = sampler.sample(torch.Generator().manual_seed(0), (400, 500))
    assert torch.equal(again, t)


def test_profiling_trace_phase_and_step_timer(tmp_path):
    """trace writes a Chrome trace and the key-averages table into its
    directory, the phase names appear among the profiler's events, and
    StepTimer.report equals the JAX package's for the same injected
    timings."""
    with tprof.trace(str(tmp_path / "prof")) as prof:
        with tprof.phase("vv.prefill"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with tprof.phase("vv.frame"):
            torch.relu(torch.randn(128))
    names = {e.name for e in prof.events()}
    assert {"vv.prefill", "vv.frame"} <= names
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert "vv.prefill" in trace and "vv.frame" in trace
    assert "vv.prefill" in (tmp_path / "prof" / "key_averages.txt").read_text()

    reports = []
    for mod in (jprof, tprof):
        timer = mod.StepTimer()
        with timer.time("decode"):
            pass
        timer.totals.update(decode=0.75, prefill=0.125, vocode=1.5)
        timer.counts.update(decode=2, prefill=1, vocode=3)
        reports.append(timer.report())
    assert reports[0] == reports[1] and reports[0].startswith("vocode: total 1.500s")


def test_trainer_takes_remat_policy_dots(tmp_path):
    """The trainer runs two QLoRA steps of the tiny model on the CPU with
    --remat --remat_policy dots (it exited before this slice), finite
    losses, the adapters moved (test_dots_loss_and_grads_match holds the
    policy's gradients)."""
    from vibevoice_tpu_torch.finetune import train

    summary = train.main(["--synthetic_data", "--use_lora", "--int8_base", "--remat",
                          "--remat_policy", "dots", "--max_steps", "2", "--device", "cpu",
                          "--no_save", "--output_dir", str(tmp_path)])
    losses = [s["loss"] for s in summary["steps"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    moved = [float((x - y).abs().max()) for (p, x), (_, y) in zip(
        tts.tree_leaves_with_path(summary["lora"]),
        tts.tree_leaves_with_path(summary["lora_init"])) if p[-1] == "b"]
    assert max(moved) > 0
