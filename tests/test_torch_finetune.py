"""The port's fine-tuning pieces against the JAX package on the CPU: kernel
E's plain version, the int8 + LoRA linear and its gradients, the training
attention and its gradients, the no-cache LM forward (with and without
remat), the train-time noise schedule, the collator, the LoRA file format
and the trainer CLI. Inputs are made with numpy from a seed and given to
both packages.

Tolerances: float32 paths that compute the same function agree to 1e-5 of
the peak (summation order). Where the JAX CPU path of an int8 linear takes
its XLA fallback, which rounds the product to bf16 while the port keeps the
kernels' f32 sum, the bound is 2% of the peak (as in test_torch_generate).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu.configs import tiny_config as jax_tiny_config
from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.ops import quant as jquant
from vibevoice_tpu.schedule.dpm_solver import NoiseSchedule as JNoiseSchedule

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.finetune import lora as tlora
from vibevoice_tpu_torch.models import qwen2 as tq
from vibevoice_tpu_torch.ops import flash_attention as tfa
from vibevoice_tpu_torch.ops import quant as tquant
from vibevoice_tpu_torch.schedule.dpm_solver import NoiseSchedule as TNoiseSchedule
from vibevoice_tpu_torch.utils.params import from_jax, lora_from_jax

CFG, JCFG = tiny_config(), jax_tiny_config()  # the port's side, the JAX package's
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_matmul_t_plain_matches_pallas_kernel(dtype):
    """Kernel E's plain version against the Pallas kernel in interpret mode.
    f32 g: both sum bf16(g*scale) x int8 products in f32, so only the order
    differs (1e-5 of the peak); bf16 g: one bf16 rounding of the output."""
    rng = np.random.RandomState(1)
    cin, cout, rows = 512, 1024, 16
    w = rng.randn(cin, cout).astype(np.float32)
    jqw = jquant.quantize_weight(jnp.asarray(w))
    g = (rng.randn(rows, cout) * 0.1).astype(np.float32)
    jg = jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = jquant.int8_matmul_t(jg, jqw["w8"], jqw["scale"], interpret=True)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tquant.int8_matmul_t(tg, torch.from_numpy(np.array(jqw["w8"])),
                               torch.from_numpy(np.array(jqw["scale"])))
    assert got.dtype == tg.dtype and got.shape == (rows, cin)
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < (
        1e-2 if dtype == "bfloat16" else 1e-5)


def test_mm_int8_lora_gradients_match_jax():
    """mm(x, {w8, scale, lora}): value and gradients w.r.t. x, A and B
    against jax.grad of quant.mm. The JAX CPU int8 path rounds the forward
    and the backward dx products to bf16 outputs, which alone puts its
    gradients 2.1% of the peak off the exact function here (through sin'),
    so the bound is 3% of the peak. The port's backward against the
    dequantized-dense f32 autograd differs only by kernel E's bf16(g*scale)
    rounding: 1e-2 of the peak."""
    rng = np.random.RandomState(0)
    cin, cout, r, rows = 32, 48, 4, 6
    w = rng.randn(cin, cout).astype(np.float32)
    x = rng.randn(rows, cin).astype(np.float32)
    a = (rng.randn(cin, r) * 0.1).astype(np.float32)
    b = (rng.randn(r, cout) * 0.1).astype(np.float32)
    s = 2.0
    jqw = jquant.quantize_weight(jnp.asarray(w))

    def jf(x, a, b):
        return jnp.sum(jnp.sin(jquant.mm(x, {**jqw, "lora": (a, b, s)})))

    jval, jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (x, a, b)))

    w8, scale = (torch.from_numpy(np.array(jqw[k])) for k in ("w8", "scale"))
    tx, ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (x, a, b))
    tval = torch.sin(tquant.mm(tx, {"w8": w8, "scale": scale, "lora": (ta, tb, s)})).sum()
    tgrads = torch.autograd.grad(tval, (tx, ta, tb))
    assert abs(tval.item() - float(jval)) <= 2e-2 * abs(float(jval))
    for got, want in zip(tgrads, jgrads):
        assert _rel(got.numpy(), np.asarray(want)) < 3e-2

    dx, dxa, dxb = (torch.from_numpy(v).requires_grad_(True) for v in (x, a, b))
    wd = w8.float() * scale
    dval = torch.sin(torch.matmul(dx.to(torch.bfloat16).float(), wd) + (dx @ dxa) @ dxb * s).sum()
    for got, want in zip(tgrads, torch.autograd.grad(dval, (dx, dxa, dxb))):
        assert _rel(got.numpy(), want.numpy()) < 1e-2


def _padded_valid(b, t, lens):
    valid = np.zeros((b, t), bool)
    for i, n in enumerate(lens):
        valid[i, :n] = True
    return valid


def test_train_attention_and_grads_match_jax():
    """The training attention's plain version (the CPU route of
    flash_train_attention) and its autograd against JAX's masked path and
    jax.grad, on a right-padded GQA batch: the same function, 1e-5."""
    rng = np.random.RandomState(2)
    b, t, nh, kh, d = 2, 20, 4, 2, 16
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for h in (nh, kh, kh))
    valid = _padded_valid(b, t, (20, 13))
    w = rng.randn(b, t, nh, d).astype(np.float32)
    _, mask, _ = jq.train_attention_inputs(JCFG.decoder_config, jnp.asarray(valid))

    def jf(q, k, v):
        return jnp.sum(jq._attention_masked(q, k, v, mask) * w)

    jout = jq._attention_masked(*map(jnp.asarray, (q, k, v)), mask)
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq_, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tout = tfa.flash_train_attention(tq_, tk, tv, torch.from_numpy(valid))
    tgrads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), (tq_, tk, tv))
    assert _rel(tout.detach().numpy(), np.asarray(jout)) < 1e-5
    for got, want in zip(tgrads, jgrads):
        assert _rel(got.numpy(), np.asarray(want)) < 1e-5


@pytest.fixture(scope="module")
def lm():
    rng = np.random.RandomState(3)
    jp = jq.init(jax.random.PRNGKey(0), JCFG.decoder_config)
    jp = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape) * 0.1 + (1.0 if x.ndim == 1 else 0.0),
                                            jnp.float32), jp)
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_no_cache_forward_matches_jax(lm, remat):
    """The no-cache (training) LM forward on a right-padded batch, dense
    f32, with and without remat, and its input gradient: 1e-5 of the peak."""
    jp, tp = lm
    rng = np.random.RandomState(4)
    b, t, h = 2, 24, CFG.decoder_config.hidden_size
    x = rng.randn(b, t, h).astype(np.float32)
    valid = _padded_valid(b, t, (24, 17))
    wout = rng.randn(b, t, h).astype(np.float32)

    def jf(x):
        hid, _ = jq.forward(JCFG.decoder_config, jp, x, valid_mask=jnp.asarray(valid), remat=remat)
        return jnp.sum(hid * wout), hid

    (_, jh), jgx = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    th, cache = tq.forward(CFG.decoder_config, tp, tx, valid_mask=torch.from_numpy(valid),
                           remat=remat)
    assert cache is None
    (tgx,) = torch.autograd.grad((th * torch.from_numpy(wout)).sum(), (tx,))
    assert _rel(th.detach().numpy(), np.asarray(jh)) < 1e-5
    assert _rel(tgx.numpy(), np.asarray(jgx)) < 1e-5
    # remat_policy="dots" keeps the matmul outputs: the same hidden states
    # and input gradient as without it, and as JAX's "dots"
    # (dots_with_no_batch_dims_saveable)
    tx2 = torch.from_numpy(x).requires_grad_(True)
    th2, _ = tq.forward(CFG.decoder_config, tp, tx2, valid_mask=torch.from_numpy(valid),
                        remat=remat, remat_policy="dots")
    (tgx2,) = torch.autograd.grad((th2 * torch.from_numpy(wout)).sum(), (tx2,))
    assert _rel(th2.detach().numpy(), th.detach().numpy()) < 1e-6
    assert _rel(tgx2.numpy(), tgx.numpy()) < 1e-6
    if remat:
        policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable

        def jdots(x):
            hid, _ = jq.forward(JCFG.decoder_config, jp, x, valid_mask=jnp.asarray(valid),
                                remat=True, remat_policy=policy)
            return jnp.sum(hid * wout), hid

        (_, jh2), jgx2 = jax.value_and_grad(jdots, has_aux=True)(jnp.asarray(x))
        assert _rel(th2.detach().numpy(), np.asarray(jh2)) < 1e-5
        assert _rel(tgx2.numpy(), np.asarray(jgx2)) < 1e-5


def test_noise_schedule_matches_jax():
    for kw in ({}, {"beta_schedule": "linear", "rescale_betas_zero_snr": True}):
        js, ts = JNoiseSchedule.create(1000, **kw), TNoiseSchedule.create(1000, **kw)
        np.testing.assert_array_equal(ts.alpha_t.numpy(), np.asarray(js.alpha_t))
        np.testing.assert_array_equal(ts.sigma_t.numpy(), np.asarray(js.sigma_t))
        rng = np.random.RandomState(5)
        x0, eps = rng.randn(2, 6, 8, 16).astype(np.float32)
        t = rng.randint(0, 1000, (6,))
        for name in ("add_noise", "get_velocity"):
            want = getattr(js, name)(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))
            got = getattr(ts, name)(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(t))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_collator_matches_jax():
    """The same raw items and seed give the same Batch: token and mask
    arrays and waveforms equal, semantic features (two encoders on the same
    weights) to 1e-5 of the peak."""
    from vibevoice_tpu.finetune import data as jdata
    from vibevoice_tpu.finetune.train import synthetic_dataset
    from vibevoice_tpu.processor import processor as jproc
    from vibevoice_tpu.processor import text_tokenizer as jtok
    from vibevoice_tpu_torch.finetune import data as tdata
    from vibevoice_tpu_torch.processor import processor as tproc
    from vibevoice_tpu_torch.processor import text_tokenizer as ttok

    jp = jvv.init(jax.random.PRNGKey(1), JCFG)
    tp = from_jax(jax.tree.map(np.asarray, {"semantic_tokenizer": jp["semantic_tokenizer"]}), CFG,
                  device="cpu")
    raw = synthetic_dataset(n=4, seed=0, min_dur=0.005, max_dur=0.02)
    batches = []
    for mod, pmod, tmod, sem in (
            (jdata, jproc, jtok, jdata.make_semantic_encode_fn(JCFG.semantic_tokenizer_config,
                                                               jp["semantic_tokenizer"])),
            (tdata, tproc, ttok, tdata.make_semantic_encode_fn(CFG.semantic_tokenizer_config,
                                                               tp["semantic_tokenizer"]))):
        proc = pmod.VibeVoiceProcessor(
            tokenizer=tmod.FallbackTextTokenizer(),
            speech_tok_compress_ratio=CFG.acoustic_tokenizer_config.hop_length)
        ds = mod.VibeVoiceDataset(raw, seed=7)
        col = mod.VibeVoiceCollator(processor=proc, semantic_encode_fn=sem, max_length=256,
                                    speech_compress_ratio=CFG.acoustic_tokenizer_config.hop_length,
                                    semantic_vae_dim=CFG.semantic_vae_dim, pre_silence_sec=0.0005,
                                    post_silence_sec=0.0015, crossfade_sec=0.0005, seed=7,
                                    pad_to_multiple=8, voice_prompt_drop_rate=0.3)
        batches.append([col([ds[i], ds[i + 1]]) for i in (0, 2)])
    for jb, tb in zip(*batches):
        for name in jb._fields:
            want, got = np.asarray(getattr(jb, name)), np.asarray(getattr(tb, name))
            assert want.shape == got.shape and want.dtype == got.dtype, name
            if name == "speech_semantic_tensors":
                assert _rel(got, want) < 1e-5
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


def test_lora_saved_by_port_loads_in_jax(tmp_path):
    """An adapter dir written by the port loads through the JAX package's
    load_lora_assets and merges to the port's own merged weights."""
    from vibevoice_tpu.finetune import lora as jlora

    jp = jvv.init(jax.random.PRNGKey(2), JCFG)
    tp = from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    cfg = tlora.LoraConfig(r=4, alpha=8)
    lora = tlora.init_lora(3, tp, cfg)
    rng = np.random.RandomState(6)
    for entry in lora["lm_layers"] + lora["diffusion_head_layers"]:
        for pair in entry.values():
            pair["b"] = torch.from_numpy(rng.randn(*pair["b"].shape).astype(np.float32))
    tlora.save_lora_assets(str(tmp_path / "lora"), lora, cfg)
    with open(tmp_path / "lora" / "lora_adapters.pkl", "rb") as f:
        blob = pickle.load(f)
    assert blob["config"]["target_modules"] == cfg.target_modules
    jmerged = jlora.load_lora_assets(jp, str(tmp_path))
    tmerged = tlora.apply_lora(tp, lora, cfg)
    for get in (lambda p: p["lm"]["layers"][1]["attn"]["v"]["w"],
                lambda p: p["lm"]["layers"][0]["mlp"]["down"]["w"],
                lambda p: p["diffusion_head"]["layers"][1]["ffn"]["gate"]["w"]):
        np.testing.assert_allclose(get(tmerged).numpy(), np.asarray(get(jmerged)), rtol=1e-6,
                                   atol=1e-6)
    back = tlora.load_lora_assets(tp, str(tmp_path))
    np.testing.assert_array_equal(back["lm"]["layers"][1]["attn"]["v"]["w"].numpy(),
                                  tmerged["lm"]["layers"][1]["attn"]["v"]["w"].numpy())
    # and a JAX adapter tree converts to the port's
    jl = jlora.init_lora(jax.random.PRNGKey(4), jp, jlora.LoraConfig(r=4))
    conv = lora_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    np.testing.assert_array_equal(conv["lm_layers"][0]["q"]["a"].numpy(),
                                  np.asarray(jl["lm_layers"][0]["q"]["a"]))


def test_trainer_cli_qlora_smoke(tmp_path):
    """The port's trainer CLI runs QLoRA steps on the CPU in tiny smoke mode
    and writes a checkpoint that resumes."""
    base = [sys.executable, "-m", "vibevoice_tpu_torch.finetune.train", "--synthetic_data",
            "--use_lora", "--int8_base", "--remat", "--ce_chunk_size", "16", "--device", "cpu",
            "--output_dir", str(tmp_path)]
    res = subprocess.run(base + ["--max_steps", "2", "--profile_dir", str(tmp_path / "prof")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "startup smoke: ce=" in res.stdout and "done" in res.stdout
    assert (tmp_path / "prof" / "profile.txt").read_text().startswith("step wall")
    ckpt = tmp_path / "checkpoint-2"
    assert (ckpt / "lora" / "lora_adapters.pkl").exists()
    res = subprocess.run(base + ["--max_steps", "3", "--resume_from_checkpoint", str(ckpt)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Resumed from step 2" in res.stdout and "step 3/3" in res.stdout
    from vibevoice_tpu_torch.finetune.train import parse_args

    with pytest.raises(SystemExit, match="wandb"):
        parse_args(["--report_to", "wandb"])
    assert parse_args(["--remat", "--remat_policy", "dots"]).remat_policy == "dots"
    # the mesh flags and sharded checkpoints are ported (tests/test_torch_multihost.py)
    args = parse_args(["--mesh_dp", "2", "--fsdp", "--checkpoint_format", "orbax"])
    assert (args.mesh_dp, args.fsdp, args.checkpoint_format) == (2, True, "orbax")
    assert parse_args(["--model_path", "x"]).model_path == "x"  # tests/test_torch_cli.py loads one


def test_trainer_needs_a_card_unless_told_cpu():
    """Without --device the trainer asks for the card; on a host with none
    it exits non-zero and names --device cpu, never falling back itself."""
    from vibevoice_tpu_torch.finetune.train import parse_args

    assert parse_args(["--synthetic_data"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = subprocess.run([sys.executable, "-m", "vibevoice_tpu_torch.finetune.train",
                          "--synthetic_data", "--max_steps", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "--device cpu" in res.stderr and "no CUDA device" in res.stderr
