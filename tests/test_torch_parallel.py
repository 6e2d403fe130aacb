"""The port's tensor, data and FSDP parallelism (parallel/mesh.py and what
calls it) against the JAX package on the CPU, in float32.

The port runs one process per rank: gloo worlds of 2 and 4 ranks spawned by
tests/torch_workers.py (nothing of JAX is imported there); the JAX side runs
in this process on the 8-device virtual CPU mesh of tests/conftest.py, as
tests/test_parallel.py and tests/test_multihost.py run it. Weights and
batches come from numpy seeds; the training steps take JAX's random draws.
Configurations: tiny_config (4 query heads over 2 KV heads) and the 7B's
layout at CPU size (28 query heads over 4 KV heads of 16, hidden 448, an
untied lm_head), which tensor parallelism of 4 divides.

Tolerance: f32 within 1e-5 of the peak, integers equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu import configs as jconfigs
from vibevoice_tpu.finetune import loss as jloss
from vibevoice_tpu.finetune import train_step as jts
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.parallel import mesh as jmesh

import torch_workers as W
from vibevoice_tpu_torch import configs as tconfigs
from vibevoice_tpu_torch.finetune import loss as tloss
from vibevoice_tpu_torch.parallel import mesh as pmesh
from vibevoice_tpu_torch.utils.params import from_jax

TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
TOL = 1e-5


def geometry_7b(mod):
    """tiny_config() with the 7B's 28/4 head layout (head_dim 16), an untied
    lm_head and the head FFN ratio 3, in either package's config classes."""
    cfg = mod.tiny_config()
    lm = dataclasses.replace(cfg.decoder_config, hidden_size=448, intermediate_size=896,
                             num_attention_heads=28, num_key_value_heads=4,
                             tie_word_embeddings=False)
    head = dataclasses.replace(cfg.diffusion_head_config, hidden_size=448, head_ffn_ratio=3.0)
    return dataclasses.replace(cfg, decoder_config=lm, diffusion_head_config=head)


CONFIGS = {"tiny": (tconfigs.tiny_config(), jconfigs.tiny_config()),
           "7b": (geometry_7b(tconfigs), geometry_7b(jconfigs))}


def randomize(tree, seed):
    rng = np.random.RandomState(seed)

    def fill(path, x):
        if "gamma" in jax.tree_util.keystr(path):
            return jnp.full(x.shape, 0.3, x.dtype)
        if x.ndim < 2:
            return x
        return jnp.asarray(rng.randn(*x.shape) * (0.7 / np.sqrt(np.prod(x.shape[:-1]))), x.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


_MODELS = {}


def models(name):
    """(port cfg, JAX cfg, JAX params, port params) of a configuration."""
    if name not in _MODELS:
        cfg, jcfg = CONFIGS[name]
        jp = dict(randomize(jvv.init(jax.random.PRNGKey(0), jcfg), 1))
        _MODELS[name] = (cfg, jcfg, jp, from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _MODELS[name]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# Tensor-parallel decode and training forward
# ---------------------------------------------------------------------------


def _decode_inputs(cfg, k=2, b=2, t=8):
    rng = np.random.RandomState(3)
    ids = rng.randint(10, 100, (b, t)).astype(np.int64)
    ids[:, -1] = TOK["speech_start"]
    mask = np.ones((b, t), bool)
    mask[1, t - 2:] = False
    ids[1, t - 3] = TOK["speech_start"]
    ext = np.zeros((k, b), bool)
    bank = {"init": rng.randn(4, b, cfg.acoustic_vae_dim).astype(np.float32)}
    forced = np.array([[7, 7], [7, -1]], np.int64)[:k]
    return ids, mask, ext, bank, forced


@pytest.mark.parametrize("name,tp", [("tiny", 2), ("7b", 4)])
def test_tp_decode_matches_jax_and_dense(tmp_path, name, tp):
    """Prefill and one window of 2 frames with the LM split over tp ranks
    (tests/test_parallel.py:46's TP decode step): tokens, cache lengths,
    audio and h_pos against JAX's step on a tp mesh and against the port's
    dense run; every rank chooses the same tokens, and the ranks' KV caches
    are the dense cache's KV heads in rank order."""
    cfg, jcfg, jp, tp_params = models(name)
    ids, mask, ext, bank, forced = _decode_inputs(cfg)
    max_len, k = 64, 2
    args = (cfg, tp_params, ids, mask, max_len, ext, bank, forced, k, False, TOK)
    dense = W.tp_decode(None, *args)
    ranks = W.run_world(tp, tmp_path, {"d": (("mesh", 1, tp), W.tp_decode, args)})

    mesh = jmesh.make_mesh(dp=1, tp=tp)
    sharded = jax.device_put(jp, jmesh.model_param_shardings(jp, mesh))
    jtok = jinf.SpecialTokens(**TOK)
    jopts = jinf.GenerateOptions(ddpm_steps=2, max_length=max_len)
    jcarry = jinf.prefill_fn(jcfg, sharded, jnp.asarray(ids, jnp.int32), max_len,
                             jnp.asarray(mask), None, False, jtok)
    hooks = {"init": jnp.asarray(bank["init"]), "forced": jnp.asarray(forced, jnp.int32)}
    jcarry, jout = jinf.make_multi_step_fn(jcfg, jtok, jopts, k, inject=True)(
        sharded, jcarry, jax.random.PRNGKey(0), jnp.asarray(ext), hooks)

    for r in ranks:
        got = r["d"]
        np.testing.assert_array_equal(got["tokens"], np.asarray(jout.tokens))
        np.testing.assert_array_equal(got["tokens"], dense["tokens"])
        np.testing.assert_array_equal(got["length"], np.asarray(jcarry.cache.length))
        assert rel(got["audio"], jout.audio) <= TOL and rel(got["audio"], dense["audio"]) <= TOL
        assert rel(got["h_pos"], jcarry.h_pos) <= TOL and rel(got["h_pos"], dense["h_pos"]) <= TOL
    k0 = np.concatenate([r["d"]["k0"] for r in ranks], axis=1)
    assert k0.shape == dense["k0"].shape and ranks[0]["d"]["k0"].shape[1] == \
        cfg.decoder_config.num_key_value_heads // tp
    assert rel(k0, dense["k0"]) <= TOL


def test_tp_train_forward_and_grads(tmp_path):
    """The no-cache (training) forward with the LM split over 2 ranks and
    the gradients of sum(h * w): h and dx against JAX's TP forward and
    jax.grad, each rank's weight gradients against JAX's gradients cut to
    the rank's shard (Megatron's f and g in the port, XLA's collectives in
    JAX)."""
    cfg, jcfg, jp, tp_params = models("tiny")
    lcfg, jlcfg = cfg.decoder_config, jcfg.decoder_config
    rng = np.random.RandomState(5)
    b, t = 2, 12
    ids = rng.randint(0, lcfg.vocab_size, (b, t))
    valid = np.ones((b, t), bool)
    valid[1, 9:] = False
    x = np.asarray(jq.embed_tokens(jp["lm"], jnp.asarray(ids)), np.float32)
    w = (rng.randn(b, t, lcfg.hidden_size) * valid[..., None]).astype(np.float32)
    ranks = W.run_world(2, tmp_path, {"f": (("mesh", 1, 2), W.tp_train_forward,
                                            (lcfg, tp_params["lm"], x, valid, w))})

    mesh = jmesh.make_mesh(dp=1, tp=2)
    sharded = jax.device_put(jp["lm"], jmesh.qwen2_param_shardings(jp["lm"], mesh))

    def loss(lm, e):
        return jnp.sum(jq.forward(jlcfg, lm, e, valid_mask=jnp.asarray(valid))[0] * w)

    h = jax.jit(lambda lm, e: jq.forward(jlcfg, lm, e, valid_mask=jnp.asarray(valid))[0])(
        sharded, jnp.asarray(x))
    g_lm, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(sharded, jnp.asarray(x))
    jgrads = {p: np.asarray(v) for p, v in W._spec_leaves(jax.tree.map(np.asarray, g_lm))
              if p != ("embed",)}  # the forward takes embeddings
    specs = dict(W._spec_leaves(pmesh.qwen2_param_shardings(tp_params["lm"])))
    for rank, r in enumerate(ranks):
        got = r["f"]
        assert rel(got["h"], h) <= TOL and rel(got["dx"], g_x) <= TOL
        assert set(got["grads"]) == set(jgrads)
        for p, g in got["grads"].items():
            want = jgrads[p]
            for dim, axes in enumerate(specs[p]):
                if axes == "tp":
                    want = np.split(want, 2, axis=dim)[rank]
            assert g.shape == want.shape and rel(g, want) <= 1e-4, (p, rel(g, want))


# ---------------------------------------------------------------------------
# Training steps: FSDP, data parallelism, the hybrid mesh
# ---------------------------------------------------------------------------


def _batch(cfg, b=4, t=32, f=4, lengths=None):
    hop = cfg.acoustic_tokenizer_config.hop_length
    rng = np.random.RandomState(0)
    am = np.zeros((b, t), bool)
    am[:, 8:8 + f] = True
    valid = np.ones((b, t), bool)
    for i, n in enumerate(lengths or []):
        valid[i, n:] = False
    return jloss.Batch(
        input_ids=rng.randint(10, 100, (b, t)).astype(np.int32), attention_mask=valid,
        speech_tensors=rng.randn(b, hop * f).astype(np.float32), speech_masks=np.ones((b, f), bool),
        speech_semantic_tensors=rng.randn(b, f, cfg.semantic_vae_dim).astype(np.float32),
        speeches_loss_input=np.ones((b,), bool), acoustic_input_mask=am, acoustic_loss_mask=am)


def _draws(cfg, key, batch, mul=4):
    """What JAX's train_forward draws from `key` (tests/test_torch_train_step.py)."""
    n, f = batch.speech_masks.shape
    b, t = batch.input_ids.shape
    hcfg = cfg.diffusion_head_config
    k_vae, k_noise, k_t = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_vae)
    std = jax.random.normal(k1, (n, 1, 1), jnp.float32)
    eps = jax.random.normal(k2, (n, f, cfg.acoustic_vae_dim), jnp.float32)
    noise = jax.random.normal(k_noise, (b * t * mul, hcfg.latent_size), jnp.float32)
    ts = jax.random.randint(k_t, (b * t * mul,), 0, hcfg.ddpm_num_steps)
    t_ = lambda a: torch.from_numpy(np.array(a))
    return tloss.Draws(t_(std).reshape(n), t_(eps), t_(noise), t_(ts).long())


def _with_buffers(jp, tp):
    jp = {**jp, "speech_scaling_factor": jnp.asarray(float("nan")),
          "speech_bias_factor": jnp.asarray(float("nan"))}
    tp = {**tp, "speech_scaling_factor": torch.tensor(float("nan")),
          "speech_bias_factor": torch.tensor(float("nan"))}
    return jp, tp


_JAX_STEPS = {}


def jax_step_loss(batch_key, batch, shardings=None):
    """JAX's loss of one step of the global batch (PRNGKey(1)), on one
    device or sharded by ``shardings(params, mesh) -> (mesh, tree)``."""
    _, jcfg, jp, tp = models("tiny")
    jp, _ = _with_buffers(jp, tp)
    key = (batch_key, None if shardings is None else shardings.__name__)
    if key not in _JAX_STEPS:
        optimizer = jts.make_optimizer(warmup_steps=1, learning_rate=1e-3)
        step = jax.jit(jts.make_train_step(jcfg, optimizer, jloss.TrainOptions(dp_axis=None)))
        jb = jloss.Batch(*(jnp.asarray(x) for x in batch))
        params = jp
        if shardings is not None:
            mesh, tree = shardings(jp)
            params = jax.device_put(jp, tree)
            jb = jax.device_put(jb, jmesh.batch_shardings(mesh, jb))
        _, out = step(jts.init_train_state(params, optimizer), jb, jax.random.PRNGKey(1))
        _JAX_STEPS[key] = float(out.loss)
    return _JAX_STEPS[key]


def fsdp_dp2_tp2(jp):
    mesh = jmesh.make_mesh(dp=2, tp=2)
    return mesh, jmesh.fsdp_param_shardings(jp, mesh, min_leaf_size=1024)


def _steps(tmp_path, world, spec, batch, n_steps=2, fsdp_min=0, jobs=None, remat=False):
    cfg, _, jp, tp = models("tiny")
    jp, tp = _with_buffers(jp, tp)
    draws = _draws(cfg, jax.random.PRNGKey(1), batch)
    tb = tloss.Batch(*(np.asarray(x) for x in batch))
    dense = W.train_steps(None, cfg, tp, tb, draws, n_steps, 0)
    args = (cfg, tp, tb, draws, n_steps, fsdp_min, None, None, None, remat)
    ranks = W.run_world(world, tmp_path, {"s": (spec, W.train_steps, args), **(jobs or {})})
    return dense, ranks


def _same_run(dense, ranks):
    for r in ranks:
        got = r["s"]
        assert np.allclose(got["losses"], dense["losses"], rtol=TOL, atol=0), \
            (got["losses"], dense["losses"])
        assert set(got["tree"]) == set(dense["tree"])
        for p, x in got["tree"].items():
            assert rel(x, dense["tree"][p]) <= TOL, p


def test_fsdp_train_step_matches_jax(tmp_path):
    """FSDP over dp 2 on top of TP 2 (tests/test_parallel.py:80, leaves of
    at least 1024 elements split over dp), with remat (each LM layer's
    shards are gathered inside its block, and again in the backward): the
    first step's loss equals JAX's FSDP step's; both steps' losses and the
    tree after them (the second step's update) equal the port's one-device
    run's (remat is exact); the embedding and the MLP weights are dp-split
    and their AdamW moments are stored split."""
    cfg = models("tiny")[0]
    batch = _batch(cfg)
    dense, ranks = _steps(tmp_path, 4, ("mesh", 2, 2), batch, fsdp_min=1024, remat=True)
    want = jax_step_loss("fsdp", batch, fsdp_dp2_tp2)
    assert abs(ranks[0]["s"]["losses"][0] - want) <= TOL * abs(want)
    _same_run(dense, ranks)
    split = ranks[0]["s"]["fsdp_split"]
    assert len(split) >= 4 and "('lm', 'embed')" in split, split
    vocab, hidden = cfg.decoder_config.vocab_size, cfg.decoder_config.hidden_size
    assert ranks[0]["s"]["mu_shapes"]["('lm', 'embed')"] in ((vocab // 2, hidden),
                                                              (vocab, hidden // 2))


def test_dp_unequal_valid_tokens_matches_jax_global_step(tmp_path):
    """Data parallelism over 2 ranks whose samples hold different numbers of
    valid tokens (right padding 32, 26 | 20, 29): the losses are normalised
    over the global batch, so the step equals JAX's step over the whole
    batch (and the port's one-device step), not a mean of per-rank means."""
    cfg = models("tiny")[0]
    batch = _batch(cfg, lengths=(32, 26, 20, 29))
    dense, ranks = _steps(tmp_path, 2, ("mesh", 2, 1), batch)
    want = jax_step_loss("unequal", batch)
    assert abs(ranks[0]["s"]["losses"][0] - want) <= TOL * abs(want)
    _same_run(dense, ranks)


def test_hybrid_mesh_2x1x2(tmp_path):
    """The multi-host mesh, dcn 2 x dp 1 x tp 2 (tests/test_multihost.py:26):
    its axes and data axes as JAX's, and a training step over it (batch
    over dcn, LM over tp) equal to the one-device step."""
    jm = jmesh.make_hybrid_mesh(dcn=2, dp=1, tp=2)
    assert dict(jm.shape) == {"dcn": 2, "dp": 1, "tp": 2}
    cfg = models("tiny")[0]
    batch = _batch(cfg)
    dense, ranks = _steps(tmp_path, 4, ("hybrid", 2, 1, 2), batch, n_steps=1,
                          jobs={"a": (("hybrid", 2, 1, 2), W.mesh_axes, ())})
    for r in ranks:
        names, data = r["a"]
        assert names == tuple(jm.axis_names) and data == jmesh.data_axes(jm)
    _same_run(dense, ranks)


class _Mesh:
    """The shape of a mesh, for the sharding rules' divisibility check."""

    def __init__(self, **dims):
        self.mesh_dim_names, self.dims = tuple(dims), tuple(dims.values())

    def size(self, i=None):
        return self.dims[i]


def test_head_divisibility_errors():
    """The TP plan refuses a "tp" size that does not divide both head counts,
    naming them: tiny and the 1.5B have 2 KV heads (tp <= 2), the 7B's
    layout 4 (tp in 1, 2, 4)."""
    for name, ok, bad in (("tiny", (1, 2), (4, 3)), ("7b", (1, 2, 4), (8, 3))):
        cfg, _, _, tp = models(name)
        lm, d = tp["lm"], cfg.decoder_config.head_dim
        nh, kh = cfg.decoder_config.num_attention_heads, cfg.decoder_config.num_key_value_heads
        for n in ok:
            pmesh.qwen2_param_shardings(lm, _Mesh(dp=1, tp=n), d)
        for n in bad:
            with pytest.raises(ValueError, match=f"{n} needs it to divide both the {nh} query "
                                                 f"heads and the {kh} KV heads"):
                pmesh.model_param_shardings(tp, _Mesh(dp=1, tp=n), d)
