"""The port's sequence-parallel (ring-attention) prefill against the JAX
package on the CPU, at tiny sizes in float32.

Kernel F's plain fold is held against JAX's ``flash_ring_block`` (interpret
mode) hop by hop. The ring itself runs in gloo process groups of 1, 2 and 4
ranks, spawned with torch.multiprocessing (a file store under the test's
tmp_path, one thread each); the JAX side runs on the 8-device virtual CPU
mesh of tests/conftest.py. Inputs and weights come from numpy seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vibevoice_tpu.configs import tiny_config as jax_tiny_config
from vibevoice_tpu.models import inference as jinf
from vibevoice_tpu.models import qwen2 as jq
from vibevoice_tpu.models import vibevoice as jvv
from vibevoice_tpu.ops import flash_attention as jfa
from vibevoice_tpu.parallel import sp_prefill as jsp
from vibevoice_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vibevoice_tpu.parallel.ring_attention import ring_attention as jax_ring_attention

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.models import inference as tinf
from vibevoice_tpu_torch.ops import flash_attention as tfa
from vibevoice_tpu_torch.parallel import make_mesh, ring_attention, ring_prefill_carry
from vibevoice_tpu_torch.parallel.sp_prefill import _sp_forward
from vibevoice_tpu_torch.utils.params import from_jax

CFG, JCFG = tiny_config(), jax_tiny_config()  # the port's side, the JAX package's
TOK = dict(speech_start=5, speech_end=6, speech_diffusion=7, eos=2)
# the cases of tests/test_ring_attention.py:52-88: (seed, head_dim, amplitude, sample 1's length)
RING_CASES = {"d32": (0, 32, 1.0, 50), "d128": (3, 128, 0.3, 41)}


def T(a):
    return torch.from_numpy(np.array(a))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# Kernel F's plain fold against the JAX kernel
# ---------------------------------------------------------------------------


def test_plain_fold_matches_jax_kernel_per_hop():
    """Rank 2 of a 4-ring: its own block, then ranks 1, 0 and 3's; the last
    lies wholly in the future and must leave the state exactly as it was.
    GQA G 2, D 128; sample 1 ends inside rank 2's block."""
    rng = np.random.RandomState(0)
    b, tl, nh, kh, d, n, rank = 2, 16, 4, 2, 128, 4, 2
    r = tl * nh // kh
    q = (rng.randn(b, tl, nh, d) * 0.3).astype(np.float32)
    blocks = [tuple((rng.randn(b, kh, tl, d) * 0.3).astype(np.float32) for _ in "kv")
              for _ in range(n)]
    k_len = np.array([n * tl, rank * tl + 5], np.int32)
    bk = jfa.ring_block_k(tl)
    jstate = jfa.ring_state_init(b, kh, r, d, block_k=bk)
    tstate = tfa.ring_state_init(b, kh, r, d)
    for hop in range(n):
        src = (rank - hop) % n
        kb, vb = blocks[src]
        kw = dict(q_start=rank * tl, k_start=src * tl)
        jstate = jfa.flash_ring_block(jstate, jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                                      k_len=jnp.asarray(k_len), block_k=bk, interpret=True, **kw)
        before = [x.clone() for x in tstate]
        tfa.flash_ring_block_plain(tstate, T(q), T(kb), T(vb), k_len=T(k_len), q_chunk=5, **kw)
        jm, jl, jacc = (np.asarray(x) for x in jstate)
        for name, got, want in (("m", tstate[0], jm[:, :, :r, 0]), ("l", tstate[1], jl[:, :, :r, 0]),
                                ("acc", tstate[2], jacc[:, :, :r])):
            assert rel_err(got, want) <= 1e-5, (hop, name, rel_err(got, want))
        if src * tl > rank * tl + tl - 1:  # wholly in the future
            assert all(torch.equal(x, y) for x, y in zip(tstate, before))
    assert hop == n - 1 and src == n - 1  # the future block was the last
    want = np.asarray(jfa.ring_state_out(jstate, b, tl, nh, d, jnp.float32))
    assert rel_err(tfa.ring_state_out(tstate, tl, torch.float32), want) <= 1e-5


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------


def _world(rank, world, store, out, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_mesh(dp=1, tp=world)
        results = {name: fn(mesh, *args) for name, (fn, args) in jobs.items()}
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _run_world(world, tmp, jobs):
    """Run every job on every rank of a gloo world; rank 0's results."""
    out = tmp / "results.pt"
    mp.spawn(_world, args=(world, str(tmp / "pg"), str(out), jobs), nprocs=world)
    return torch.load(out, weights_only=False)


def _job_ring(mesh, q, k, v, valid):
    return ring_attention(q, k, v, valid, mesh)


def _job_sp_forward(mesh, lm, embeds, valid):
    hidden, ks, vs = _sp_forward(CFG.decoder_config, lm, embeds, valid, mesh)
    return hidden, ks, vs


def _job_prefill(mesh, params, ids, valid, max_len, kv_int8, speech_args):
    return ring_prefill_carry(CFG, params, ids, valid, max_len, tinf.SpecialTokens(**TOK), mesh,
                              kv_int8=kv_int8, speech_args=speech_args)


def _job_prefill_other_ids(mesh, params, ids, valid, max_len):
    """Rank 1 passes other ids: every rank must raise, none may hang."""
    if dist.get_rank() == 1:
        ids = ids.clone()
        ids[0, 0] += 1
    try:
        _job_prefill(mesh, params, ids, valid, max_len, False, None)
    except ValueError as e:
        return str(e)
    return None


def _ring_inputs(case):
    seed, d, amp, n_valid = RING_CASES[case]
    rng = np.random.RandomState(seed)
    b, t, nh, kh = 2, 64, 4, 2
    q = (rng.randn(b, t, nh, d) * amp).astype(np.float32)
    k = (rng.randn(b, t, kh, d) * amp).astype(np.float32)
    v = (rng.randn(b, t, kh, d) * amp).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, n_valid:] = False
    return q, k, v, valid


def _sp_inputs():
    rng = np.random.RandomState(1)
    embeds = rng.randn(2, 32, CFG.decoder_config.hidden_size).astype(np.float32)
    valid = np.ones((2, 32), bool)
    valid[1, 25:] = False
    return embeds, valid


def _prompt():
    """tests/test_ring_attention.py:116-122: two right-padded prompts."""
    rng = np.random.RandomState(2)
    b, t, max_len = 2, 12, 64
    ids = rng.randint(10, 100, (b, t)).astype(np.int64)
    valid = np.ones((b, t), bool)
    valid[1, 9:] = False
    ids[1, 8] = TOK["speech_start"]
    ids[0, -1] = TOK["speech_start"]
    return ids, valid, max_len


def _voice_prompt(ids):
    """Four latent frames of a voice prompt spliced into sample 0, with the
    VAE noise given (speech_args of prefill_fn)."""
    rng = np.random.RandomState(4)
    hop = CFG.acoustic_tokenizer_config.hop_length
    mask = np.zeros(ids.shape, bool)
    mask[0, 2:6] = True
    return (T(rng.randn(1, 4 * hop).astype(np.float32)), T(np.ones((1, 4), bool)), T(mask), None,
            (T(rng.randn(1).astype(np.float32)),
             T(rng.randn(1, 4, CFG.acoustic_vae_dim).astype(np.float32))))


@pytest.fixture(scope="module")
def models():
    jp = jvv.init(jax.random.PRNGKey(0), JCFG)
    return jp, from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


@pytest.fixture(scope="module")
def world4(models, tmp_path_factory):
    _, tp = models
    jobs = {f"ring_{c}": (_job_ring, tuple(T(x) for x in _ring_inputs(c))) for c in RING_CASES}
    embeds, valid = _sp_inputs()
    jobs["sp_forward"] = (_job_sp_forward, (tp["lm"], T(embeds), T(valid)))
    ids, valid, max_len = _prompt()
    for kv_int8 in (False, True):
        jobs[f"prefill_{kv_int8}"] = (_job_prefill, (tp, T(ids), T(valid), max_len, kv_int8, None))
    jobs["other_ids"] = (_job_prefill_other_ids, (tp, T(ids), T(valid), max_len))
    return _run_world(4, tmp_path_factory.mktemp("world4"), jobs)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jobs = {f"ring_{c}": (_job_ring, tuple(T(x) for x in _ring_inputs(c))) for c in RING_CASES}
    return _run_world(2, tmp_path_factory.mktemp("world2"), jobs)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


def _dense_attention(q, k, v, valid):
    b, t, nh, d = q.shape
    g = nh // k.shape[2]
    kr, vr = (np.repeat(x.astype(np.float64), g, axis=2) for x in (k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) * d ** -0.5
    ok = np.tril(np.ones((t, t), bool))[None] & valid[:, None, :]
    s = np.where(ok[:, None], s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bqhd", p / p.sum(axis=-1, keepdims=True), vr)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_jax(request, world, case):
    """Every rank's gathered output == JAX's ring_attention over a mesh of
    the same size (its jnp hop for D 32, its Pallas hop in interpret mode
    for D 128) == dense causal attention, on valid rows."""
    got = request.getfixturevalue(f"world{world}")[f"ring_{case}"].numpy()
    q, k, v, valid = _ring_inputs(case)
    kw = dict(q_chunk=32 // world) if case == "d32" else dict(impl="pallas", interpret=True)
    want = np.asarray(jax_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(valid), jax_make_mesh(dp=1, tp=world), **kw))
    for ref in (want, _dense_attention(q, k, v, valid)):
        np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Sequence-parallel prefill
# ---------------------------------------------------------------------------


def test_sp_forward_matches_jax(models, world4):
    """The sequence-sharded forward of 4 ranks: hidden states == JAX's
    single-device qwen2.forward and JAX's _sp_forward, K/V of the first and
    last layer == JAX's _sp_forward, on valid slots."""
    jp, _ = models
    lm_cfg, jlm_cfg = CFG.decoder_config, JCFG.decoder_config
    embeds, valid = _sp_inputs()
    hidden, ks, vs = world4["sp_forward"]
    assert len(ks) == len(vs) == lm_cfg.num_hidden_layers
    ref, _ = jq.forward(jlm_cfg, jp["lm"], jnp.asarray(embeds), valid_mask=jnp.asarray(valid))
    jh, jks, jvs = jsp._sp_forward(jlm_cfg, jp["lm"], jnp.asarray(embeds), jnp.asarray(valid),
                                   jax_make_mesh(dp=1, tp=4), "tp", 8)
    tol = dict(rtol=5e-5, atol=5e-5)
    for want in (ref, jh):
        np.testing.assert_allclose(hidden.numpy()[valid], np.asarray(want)[valid], **tol)
    for li in (0, lm_cfg.num_hidden_layers - 1):
        for got, want in ((ks[li], jks[li]), (vs[li], jvs[li])):
            np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **tol)


def _cache_rows(cache, li, kv_int8, d):
    """Layer li's K cache (rows, KH, S, D) in f32, dequantized for int8."""
    k = np.asarray(cache.k[li], np.float32)[..., :d]
    if kv_int8:
        k = k * np.swapaxes(np.asarray(cache.k_scale[li], np.float32), 2, 3)
    return k


def _assert_carries_close(got, want, b, tol, kv_int8):
    np.testing.assert_array_equal(np.asarray(got.cache.length), np.asarray(want.cache.length))
    np.testing.assert_allclose(np.asarray(got.h_pos), np.asarray(want.h_pos), **tol)
    np.testing.assert_allclose(np.asarray(got.h_neg), np.asarray(want.h_neg), **tol)
    lens = np.asarray(want.cache.length)[:b]
    d = CFG.decoder_config.head_dim
    for li in (0, CFG.decoder_config.num_hidden_layers - 1):
        gk, wk = _cache_rows(got.cache, li, kv_int8, d), _cache_rows(want.cache, li, kv_int8, d)
        for bi in range(b):
            np.testing.assert_allclose(gk[bi, :, :lens[bi]], wk[bi, :, :lens[bi]], **tol)


def _step_tokens(tp, carry, max_len, kv_int8):
    opts = tinf.GenerateOptions(ddpm_steps=2, max_length=max_len, kv_int8=kv_int8)
    b = carry.h_pos.shape[0]
    _, out = tinf.step(CFG, tp, carry, torch.zeros(b, dtype=torch.bool),
                       tokens=tinf.SpecialTokens(**TOK), opts=opts,
                       coeffs=tinf.make_solver(CFG, opts),
                       generator=torch.Generator().manual_seed(9))
    return out.tokens


@pytest.mark.parametrize("kv_int8", [False, True])
def test_ring_prefill_carry_matches_jax(models, world4, kv_int8):
    """The decode hand-off of a 4-rank ring prefill == JAX's
    ring_prefill_carry and JAX's prefill_fn (cache lengths, h_pos, h_neg,
    the valid cache prefix of the first and last layer), and one decode step
    of the port from it picks the tokens that one from the port's prefill_fn
    picks. int8 KV: prefill_fn attends through the quantized cache while
    the ring attends exactly and quantizes on write, hence 2e-2
    (tests/test_ring_attention.py:135-139)."""
    jp, tp = models
    ids, valid, max_len = _prompt()
    b = ids.shape[0]
    got = world4[f"prefill_{kv_int8}"]
    toks = jinf.SpecialTokens(**TOK)
    jring = jsp.ring_prefill_carry(JCFG, jp, jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
                                   max_len, toks, jax_make_mesh(dp=1, tp=4), q_chunk=4,
                                   kv_int8=kv_int8)
    jref = jinf.prefill_fn(JCFG, jp, jnp.asarray(ids, jnp.int32), max_len, jnp.asarray(valid),
                           None, False, toks, "audio", kv_int8)
    tol = dict(rtol=2e-2, atol=2e-2) if kv_int8 else dict(rtol=5e-5, atol=5e-5)
    for want in (jring, jref):
        _assert_carries_close(got, want, b, tol, kv_int8)
    tref = tinf.prefill_fn(CFG, tp, T(ids), max_len, T(valid), None, tinf.SpecialTokens(**TOK),
                           "audio", kv_int8)
    assert torch.equal(_step_tokens(tp, got, max_len, kv_int8),
                       _step_tokens(tp, tref, max_len, kv_int8))


def test_ring_prefill_carry_refuses_ids_that_differ_between_ranks(world4):
    assert "differs between the ranks" in world4["other_ids"]


def test_world_of_one_matches_prefill_fn(models, tmp_path):
    """A one-rank group (one hop over the whole prompt, no exchange) with a
    voice prompt spliced in == the port's prefill_fn on every layer, and
    the next decode step picks the same tokens."""
    _, tp = models
    ids, valid, max_len = _prompt()
    speech = _voice_prompt(ids)
    got = _run_world(1, tmp_path, {"prefill": (_job_prefill, (tp, T(ids), T(valid), max_len,
                                                              False, speech))})["prefill"]
    want = tinf.prefill_fn(CFG, tp, T(ids), max_len, T(valid), speech, tinf.SpecialTokens(**TOK))
    _assert_carries_close(got, want, ids.shape[0], dict(rtol=1e-5, atol=1e-5), False)
    for li in range(CFG.decoder_config.num_hidden_layers):
        for gc, wc in ((got.cache.k[li], want.cache.k[li]), (got.cache.v[li], want.cache.v[li])):
            for bi, n in enumerate(valid.sum(axis=1)):
                np.testing.assert_allclose(gc[bi, :, :n], wc[bi, :, :n], rtol=1e-5, atol=1e-5)
    assert torch.equal(_step_tokens(tp, got, max_len, False), _step_tokens(tp, want, max_len, False))
