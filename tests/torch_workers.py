"""gloo worlds for the port's parallel tests, and the jobs their ranks run.

This module imports torch and the port only: the JAX side of a comparison
runs in the test's own process, and every rank checks that no module of
JAX was imported into it. ``run_world`` spawns the ranks
(torch.multiprocessing, a file store under the test's tmp_path, one thread
each), runs every job on every rank over the mesh its spec names, and
returns each rank's results; a world that does not finish within its time
limit is killed and fails the test.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vibevoice_tpu_torch.parallel import mesh as pmesh
from vibevoice_tpu_torch.parallel import pipeline as pl


def make(spec):
    kind, *dims = spec
    if kind == "mesh":
        return pmesh.make_mesh(*dims)
    if kind == "hybrid":
        return pmesh.make_hybrid_mesh(*dims)
    if kind == "pp":
        return pl.make_pp_mesh(*dims)
    raise ValueError(kind)


def _world(rank, world, store, out, jobs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        results = {}
        for name, (spec, fn, args) in jobs.items():
            mesh = make(spec) if spec is not None else None
            results[name] = fn(mesh, *args)
        results["_jax_imported"] = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
        torch.save(results, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def run_world(world: int, tmp, jobs: dict, timeout: float = 120.0) -> list:
    """Every job {name: (mesh spec or None, fn(mesh, *args), args)} on every
    rank of a gloo world; each rank's {name: result}."""
    tmp.mkdir(parents=True, exist_ok=True)  # gloo's file store waits for a missing directory
    out = str(tmp / "results")
    ctx = mp.start_processes(_world, args=(world, str(tmp / "pg"), out, jobs), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a world of {world} did not finish in {timeout} s")
    res = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
    for r, rr in enumerate(res):
        assert not rr.pop("_jax_imported"), f"rank {r} imported JAX"
    return res


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------


def t(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def tp_decode(mesh, cfg, params, ids, mask, max_len, ext, bank, forced, k, kv_int8, tokens):
    """Prefill and one window of K frames with the LM on this rank's
    shards (mesh None: the dense run): tokens, audio, the carry's h_pos and
    lengths, and this rank's layer-0 K cache."""
    from vibevoice_tpu_torch.models import inference as inf

    group = None
    if mesh is not None:
        params = pmesh.shard_params(params, pmesh.model_param_shardings(
            params, mesh, cfg.decoder_config.head_dim), mesh)
        group = mesh.get_group("tp")
    toks = inf.SpecialTokens(**tokens)
    opts = inf.GenerateOptions(ddpm_steps=2, max_length=max_len, kv_int8=kv_int8)
    with torch.no_grad():
        carry = inf.prefill_fn(cfg, params, t(ids), max_len, t(mask), None, toks,
                               kv_int8=kv_int8, tp_group=group)
        hooks = {**{n: t(v) for n, v in bank.items()}, "forced": t(forced)}
        noise = inf.draw_noise(cfg, opts, ids.shape[0], torch.Generator().manual_seed(0),
                               frames=k, inject=True)
        step = inf.make_multi_step_fn(cfg, toks, opts, k, inject=True, tp_group=group)
        carry, out = step(params, carry, noise, t(ext), hooks)
    return dict(tokens=out.tokens.numpy(), audio=out.audio.float().numpy(),
                h_pos=carry.h_pos.float().numpy(), length=carry.cache.length.numpy(),
                k0=carry.cache.k[0].float().numpy())


def tp_train_forward(mesh, cfg, lm, x, valid, w):
    """The no-cache forward over this rank's shards and the gradients of
    sum(h * w) w.r.t. x and the shards (mesh None: the dense run)."""
    from vibevoice_tpu_torch.finetune.train_step import tree_leaves_with_path
    from vibevoice_tpu_torch.models import qwen2

    group = None
    if mesh is not None:
        lm = pmesh.shard_params(lm, pmesh.qwen2_param_shardings(lm, mesh, cfg.head_dim), mesh)
        group = mesh.get_group("tp")
    leaves = dict(tree_leaves_with_path(lm))
    live = {p: v.detach().requires_grad_(True) for p, v in leaves.items() if p != ("embed",)}
    from vibevoice_tpu_torch.finetune.train_step import tree_replace

    tree = tree_replace(lm, live)
    xx = t(x).requires_grad_(True)
    h, _ = qwen2.forward(cfg, tree, xx, valid_mask=t(valid), tp_group=group)
    grads = torch.autograd.grad((h * t(w)).sum(), [xx] + list(live.values()))
    return dict(h=h.detach().numpy(), dx=grads[0].numpy(),
                grads={p: g.numpy() for p, g in zip(live, grads[1:])})


def train_steps(mesh, cfg, params, batch, draws, n_steps, fsdp_min, lora_cfg=None, lora=None,
                pp=None, remat=False, remat_policy=None):
    """``n_steps`` train steps of the global batch (this rank's samples and
    draws over the data axes), full fine-tuning or LoRA: each step's loss
    and the gathered trainable tree after them. The optimizer's warmup of
    one step makes the first update 0; its eps of 1 makes the later ones
    about a tenth of the clipped gradient (linear in it, so that the trees
    compare as the gradients do; AdamW's eps of 1e-8 maps a gradient near 0
    to a full step of either sign)."""
    from vibevoice_tpu_torch.finetune import loss as tloss
    from vibevoice_tpu_torch.finetune import train_step as tts

    optimizer = tts.Optimizer(learning_rate=1.0, warmup_steps=1, total_steps=10, eps=1.0)
    axes = pmesh.data_axes(mesh) if mesh is not None else ()
    n = pmesh.axis_size(mesh, axes)
    i = pmesh.axis_index(mesh, axes) if mesh is not None else 0
    local = batch if n == 1 else tloss.split_batch(batch, n, i)
    b = np.asarray(batch.input_ids).shape[0] // n
    t_ = np.asarray(batch.input_ids).shape[1]
    m = draws.noise.shape[0] // (np.asarray(batch.input_ids).shape[0] * t_)
    loc_clips = np.asarray(local.speech_tensors).shape[0]
    c0 = 0
    if n > 1:  # this rank's clips start after those of the ranks before it
        for j in range(i):
            c0 += np.asarray(tloss.split_batch(batch, n, j).speech_tensors).shape[0]
    rows = slice(i * b * t_ * m, (i + 1) * b * t_ * m)
    d = tloss.Draws(None if draws.vae_std is None else draws.vae_std[c0:c0 + loc_clips],
                    draws.vae_eps[c0:c0 + loc_clips], draws.noise[rows], draws.timesteps[rows])
    if pp is not None:
        params = dict(params)
        params["lm"] = pl.stack_layers(params["lm"], pp["stages"])
    if lora is not None:
        shard = pmesh.lora_param_shardings(lora)
        base_sh = pmesh.model_param_shardings(params, mesh, cfg.decoder_config.head_dim)
        base = pmesh.shard_params(params, base_sh, mesh)
        state = tts.init_train_state(pmesh.shard_params(lora, shard, mesh), optimizer)
        step = tts.make_lora_train_step(cfg, optimizer, lora_cfg,
                                        parallel=tts.Parallel(mesh, shard, base_sh))
        run = lambda st: step(st, base, local, d)
    else:
        if mesh is None:
            shard = None
        elif pp is not None:
            shard = pl.pp_model_param_shardings(params)
        elif fsdp_min:
            shard = pmesh.fsdp_param_shardings(params, mesh, min_leaf_size=fsdp_min,
                                               head_dim=cfg.decoder_config.head_dim)
        else:
            shard = pmesh.model_param_shardings(params, mesh, cfg.decoder_config.head_dim)
        lm_forward = None if pp is None else pl.make_pp_lm_forward(mesh, pp["microbatches"])
        if shard is not None:
            params = pmesh.shard_params(params, shard, mesh)
        state = tts.init_train_state(params, optimizer)
        step = tts.make_train_step(cfg, optimizer,
                                   tloss.TrainOptions(remat=remat, remat_policy=remat_policy),
                                   parallel=None if mesh is None else
                                   tts.Parallel(mesh, shard, lm_forward=lm_forward))
        run = lambda st: step(st, local, d)
    losses = []
    for _ in range(n_steps):
        state, out = run(state)
        losses.append(float(out.loss))
    tree = state.params if shard is None else pmesh.gather_params(state.params, shard, mesh)
    if pp is not None:
        tree = dict(tree)
        tree["lm"] = pl.unstack_layers(tree["lm"])
    fsdp_split = [] if shard is None else sorted(
        str(p) for p, s in _spec_leaves(shard) if "dp" in pmesh.shard_axes(s))
    mu_shapes = {str(p): tuple(x.shape) for p, x in list(state.opt_state.mu.items())[:400]}
    return dict(losses=losses, tree={str(p): x.float().numpy() for p, x in
                                     tts.tree_leaves_with_path(tree)},
                fsdp_split=fsdp_split, mu_shapes=mu_shapes)


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _spec_leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _spec_leaves(v, path + (i,))]
    return [(path, tree)]


def tp_engine(mesh, cfg, params, requests, k, max_batch, max_len, init, tokens, stagger):
    """A ServingEngine (TP over ``mesh``, or one device without) with every
    frame forced to speech_diffusion and the initial latents read from the
    bank ``init`` (E, max_batch, D) by each row's diffusion count. Rank 0
    submits the first request and, with ``stagger``, the others once the
    first is decoding (they join between its windows); it returns each
    request's audio and tokens; every rank its windows' tokens."""
    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving.engine import Request, ServingEngine

    toks = inf.SpecialTokens(**tokens)
    eng = ServingEngine(cfg, params, tokens=toks, max_batch=max_batch, max_len=max_len,
                        opts=inf.GenerateOptions(ddpm_steps=2, max_length=max_len),
                        frames_per_dispatch=k, mesh=mesh)
    real = eng.step_fn
    hooks = {"init": t(init), "forced": torch.full((k, max_batch), toks.speech_diffusion)}
    eng.step_fn = lambda p, c, noise, ext: real(p, c, noise, ext, hooks)
    out = {}
    try:
        if eng.leader:
            reqs = [Request(input_ids=ids, valid_mask=np.ones_like(ids, bool), max_length_times=x)
                    for ids, x in requests]
            handles = [eng.submit(reqs[0])]
            if stagger:
                assert eng.wait_for_state(lambda: len(handles[0].tokens) > 0, 60)
            handles += [eng.submit(r) for r in reqs[1:]]
            out["joined_while_decoding"] = stagger and not handles[0]._done.is_set()
            out["audio"] = [h.result(timeout=60) for h in handles]
            out["tokens"] = [list(h.tokens) for h in handles]
    finally:
        eng.shutdown()
    out["token_log"] = [np.asarray(x) for x in eng.token_log]
    return out


def tp_engine_drain(mesh, cfg, params, ids, frames, tokens, max_len):
    """A graceful drain (shutdown(drain=True)) begun while rank 0 takes the
    only request into its slot: the queue's task_done lingers 0.3 s, so a
    request counted done before its slot held it would leave the engine
    idle for the drain to stop. Rank 0 returns the request's audio samples
    and its error (None when it ran to its end)."""
    import queue
    import threading

    from vibevoice_tpu_torch.models import inference as inf
    from vibevoice_tpu_torch.serving.engine import Request, ServingEngine

    class SlowDone(queue.PriorityQueue):
        def task_done(self):
            super().task_done()
            if threading.current_thread() is not threading.main_thread():
                time.sleep(0.3)

    toks = inf.SpecialTokens(**tokens)
    eng = ServingEngine(cfg, params, tokens=toks, max_batch=2, max_len=max_len, mesh=mesh,
                        opts=inf.GenerateOptions(ddpm_steps=2, max_length=max_len),
                        frames_per_dispatch=2)
    eng.pending = SlowDone()
    real = eng.step_fn
    hooks = {"init": torch.zeros(8, 2, cfg.acoustic_vae_dim),
             "forced": torch.full((2, 2), toks.speech_diffusion)}
    eng.step_fn = lambda p, c, noise, ext: real(p, c, noise, ext, hooks)
    out = {}
    if eng.leader:
        h = eng.submit(Request(input_ids=ids, valid_mask=np.ones_like(ids, bool),
                               max_length_times=(frames + 0.5) / ids.shape[1]))
        eng.shutdown(timeout=60, drain=True)
        try:
            out["samples"], out["error"] = len(h.result(timeout=5)), None
        except Exception as e:
            out["samples"], out["error"] = None, repr(e)
    else:
        eng.shutdown()
    return out


def engine_refuses_int8(mesh, cfg, params):
    """The error a TP engine gives an int8 LM."""
    from vibevoice_tpu_torch.models import vibevoice as vv
    from vibevoice_tpu_torch.serving.engine import ServingEngine

    try:
        ServingEngine(cfg, vv.quantize_for_inference(params), mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def mesh_axes(mesh):
    """A mesh's dimension names and data axes."""
    return tuple(mesh.mesh_dim_names), pmesh.data_axes(mesh)


def pp_forward(mesh, cfg, lm, x, valid, w, m, remat=False, remat_policy=None):
    """The GPipe forward of this rank's stage over ``m`` micro-batches (mesh
    None: the dense qwen2.forward), each layer recomputed in the backward
    under ``remat`` (``remat_policy``), and the gradients of sum(h * w)
    w.r.t. x and the layer leaves (this stage's (1, L/pp, ...), or the
    whole stack's (1, L, ...) for the dense run)."""
    from vibevoice_tpu_torch.models import qwen2

    pp = 1 if mesh is None else pmesh.axis_size(mesh, "pp")
    stacked = pl.stack_layers(lm, pp)
    if mesh is not None:
        stacked = pmesh.shard_params(stacked, pl.pp_lm_param_shardings(stacked), mesh)
    names = [str(p) for p, _ in _spec_leaves(stacked["layers_stacked"])]
    live = [v.detach().requires_grad_(True) for _, v in _spec_leaves(stacked["layers_stacked"])]
    it = iter(live)
    layers = _rebuild(stacked["layers_stacked"], it)
    tree = {**stacked, "layers_stacked": layers}
    xx = t(x).requires_grad_(True)
    if mesh is None:
        h, _ = qwen2.forward(cfg, pl.unstack_layers(tree), xx, valid_mask=t(valid), remat=remat,
                             remat_policy=remat_policy)
    else:
        h = pl.pipelined_forward(cfg, tree, xx, mesh, valid_mask=t(valid), n_microbatches=m,
                                 remat=remat, remat_policy=remat_policy)
    grads = torch.autograd.grad((h * t(w)).sum(), [xx] + live)
    return dict(h=h.detach().numpy(), dx=grads[0].numpy(),
                grads={n: g.numpy() for n, g in zip(names, grads[1:])})


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def ckpt_roundtrip(mesh, cfg, params, path):
    """A train state of this rank's TP shards (AdamW moments, counts, a
    step) saved and restored into zeros of the same layout; the parameters
    saved again and restored whole (no mesh) on every rank. Whether each
    came back bit-equal, and the shapes of the shards."""
    from vibevoice_tpu_torch.finetune import train_step as tts
    from vibevoice_tpu_torch.utils import checkpoint as ck

    sh = pmesh.model_param_shardings(params, mesh, cfg.decoder_config.head_dim)
    local = pmesh.shard_params(params, sh, mesh)
    opt = tts.make_optimizer()
    state = tts.init_train_state(local, opt)
    mu = {p: torch.randn(x.shape, generator=torch.Generator().manual_seed(len(p)))
          for p, x in state.opt_state.mu.items()}
    state = state._replace(opt_state=state.opt_state._replace(count=3, mu=mu), step=3)
    specs = lambda d: {p: _spec_of(sh, p) for p in d}
    st_specs = tts.TrainState(sh, tts.OptState((), specs(mu), specs(mu), (), specs(mu)), ())
    ck.save_train_state(f"{path}/state", state, mesh, st_specs)
    zeros = lambda tree: _map(torch.zeros_like, tree)
    target = tts.TrainState(zeros(local), state.opt_state._replace(
        count=0, mu=zeros(mu), nu=zeros(state.opt_state.nu), acc=zeros(state.opt_state.acc)), 0)
    back = ck.restore_train_state(f"{path}/state", target, mesh, st_specs)
    same = lambda a, b: all(torch.equal(x, y) for (_, x), (_, y) in
                            zip(tts.tree_leaves_with_path(a), tts.tree_leaves_with_path(b)))
    ck.save_params_sharded(f"{path}/params", local, mesh, sh)
    whole = ck.restore_params_sharded(f"{path}/params", zeros(params))
    return dict(state=same(back.params, local) and same(back.opt_state.mu, mu)
                and back.opt_state.count == 3 and back.step == 3,
                whole=same(whole, params),
                q_shape=tuple(local["lm"]["layers"][0]["attn"]["q"]["w"].shape))


def _spec_of(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree
