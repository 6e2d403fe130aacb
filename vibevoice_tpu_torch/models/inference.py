"""Generation engine of the multi-speaker model
(port of vibevoice_tpu/models/inference.py).

One step per 7.5 Hz frame:

    constrained token choice -> negative-stream length bookkeeping ->
    CFG DPM-Solver over the diffusion head -> streaming vocode of one frame ->
    semantic re-encode -> next-step embeddings -> one LM step for both CFG
    streams (batch 2B)

The positive stream lives in cache rows [0, B), the negative CFG stream in
rows [B, 2B). Every step writes the negative stream speculatively
(advance 0) and the next step commits the slot only for samples that were
diffusing; ``speech_start`` resets a negative stream to length 1.

``frames_per_dispatch = K`` runs K steps per window and reads the window's
outputs back with one host synchronisation; sequences are identical for
every K. The window is the compiled step of ``make_step_fn`` /
``make_multi_step_fn`` (the JAX package's jitted, donated step): on the card
it is captured once into a CUDA graph and replayed, so a frame costs one
graph launch instead of a host dispatch per kernel. The step draws nothing
itself: before each window the host loop draws its noise (``FrameNoise``:
initial latents, SDE noise, the token choice's uniforms) frame by frame from
a ``torch.Generator`` seeded with ``seed``, so eager and graphed runs, and
runs of every K, consume the same numbers. The injection hooks
(``noise_bank``, ``forced_tokens``) replay another implementation's draws
in tests.

Tensor-parallel serving: ``tp_group`` (prefill, step functions,
``generate``) runs the LM on this rank's shards (``qwen2`` docstring); the
cache holds the local KV heads, everything else is replicated and computed
alike on every rank, so every rank chooses the same tokens. A capture under
an NCCL group records its all-reduces (its first, eager frame warms the
communicator up); a gloo collective cannot be captured, so a graphed call
under a gloo group raises and the caller runs ``StepFn.eager``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import VibeVoiceConfig

from ..ops import _cuda
from ..schedule import dpm_solver as dpm
from . import diffusion_head as dh
from . import qwen2
from . import tokenizer as tok
from . import vibevoice as vv


@dataclass(frozen=True)
class SpecialTokens:
    """Speech control tokens (Qwen2.5-VL vision token ids)."""

    speech_start: int = 151652
    speech_end: int = 151653
    speech_diffusion: int = 151654
    eos: int = 151643
    bos: Optional[int] = None

    @property
    def candidates(self):
        c = [self.speech_start, self.speech_end, self.speech_diffusion, self.eos]
        if self.bos is not None:
            c.append(self.bos)
        return tuple(c)


@dataclass(frozen=True)
class GenerateOptions:
    cfg_scale: float = 1.3
    ddpm_steps: int = 10
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    refresh_negative: bool = True
    max_length_times: float = 2.0
    max_length: Optional[int] = None  # defaults to the LM context length
    sde: bool = False
    frames_per_dispatch: int = 1
    prefill_chunk: int = 2048  # prompts longer than this prefill in chunks
    kv_int8: Optional[bool] = None  # None: on at >= KV_INT8_AUTO_LEN cache slots


KV_INT8_AUTO_LEN = 16384


def resolve_kv_int8(opts: GenerateOptions, max_length: int) -> GenerateOptions:
    """Apply the automatic int8-KV policy; an explicit True/False wins."""
    if opts.kv_int8 is not None:
        return opts
    return dataclasses.replace(opts, kv_int8=max_length >= KV_INT8_AUTO_LEN)


class DecodeCarry(NamedTuple):
    cache: qwen2.KVCache  # batch 2B: positive rows [0, B), negative rows [B, 2B)
    dec_state: Dict
    sem_state: Dict
    h_pos: torch.Tensor  # (B, H) hidden that emits this step's token
    h_neg: torch.Tensor
    finished: torch.Tensor  # (B,) bool
    n_diff: torch.Tensor  # (B,) int64 diffusion-event count (noise-bank index)


class StepOut(NamedTuple):
    tokens: torch.Tensor  # (B,)
    audio: torch.Tensor  # (B, hop, 1)
    audio_mask: torch.Tensor  # (B,) bool: the sample produced audio this step
    finished: torch.Tensor  # (B,)


@dataclass
class GenerationOutput:
    sequences: np.ndarray
    speech_outputs: Optional[List[Optional[np.ndarray]]] = None
    reach_max_step_sample: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _combine_caches(pos: qwen2.KVCache, neg: qwen2.KVCache) -> qwen2.KVCache:
    """Stack the two streams row-wise into one 2B cache (one-time copy)."""
    cat = lambda a, b: tuple(torch.cat([x, y], dim=0) for x, y in zip(a, b))
    return qwen2.KVCache(
        k=cat(pos.k, neg.k),
        v=cat(pos.v, neg.v),
        length=torch.cat([pos.length, neg.length]),
        k_scale=cat(pos.k_scale, neg.k_scale) if pos.quantized else None,
        v_scale=cat(pos.v_scale, neg.v_scale) if pos.quantized else None,
    )


def _prompt_embeds(cfg, params, ids, speech_args, speech_type):
    embeds = qwen2.embed_tokens(params["lm"], ids)
    if speech_args is not None:
        speech_tensors, frame_valid, input_mask, generator, vae_noise = speech_args
        feats = vv.encode_voice_features(cfg, params, speech_tensors, generator, speech_type,
                                         vae_noise)
        embeds = vv.splice_speech_features(embeds, input_mask, feats, frame_valid)
    return embeds


def _init_streams(cfg, params, b, max_len, tokens, kv_int8, tp_group=None):
    """Empty positive cache, prefilled negative stream (a 1-token
    <speech_start> prompt) and zero conv states."""
    lm_cfg = cfg.decoder_config
    embed = params["lm"]["embed"]
    dtype, dev = embed.dtype, embed.device
    kh = qwen2.local_kv_heads(lm_cfg, tp_group)
    pos_cache = qwen2.make_cache(lm_cfg, b, max_len, dtype, quantized=kv_int8, device=dev,
                                 kv_heads=kh)
    neg_ids = torch.full((b, 1), tokens.speech_start, dtype=torch.long, device=dev)
    neg_cache = qwen2.make_cache(lm_cfg, b, max_len, dtype, quantized=kv_int8, device=dev,
                                 kv_heads=kh)
    h_neg, neg_cache = qwen2.forward(lm_cfg, params["lm"], qwen2.embed_tokens(params["lm"], neg_ids),
                                     cache=neg_cache, tp_group=tp_group)
    dec_state = tok.init_decoder_state(cfg.acoustic_tokenizer_config, b, dtype, dev)
    sem_state = tok.init_encoder_state(cfg.semantic_tokenizer_config, b, dtype, dev)
    return pos_cache, neg_cache, h_neg[:, 0], dec_state, sem_state


def prefill_fn(cfg: VibeVoiceConfig, params, ids: torch.Tensor, max_len: int,
               valid_mask: torch.Tensor, speech_args, tokens: SpecialTokens,
               speech_type: str = "audio", kv_int8: bool = False,
               tp_group=None) -> DecodeCarry:
    """Whole-prompt prefill of both streams; returns the first DecodeCarry."""
    b = ids.shape[0]
    embeds = _prompt_embeds(cfg, params, ids, speech_args, speech_type)
    pos_cache, neg_cache, h_neg, dec_state, sem_state = _init_streams(
        cfg, params, b, max_len, tokens, kv_int8, tp_group)
    h, pos_cache = qwen2.forward(cfg.decoder_config, params["lm"], embeds, valid_mask=valid_mask,
                                 cache=pos_cache, tp_group=tp_group)
    last = (valid_mask.to(torch.int64).sum(1) - 1).clamp_min(0)
    h_pos = h[torch.arange(b, device=h.device), last]
    return DecodeCarry(_combine_caches(pos_cache, neg_cache), dec_state, sem_state, h_pos, h_neg,
                       torch.zeros(b, dtype=torch.bool, device=h.device),
                       torch.zeros(b, dtype=torch.int64, device=h.device))


def chunked_prefill(cfg: VibeVoiceConfig, params, ids: torch.Tensor, valid_mask: torch.Tensor,
                    max_len: int, tokens: SpecialTokens, speech_args=None, chunk: int = 1024,
                    speech_type: str = "audio", kv_int8: bool = False,
                    tp_group=None) -> DecodeCarry:
    """Long-prompt prefill in fixed-size chunks (bounds attention memory at
    O(chunk x S)); voice features are spliced into the whole prompt once."""
    b, t = ids.shape
    embeds = _prompt_embeds(cfg, params, ids, speech_args, speech_type)
    lengths = valid_mask.to(torch.int64).sum(1)
    pos_cache, neg_cache, h_neg, dec_state, sem_state = _init_streams(
        cfg, params, b, max_len, tokens, kv_int8, tp_group)
    h_pos = torch.zeros(b, cfg.decoder_config.hidden_size, dtype=embeds.dtype, device=embeds.device)
    rows = torch.arange(b, device=embeds.device)
    for c0 in range(0, t, chunk):
        valid = valid_mask[:, c0: c0 + chunk]
        emb = embeds[:, c0: c0 + chunk]
        if valid.shape[1] < chunk:  # pad the last chunk to the fixed size
            pad = chunk - valid.shape[1]
            valid = torch.nn.functional.pad(valid, (0, pad))
            emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        h, pos_cache = qwen2.forward(cfg.decoder_config, params["lm"], emb, valid_mask=valid,
                                     cache=pos_cache, tp_group=tp_group)
        last = lengths - 1
        in_chunk = (last >= c0) & (last < c0 + chunk)
        h_last = h[rows, (last - c0).clamp(0, chunk - 1)]
        h_pos = torch.where(in_chunk[:, None], h_last, h_pos)
    return DecodeCarry(_combine_caches(pos_cache, neg_cache), dec_state, sem_state, h_pos, h_neg,
                       torch.zeros(b, dtype=torch.bool, device=h_pos.device),
                       torch.zeros(b, dtype=torch.int64, device=h_pos.device))


# ---------------------------------------------------------------------------
# The per-frame step
# ---------------------------------------------------------------------------


def make_solver(cfg: VibeVoiceConfig, opts: GenerateOptions) -> dpm.SolverCoeffs:
    hcfg = cfg.diffusion_head_config
    return dpm.make_solver(
        opts.ddpm_steps,
        num_train_timesteps=hcfg.ddpm_num_steps,
        beta_schedule=hcfg.ddpm_beta_schedule,
        prediction_type=hcfg.prediction_type,
        algorithm_type="sde-dpmsolver++" if opts.sde else "dpmsolver++",
    )



class FrameNoise(NamedTuple):
    """The random draws of a window of K frames, each with a leading K axis
    (one frame of ``make_step_fn`` has none): ``init`` (K, B, D) initial
    latents, ``sde`` (K, S, B, D) the SDE solver's noise and ``uniform``
    (K, B) the token choice's uniforms. A field is None where the step reads
    no such draw: ``init`` and ``sde`` under injection (the hooks hold them),
    ``sde`` without opts.sde, ``uniform`` without opts.do_sample."""

    init: Optional[torch.Tensor]
    sde: Optional[torch.Tensor]
    uniform: Optional[torch.Tensor]


def _empty_noise(cfg: VibeVoiceConfig, opts: GenerateOptions, batch: int, frames: int,
                 inject: bool, device) -> FrameNoise:
    f32 = dict(dtype=torch.float32, device=device)
    d = cfg.acoustic_vae_dim
    return FrameNoise(
        None if inject else torch.empty(frames, batch, d, **f32),
        torch.empty(frames, make_solver(cfg, opts).num_steps, batch, d, **f32)
        if opts.sde and not inject else None,
        torch.empty(frames, batch, **f32) if opts.do_sample else None,
    )


def _fill_noise(noise: FrameNoise, generator: torch.Generator) -> FrameNoise:
    """Redraw a window's noise in place, frame by frame in the order init,
    sde, uniform, so that a run draws the same numbers for every K."""
    live = [t for t in noise if t is not None]
    for f in range(live[0].shape[0] if live else 0):
        for t, uniform in zip(noise, (False, False, True)):
            if t is not None:
                (t[f].uniform_ if uniform else t[f].normal_)(generator=generator)
    return noise


def draw_noise(cfg: VibeVoiceConfig, opts: GenerateOptions, batch: int,
               generator: torch.Generator, *, frames: Optional[int] = None,
               inject: bool = False) -> FrameNoise:
    """A window's draws from ``generator`` on its device: ``frames`` K for
    ``make_multi_step_fn``, None for one frame of ``make_step_fn``."""
    noise = _fill_noise(_empty_noise(cfg, opts, batch, frames or 1, inject, generator.device),
                        generator)
    return noise if frames else _frame_of(noise, 0)


def _frame_of(tree, f: int):
    """Frame f of a window's stacked tensors (None stays None)."""
    return _tree_map(lambda t: t[f], tree)


def _inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index i of each row of ``probs`` (B, C) where ``u`` (B,) in [0, 1),
    scaled by the row's total, falls in [cdf[i - 1], cdf[i]); never an
    entry of probability 0."""
    cdf = probs.cumsum(-1)
    pick = (cdf <= u[:, None] * cdf[:, -1:]).sum(-1)
    idx = torch.arange(probs.shape[-1], device=probs.device)
    last = torch.where(probs > 0, idx, torch.zeros_like(idx)).amax(-1)
    return torch.minimum(pick, last)


def _choose_tokens(params, h_pos: torch.Tensor, opts: GenerateOptions, cand: torch.Tensor,
                   uniform: Optional[torch.Tensor]) -> torch.Tensor:
    """Constrained token choice over the candidate set; top-p needs the
    full-vocab distribution, every other mode reads the candidate columns.
    Sampling picks by inverse CDF with the pre-drawn ``uniform`` (B,)."""
    need_full_vocab = opts.do_sample and opts.top_p < 1.0
    if need_full_vocab:
        logits = vv.lm_logits(params, h_pos).float()
        cand_logits = logits[:, cand]
    else:
        cand_logits = vv.lm_logits_cand(params, h_pos, cand).float()
    if not opts.do_sample:
        return cand[cand_logits.argmax(-1)]
    if need_full_vocab:
        # the nucleus is computed over the whole distribution, then
        # intersected with the candidates; the best candidate always stays
        scaled_full = logits / max(opts.temperature, 1e-6)
        probs = torch.softmax(scaled_full, -1)
        sorted_p, order = probs.sort(dim=-1, descending=True, stable=True)  # ties: lower id first
        keep_sorted = (sorted_p.cumsum(-1) - sorted_p) < opts.top_p
        keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
        cand_keep = keep[:, cand]
        cand_scaled = scaled_full[:, cand]
    else:
        cand_keep = torch.ones_like(cand_logits, dtype=torch.bool)
        cand_scaled = cand_logits / max(opts.temperature, 1e-6)
    best = cand_scaled.argmax(-1, keepdim=True)
    cand_keep = cand_keep | (torch.arange(cand.shape[0], device=cand.device) == best)
    probs = torch.softmax(cand_scaled.masked_fill(~cand_keep, float("-inf")), -1)
    return cand[_inverse_cdf(probs, uniform)]


class _StepConsts(NamedTuple):
    """What the step reads that does not change between frames, on the device."""

    cand: torch.Tensor  # (C,) candidate token ids
    timesteps: torch.Tensor  # (S,) solver timesteps


def _step_consts(tokens: SpecialTokens, coeffs: dpm.SolverCoeffs, device) -> _StepConsts:
    return _StepConsts(torch.tensor(tokens.candidates, dtype=torch.long, device=device),
                       torch.from_numpy(coeffs.timesteps).to(device))


def _frame(cfg: VibeVoiceConfig, params, carry: DecodeCarry, ext_finish: torch.Tensor,
           noise: FrameNoise, hooks: Optional[Dict], *, tokens: SpecialTokens,
           opts: GenerateOptions, coeffs: dpm.SolverCoeffs, consts: _StepConsts,
           tp_group=None):
    """The body of one frame over device tensors: it copies nothing from the
    host and draws nothing (``noise`` holds one frame's draws), so a CUDA
    graph can capture it."""
    lm_cfg = cfg.decoder_config
    hcfg = cfg.diffusion_head_config
    b = carry.h_pos.shape[0]
    dev = carry.h_pos.device

    # 1. constrained token choice
    next_tok = _choose_tokens(params, carry.h_pos, opts, consts.cand, noise.uniform)
    if hooks is not None:
        next_tok = torch.where(hooks["forced"] >= 0, hooks["forced"], next_tok)
    next_tok = torch.where(carry.finished, torch.full_like(next_tok, tokens.eos), next_tok)
    finished = carry.finished | (next_tok == tokens.eos) | ext_finish
    diff_mask = (next_tok == tokens.speech_diffusion) & ~finished
    end_mask = next_tok == tokens.speech_end
    start_mask = (next_tok == tokens.speech_start) & ~finished

    # 2. negative-stream bookkeeping: commit last step's speculative slot for
    # diffusing samples, reset streams that just emitted <speech_start>
    cache = carry.cache
    pos_len, neg_len = cache.length[:b], cache.length[b:]
    if opts.refresh_negative:
        neg_len = neg_len + diff_mask.to(torch.int32)
        neg_len = torch.where(start_mask, torch.ones_like(neg_len), neg_len)
    cache = cache._replace(length=torch.cat([pos_len, neg_len]))

    # 3. conv-state reset on speech_end
    dec_state = tok.reset_state(carry.dec_state, end_mask)
    sem_state = tok.reset_state(carry.sem_state, end_mask)

    # 4. CFG diffusion; AdaLN modulations of all solver steps computed once
    head = params["diffusion_head"]
    mods = dh.precompute_mods(head, hcfg, consts.timesteps, torch.cat([carry.h_pos, carry.h_neg]))
    extras = [dh.step_mods(mods, i) for i in range(coeffs.num_steps)]
    if hooks is not None:
        rows = torch.arange(b, device=dev)
        e = carry.n_diff.clamp(0, hooks["init"].shape[0] - 1)
        x_init = hooks["init"][e, rows].float()
        sde_noise = hooks["sde"][e, :, rows].transpose(0, 1).float() if opts.sde else None
    else:
        x_init, sde_noise = noise.init, noise.sde  # (B, D), (S, B, D)
    latent = dpm.cfg_sample(
        coeffs, lambda x, t, e: dh.apply_with_mods(head, hcfg, x, e), carry.h_pos, carry.h_neg,
        opts.cfg_scale, x_init, noise=sde_noise, extras=extras,
    )

    # 5. vocode one frame + semantic re-encode; commit states for diffusing samples
    dtype = params["lm"]["embed"].dtype
    scaled = latent / params["speech_scaling_factor"] - params["speech_bias_factor"]
    audio, dec_new = tok.decode(cfg.acoustic_tokenizer_config, params["acoustic_tokenizer"],
                                scaled[:, None, :].to(dtype), dec_state)
    sem_mean, sem_new = tok.encode(cfg.semantic_tokenizer_config, params["semantic_tokenizer"],
                                   audio, sem_state)
    commit = diff_mask.reshape(-1, 1, 1)
    dec_state = {k: torch.where(commit, dec_new[k], v) for k, v in dec_state.items()}
    sem_state = {k: torch.where(commit, sem_new[k], v) for k, v in sem_state.items()}

    # 6. next-step embeddings
    acoustic_embed = vv.connector_apply(params["acoustic_connector"], latent.to(dtype))
    semantic_embed = vv.connector_apply(params["semantic_connector"], sem_mean[:, 0])
    tok_embeds = qwen2.embed_tokens(params["lm"], next_tok)
    next_embeds = torch.where(diff_mask[:, None], acoustic_embed + semantic_embed, tok_embeds)

    # 7. one LM step for both streams (same inputs; rows [0,B) positive)
    both = torch.cat([next_embeds, next_embeds])[:, None, :]
    ones = torch.ones(b, dtype=torch.int32, device=dev)
    advance = torch.cat([ones, torch.zeros_like(ones) if opts.refresh_negative else ones])
    h_both, cache = qwen2.forward(lm_cfg, params["lm"], both, cache=cache, advance=advance,
                                  tp_group=tp_group)

    new_carry = DecodeCarry(cache, dec_state, sem_state, h_both[:b, 0], h_both[b:, 0], finished,
                            carry.n_diff + diff_mask.to(torch.int64))
    return new_carry, StepOut(next_tok, audio, diff_mask, finished)


def step(cfg: VibeVoiceConfig, params, carry: DecodeCarry, ext_finish: torch.Tensor, *,
         tokens: SpecialTokens, opts: GenerateOptions, coeffs: dpm.SolverCoeffs,
         generator: torch.Generator, hooks: Optional[Dict] = None, tp_group=None):
    """One frame, run eagerly, with its draws taken from ``generator``.
    ``hooks`` (injection) holds "forced" (B,) tokens or -1, "init" (E, B, D)
    per-event initial latents and, for SDE, "sde" (E, S, B, D), indexed by
    the per-sample diffusion-event count."""
    noise = draw_noise(cfg, opts, carry.h_pos.shape[0], generator, inject=hooks is not None)
    consts = _step_consts(tokens, coeffs, carry.h_pos.device)
    return _frame(cfg, params, carry, ext_finish, noise, hooks, tokens=tokens, opts=opts,
                  coeffs=coeffs, consts=consts, tp_group=tp_group)


# ---------------------------------------------------------------------------
# The compiled step: K frames captured once in a CUDA graph and replayed
# ---------------------------------------------------------------------------


def _tree_map(fn, *trees):
    """fn over the tensors of equally shaped NamedTuples, dicts, tuples and
    lists; None and other leaves of the first tree pass through."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return t


def _copy_into(dst, src) -> None:
    _tree_map(lambda d, s: d if d is s else d.copy_(s), dst, src)


def _read_launches() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in _cuda.LAUNCH_COUNTERS.items()}


def _add_launches(counts: Dict[str, int]) -> None:
    """A replay launches what its capture recorded without running the
    kernels' wrappers, so each replay adds the capture's counts itself."""
    for name, n in counts.items():
        fn, attr = _cuda.LAUNCH_COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)


class _Capture:
    """One captured window: the graph, its static inputs and outputs, and
    the kernel launches it holds."""

    def __init__(self, params, carry, noise, ext_finish, hooks):
        self.params = params  # the graph reads these tensors: keep them alive
        clone = lambda t: t.clone()
        self.carry = _tree_map(clone, carry)
        self.noise = _tree_map(clone, noise)
        self.ext_finish = ext_finish.clone()
        self.hooks = _tree_map(clone, hooks)
        self.graph = torch.cuda.CUDAGraph()
        self.out: Optional[StepOut] = None
        self.launches: Dict[str, int] = {}  # each kernel's launches in one replay


MAX_CAPTURES = 4  # captured windows kept in all, the least recently used dropped
_captures: "OrderedDict[tuple, _Capture]" = OrderedDict()  # (StepFn, key) -> capture
_captures_lock = threading.Lock()


class StepFn:
    """The compiled frame step of ``make_step_fn`` / ``make_multi_step_fn``:

        step_fn(params, carry, noise, ext_finish, hooks=None) -> (carry, out)

    ``noise`` is the window's ``FrameNoise`` (``draw_noise``), ``ext_finish``
    (K, B) bool marks frames stopped from outside, ``hooks`` (injection)
    holds "init" (E, B, D), "sde" (E, S, B, D) under opts.sde and "forced"
    (K, B); ``out`` is the StepOut stacked over K. From ``make_step_fn`` the
    K axis is absent from the per-frame inputs and from ``out``.

    On CUDA tensors the window of K frames is captured once into a
    ``torch.cuda.CUDAGraph`` per (params object, B, cache slots, cache dtype,
    device, hook shapes), after one eager frame, and replayed; a capture
    that fails raises. Each capture holds a static copy
    of the carry, KV cache included, so at most ``MAX_CAPTURES`` are kept
    over all step functions. The graph reads the tensors of
    ``params`` as they were at capture, and runs in static buffers, like
    JAX's donated carry: the returned carry and ``out`` are overwritten by
    the next call, so copy out what is kept before calling again. Passing
    back the carry it returned costs nothing; another carry (a new prefill)
    is copied in, its KV cache included. A caller that owns the step
    function, as ``serving.ServingEngine`` does, may edit rows of the
    returned carry in place between calls (a request joined into a slot):
    the next call replays on the edited static carry and copies nothing.
    Otherwise one request at a time owns a
    step function's captures: ``request()`` holds them for its length
    (``generate`` takes it), and a call from another thread waits until
    it ends; each call holds them too. On CPU tensors the same body runs
    eagerly. ``eager`` is the same call without the graph on any device,
    the reference that the graphed runs are held to. ``replays`` counts the
    graph launches. With ``tp_group`` the LM runs on this rank's shards; a
    graphed call needs an NCCL group (a gloo group raises: call ``eager``)."""

    def __init__(self, cfg: VibeVoiceConfig, tokens: SpecialTokens, opts: GenerateOptions,
                 frames: int, stacked: bool, tp_group=None):
        self.cfg, self.tokens, self.opts = cfg, tokens, opts
        self.frames, self.stacked = frames, stacked
        self.tp_group = tp_group
        self.coeffs = make_solver(cfg, opts)
        self.replays = 0
        self._consts: Dict = {}
        self._owner = threading.RLock()

    def request(self):
        """The step function's captures held by the calling thread until the
        block ends: ``with step_fn.request(): ...`` around one request's
        windows, so that no other request's carry is copied in between."""
        return self._owner

    def _window(self, params, carry, noise, ext_finish, hooks, frames):
        """``frames`` frames of the eager body over stacked inputs."""
        dev = carry.h_pos.device
        consts = self._consts.get(dev)
        if consts is None:
            consts = self._consts[dev] = _step_consts(self.tokens, self.coeffs, dev)
        outs = []
        for f in range(frames):
            h = None if hooks is None else {**hooks, "forced": hooks["forced"][f]}
            carry, out = _frame(self.cfg, params, carry, ext_finish[f], _frame_of(noise, f), h,
                                tokens=self.tokens, opts=self.opts, coeffs=self.coeffs,
                                consts=consts, tp_group=self.tp_group)
            outs.append(out)
        return carry, StepOut(*(torch.stack(x) for x in zip(*outs)))

    def _stack(self, noise, ext_finish, hooks):
        """Give make_step_fn's per-frame inputs the K axis of one frame."""
        if self.stacked:
            return noise, ext_finish, hooks
        hooks = None if hooks is None else {**hooks, "forced": hooks["forced"][None]}
        return _tree_map(lambda t: t[None], noise), ext_finish[None], hooks

    def _unstack(self, out: StepOut) -> StepOut:
        return out if self.stacked else _frame_of(out, 0)

    def eager(self, params, carry: DecodeCarry, noise: FrameNoise, ext_finish: torch.Tensor,
              hooks: Optional[Dict] = None):
        """The window run eagerly, launch by launch, on any device."""
        noise, ext_finish, hooks = self._stack(noise, ext_finish, hooks)
        carry, out = self._window(params, carry, noise, ext_finish, hooks, self.frames)
        return carry, self._unstack(out)

    def __call__(self, params, carry: DecodeCarry, noise: FrameNoise, ext_finish: torch.Tensor,
                 hooks: Optional[Dict] = None):
        if carry.h_pos.device.type != "cuda":
            return self.eager(params, carry, noise, ext_finish, hooks)
        if self.tp_group is not None and dist.get_backend(self.tp_group) != "nccl":
            raise RuntimeError(
                f"a CUDA graph cannot capture the tensor-parallel all-reduces of a "
                f"{dist.get_backend(self.tp_group)!r} process group (only NCCL's); call the step "
                "function's eager windows (StepFn.eager) instead")
        with self._owner:
            return self._replay(params, carry, noise, ext_finish, hooks)

    def _replay(self, params, carry, noise, ext_finish, hooks):
        noise, ext_finish, hooks = self._stack(noise, ext_finish, hooks)
        key = (self, id(params), carry.h_pos.device, tuple(carry.h_pos.shape),
               carry.h_pos.dtype, carry.cache.max_len, carry.cache.k[0].dtype,
               None if hooks is None else tuple((k, tuple(v.shape)) for k, v in sorted(hooks.items())))
        with _captures_lock:
            cap = _captures.get(key)
            if cap is not None:
                _captures.move_to_end(key)
        if cap is None:
            cap = self._capture(params, carry, noise, ext_finish, hooks)
            with _captures_lock:
                _captures[key] = cap
                while len(_captures) > MAX_CAPTURES:
                    _captures.popitem(last=False)
        if carry is not cap.carry:
            _copy_into(cap.carry, carry)
        _copy_into((cap.noise, cap.ext_finish, cap.hooks), (noise, ext_finish, hooks))
        cap.graph.replay()
        _add_launches(cap.launches)
        self.replays += 1
        return cap.carry, self._unstack(cap.out)

    def _capture(self, params, carry, noise, ext_finish, hooks) -> _Capture:
        cap = _Capture(params, carry, noise, ext_finish, hooks)
        # one eager frame first, on the caller's stream, where the kernels'
        # shared workspaces are used in order: it builds the kernel library,
        # sizes those workspaces and counters, and lets cuDNN choose its
        # algorithms; what it writes into the static carry is overwritten
        # when the caller's carry is copied in
        first = None if cap.hooks is None else {**cap.hooks, "forced": cap.hooks["forced"][:1]}
        self._window(params, cap.carry, _tree_map(lambda t: t[:1], cap.noise),
                     cap.ext_finish[:1], first, 1)
        before = _read_launches()
        try:
            # thread_local: work that other threads enqueue meanwhile does
            # not invalidate the capture
            with torch.cuda.graph(cap.graph, capture_error_mode="thread_local"):
                new_carry, cap.out = self._window(params, cap.carry, cap.noise, cap.ext_finish,
                                                  cap.hooks, self.frames)
                _copy_into(cap.carry, new_carry)  # replays chain: the next reads this one's carry
        finally:
            delta = {k: n - before.get(k, 0) for k, n in _read_launches().items()}
            cap.launches = {k: n for k, n in delta.items() if n}
            _add_launches({k: -n for k, n in cap.launches.items()})  # a capture launches nothing
        return cap


def _trace_opts(opts: GenerateOptions) -> GenerateOptions:
    """Project opts onto the fields the step reads, so host-only knobs
    (max_length, max_length_times, prefill_chunk, frames_per_dispatch) do
    not split the step-function memo into separate captures. kv_int8 is
    left out too: the step reads the cache's dtype from the carry, and a
    capture is keyed on it."""
    return dataclasses.replace(
        GenerateOptions(),
        cfg_scale=opts.cfg_scale,
        ddpm_steps=opts.ddpm_steps,
        do_sample=opts.do_sample,
        temperature=opts.temperature,
        top_p=opts.top_p,
        refresh_negative=opts.refresh_negative,
        sde=opts.sde,
    )


def make_step_fn(cfg: VibeVoiceConfig, tokens: SpecialTokens, opts: GenerateOptions,
                 inject: bool = False, tp_group=None) -> StepFn:
    """The compiled one-frame step (``StepFn`` without the K axis), memoized
    on the options it reads (and the tensor-parallel group), so every
    generate() with these options shares its captures. ``inject`` is the JAX
    signature's: the step reads hooks whenever they are given, and captures
    are keyed on their shapes."""
    return _make_step_fn_cached(cfg, tokens, _trace_opts(opts), 1, False, tp_group)


def make_multi_step_fn(cfg: VibeVoiceConfig, tokens: SpecialTokens, opts: GenerateOptions,
                       frames_per_dispatch: int, inject: bool = False, tp_group=None) -> StepFn:
    """The compiled window of ``frames_per_dispatch`` frames, one graph
    replay a window on the card (``StepFn``); memoized as ``make_step_fn``."""
    return _make_step_fn_cached(cfg, tokens, _trace_opts(opts), frames_per_dispatch, True,
                                tp_group)


@functools.lru_cache(maxsize=16)
def _make_step_fn_cached(cfg, tokens, opts, frames, stacked, tp_group=None) -> StepFn:
    return StepFn(cfg, tokens, opts, frames, stacked, tp_group)


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; on the card through pinned memory, without
    waiting for the copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _fetch(out: StepOut) -> Callable[[], tuple]:
    """Start copying a window's outputs to the host now, before the next
    window's graph replay overwrites them; the returned call waits for the
    copies and gives (tokens, audio_mask, f32 audio, finished) as numpy."""
    out = (out.tokens, out.audio_mask, out.audio.float(), out.finished)
    if out[0].device.type != "cuda":
        return lambda: tuple(t.numpy() for t in out)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in out]
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return tuple(t.numpy().copy() for t in host)

    return wait


def prefill_request(cfg: VibeVoiceConfig, params, input_ids: np.ndarray, valid_mask: np.ndarray,
                    speech_tensors: Optional[np.ndarray], speech_frame_valid: Optional[np.ndarray],
                    speech_input_mask: Optional[np.ndarray], max_length: int,
                    tokens: SpecialTokens, opts: GenerateOptions, generator: torch.Generator, *,
                    speech_type: str = "audio",
                    noise_bank: Optional[Dict[str, np.ndarray]] = None,
                    tp_group=None) -> DecodeCarry:
    """The first DecodeCarry of a request given as host arrays, on the
    parameters' device: ``prefill_fn``, or ``chunked_prefill`` for prompts
    longer than opts.prefill_chunk, into ``max_length`` cache slots (int8
    per opts.kv_int8). The voice prompt's VAE noise is the first draw from
    ``generator`` (or noise_bank's "vae_std"/"vae_eps"). The host arrays go
    to the card through pinned memory without waiting for the stream, so a
    prefill beside a decoding engine does not wait for its windows."""
    dev = params["lm"]["embed"].device
    t0 = input_ids.shape[1]
    if max_length <= t0:
        raise ValueError(f"max_length={max_length} must exceed the prompt length ({t0} tokens)")
    as_dev = lambda a, dt: _to_device(np.asarray(a), dev).to(dt)
    speech_args = None
    if speech_tensors is not None:
        if speech_type == "audio":
            hop = cfg.acoustic_tokenizer_config.hop_length
            expected = -(-speech_tensors.shape[1] // hop)
            if speech_frame_valid.shape[1] != expected:
                raise ValueError(f"speech_frame_valid has {speech_frame_valid.shape[1]} frames but "
                                 f"the acoustic tokenizer (hop {hop}) produces {expected}")
        vae_noise = None
        if noise_bank is not None and "vae_eps" in noise_bank:
            vae_noise = (as_dev(noise_bank["vae_std"], torch.float32),
                         as_dev(noise_bank["vae_eps"], torch.float32))
        speech_args = (as_dev(speech_tensors, torch.float32), as_dev(speech_frame_valid, torch.bool),
                       as_dev(speech_input_mask, torch.bool), generator, vae_noise)
    ids = as_dev(input_ids, torch.long)
    vmask = as_dev(valid_mask, torch.bool)
    if t0 > opts.prefill_chunk:
        return chunked_prefill(cfg, params, ids, vmask, max_length, tokens, speech_args,
                               chunk=opts.prefill_chunk, speech_type=speech_type,
                               kv_int8=bool(opts.kv_int8), tp_group=tp_group)
    return prefill_fn(cfg, params, ids, max_length, vmask, speech_args, tokens, speech_type,
                      bool(opts.kv_int8), tp_group)


def generate(
    cfg: VibeVoiceConfig,
    params,
    *,
    input_ids: np.ndarray,
    valid_mask: Optional[np.ndarray] = None,
    speech_tensors: Optional[np.ndarray] = None,
    speech_frame_valid: Optional[np.ndarray] = None,
    speech_input_mask: Optional[np.ndarray] = None,
    tokens: SpecialTokens = SpecialTokens(),
    opts: GenerateOptions = GenerateOptions(),
    speech_type: str = "audio",
    seed: int = 0,
    audio_streamer=None,
    stop_check_fn: Optional[Callable[[], bool]] = None,
    show_progress_bar: bool = False,
    step_fn: Optional[Callable] = None,
    noise_bank: Optional[Dict[str, np.ndarray]] = None,
    forced_tokens: Optional[np.ndarray] = None,
    tp_group=None,
) -> GenerationOutput:
    """Prefill once, then one compiled step a window of
    ``opts.frames_per_dispatch`` frames on the parameters' device.

    input_ids must be RIGHT-padded; ``valid_mask`` marks real tokens.
    ``step_fn`` defaults to ``make_multi_step_fn`` (K > 1) or
    ``make_step_fn`` (K = 1) for these options, which replays a CUDA graph
    on the card; a step function's ``eager`` runs the same frames launch by
    launch. The step function's captures hold one request's carry, so
    calls that share one (the same options and shapes, from any thread)
    decode one after another. Injection hooks (replaying another implementation's draws):
      noise_bank: {"init": (E, B, D), "sde": (E, S, B, D) [sde only],
                   "vae_std": (N,), "vae_eps": (N, F, D) [voice prompt only]}
      forced_tokens: (T, B) int token script; -1 falls through to the model.
    ``tp_group``: ``params`` are this rank's tensor-parallel shards; every
    rank of the group calls generate() with the same arguments (a gloo
    group needs ``step_fn`` = a step function's ``eager``).
    """
    dev = params["lm"]["embed"].device
    b, t0 = input_ids.shape
    if valid_mask is None:
        valid_mask = np.ones((b, t0), bool)
    lengths = valid_mask.sum(axis=1).astype(np.int64)
    max_length = opts.max_length or cfg.decoder_config.max_position_embeddings
    opts = resolve_kv_int8(opts, max_length)
    max_steps = int(min(max_length - t0, opts.max_length_times * t0))
    max_step_per_sample = np.minimum(max_length - lengths,
                                     (opts.max_length_times * lengths).astype(np.int64))
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    as_dev = lambda a, dt=None: torch.as_tensor(np.asarray(a), device=dev, dtype=dt)
    carry = prefill_request(cfg, params, input_ids, valid_mask, speech_tensors, speech_frame_valid,
                            speech_input_mask, max_length, tokens, opts, generator,
                            speech_type=speech_type, noise_bank=noise_bank, tp_group=tp_group)

    inject = noise_bank is not None or forced_tokens is not None
    k_frames = max(1, opts.frames_per_dispatch)
    if step_fn is None:
        step_fn = (make_multi_step_fn(cfg, tokens, opts, k_frames, inject, tp_group) if k_frames > 1
                   else make_step_fn(cfg, tokens, opts, inject, tp_group))
    hooks_base = None
    if inject:
        bank = noise_bank or {}
        init = bank.get("init")
        if init is None:  # forced tokens only: one fixed initial draw per sample
            init_t = torch.randn(1, b, cfg.acoustic_vae_dim, generator=generator, device=dev)
        else:
            init_t = as_dev(init, torch.float32)
        hooks_base = {"init": init_t}
        if opts.sde:
            if "sde" not in bank:
                raise ValueError("injection with opts.sde requires noise_bank['sde']")
            hooks_base["sde"] = as_dev(bank["sde"], torch.float32)
    noise = _empty_noise(cfg, opts, b, k_frames, inject, dev)  # redrawn in place each window

    sequences = [np.asarray(input_ids)]
    audio_chunks: List[List[np.ndarray]] = [[] for _ in range(b)]
    reach_max = np.zeros(b, bool)
    finished_host = np.zeros(b, bool)

    def run_window(carry, step0):
        """Enqueue K frames and the copy of their outputs to the host;
        returns (carry, the copy's wait, ext_cap, n_live)."""
        steps_now = np.arange(step0, step0 + k_frames)
        # per-sample cap (drives reach_max) plus the global bound: frames
        # past max_steps are masked for every sample, so outputs are
        # identical for any K
        ext_cap = steps_now[:, None] >= max_step_per_sample[None, :]
        ext_finish = _to_device(ext_cap | (steps_now >= max_steps)[:, None], dev)
        hooks = None
        if inject:
            forced = np.full((k_frames, b), -1, np.int64)
            if forced_tokens is not None:
                avail = forced_tokens[step0: step0 + k_frames]
                forced[: len(avail)] = avail
            hooks = {**hooks_base, "forced": _to_device(forced, dev)}
        _fill_noise(noise, generator)
        if k_frames == 1:
            hooks = None if hooks is None else {**hooks, "forced": hooks["forced"][0]}
            carry, out = step_fn(params, carry, _frame_of(noise, 0), ext_finish[0], hooks)
            out = _tree_map(lambda t: t[None], out)
        else:
            carry, out = step_fn(params, carry, noise, ext_finish, hooks)
        return carry, _fetch(out), ext_cap, max(0, min(k_frames, max_steps - step0))

    def process_window(fetched, ext_cap, n_live):
        """Read one window back (one synchronisation) and deliver it."""
        nonlocal reach_max, finished_host
        toks, amask, audio, fin = fetched()
        for f in range(n_live):
            sequences.append(toks[f][:, None])
            if amask[f].any():
                for i in np.nonzero(amask[f])[0]:
                    audio_chunks[i].append(audio[f, i, :, 0])
                if audio_streamer is not None:
                    audio_streamer.put(audio[f, amask[f], :, 0], np.nonzero(amask[f])[0])
            newly_done = fin[f] & ~finished_host
            if newly_done.any():
                # EOS wins the tie on a sample's cap frame
                reach_max |= ext_cap[f] & newly_done & (toks[f] != tokens.eos)
                if audio_streamer is not None:
                    audio_streamer.end(np.nonzero(newly_done)[0])
            finished_host = fin[f]
            if finished_host.all():
                break

    windows = range(0, max_steps, k_frames)
    if show_progress_bar:
        try:
            from tqdm import tqdm

            windows = tqdm(windows, desc="Generating", leave=False)
        except ImportError:
            pass

    # One request at a time owns a step function's captures: another
    # thread's generate() with the same step function waits here.
    owner = step_fn.request() if isinstance(step_fn, StepFn) else contextlib.nullcontext()
    with owner:
        # One window kept in flight: window N+1 is enqueued before window N is
        # read back, so the device works while the host delivers. Window N's
        # outputs are copied to the host before N+1 is enqueued.
        inflight = None
        for step0 in windows:
            if stop_check_fn is not None and stop_check_fn():
                if inflight is not None:
                    process_window(*inflight)
                    inflight = None
                if audio_streamer is not None:
                    audio_streamer.end()
                break
            if audio_streamer is not None and any(getattr(audio_streamer, "finished_flags", None)
                                                  or []):
                if inflight is not None:
                    process_window(*inflight)
                    inflight = None
                break
            carry, fetched, ext_cap, n_live = run_window(carry, step0)
            prev, inflight = inflight, (fetched, ext_cap, n_live)
            if prev is not None:
                process_window(*prev)
            if finished_host.all():
                inflight = None  # the window just enqueued runs fully masked
                break
        if inflight is not None:
            process_window(*inflight)
    if audio_streamer is not None:
        audio_streamer.end()

    return GenerationOutput(
        sequences=np.concatenate(sequences, axis=1),
        speech_outputs=[np.concatenate(c) if c else None for c in audio_chunks],
        reach_max_step_sample=reach_max,
    )
