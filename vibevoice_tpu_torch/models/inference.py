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
every K. Randomness comes from a ``torch.Generator`` seeded with ``seed``,
or from the injection hooks (``noise_bank``, ``forced_tokens``) that tests
use to replay another implementation's draws.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..configs import VibeVoiceConfig

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


def _init_streams(cfg, params, b, max_len, tokens, kv_int8):
    """Empty positive cache, prefilled negative stream (a 1-token
    <speech_start> prompt) and zero conv states."""
    lm_cfg = cfg.decoder_config
    embed = params["lm"]["embed"]
    dtype, dev = embed.dtype, embed.device
    pos_cache = qwen2.make_cache(lm_cfg, b, max_len, dtype, quantized=kv_int8, device=dev)
    neg_ids = torch.full((b, 1), tokens.speech_start, dtype=torch.long, device=dev)
    neg_cache = qwen2.make_cache(lm_cfg, b, max_len, dtype, quantized=kv_int8, device=dev)
    h_neg, neg_cache = qwen2.forward(lm_cfg, params["lm"], qwen2.embed_tokens(params["lm"], neg_ids),
                                     cache=neg_cache)
    dec_state = tok.init_decoder_state(cfg.acoustic_tokenizer_config, b, dtype, dev)
    sem_state = tok.init_encoder_state(cfg.semantic_tokenizer_config, b, dtype, dev)
    return pos_cache, neg_cache, h_neg[:, 0], dec_state, sem_state


def prefill_fn(cfg: VibeVoiceConfig, params, ids: torch.Tensor, max_len: int,
               valid_mask: torch.Tensor, speech_args, tokens: SpecialTokens,
               speech_type: str = "audio", kv_int8: bool = False) -> DecodeCarry:
    """Whole-prompt prefill of both streams; returns the first DecodeCarry."""
    b = ids.shape[0]
    embeds = _prompt_embeds(cfg, params, ids, speech_args, speech_type)
    pos_cache, neg_cache, h_neg, dec_state, sem_state = _init_streams(
        cfg, params, b, max_len, tokens, kv_int8)
    h, pos_cache = qwen2.forward(cfg.decoder_config, params["lm"], embeds, valid_mask=valid_mask,
                                 cache=pos_cache)
    last = (valid_mask.to(torch.int64).sum(1) - 1).clamp_min(0)
    h_pos = h[torch.arange(b, device=h.device), last]
    return DecodeCarry(_combine_caches(pos_cache, neg_cache), dec_state, sem_state, h_pos, h_neg,
                       torch.zeros(b, dtype=torch.bool, device=h.device),
                       torch.zeros(b, dtype=torch.int64, device=h.device))


def chunked_prefill(cfg: VibeVoiceConfig, params, ids: torch.Tensor, valid_mask: torch.Tensor,
                    max_len: int, tokens: SpecialTokens, speech_args=None, chunk: int = 1024,
                    speech_type: str = "audio", kv_int8: bool = False) -> DecodeCarry:
    """Long-prompt prefill in fixed-size chunks (bounds attention memory at
    O(chunk x S)); voice features are spliced into the whole prompt once."""
    b, t = ids.shape
    embeds = _prompt_embeds(cfg, params, ids, speech_args, speech_type)
    lengths = valid_mask.to(torch.int64).sum(1)
    pos_cache, neg_cache, h_neg, dec_state, sem_state = _init_streams(
        cfg, params, b, max_len, tokens, kv_int8)
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
                                     cache=pos_cache)
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


def _choose_tokens(params, carry: DecodeCarry, tokens: SpecialTokens, opts: GenerateOptions,
                   cand: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Constrained token choice over the candidate set; top-p needs the
    full-vocab distribution, every other mode reads the candidate columns."""
    need_full_vocab = opts.do_sample and opts.top_p < 1.0
    if need_full_vocab:
        logits = vv.lm_logits(params, carry.h_pos).float()
        cand_logits = logits[:, cand]
    else:
        cand_logits = vv.lm_logits_cand(params, carry.h_pos, cand).float()
    if not opts.do_sample:
        return cand[cand_logits.argmax(-1)]
    rows = torch.arange(cand_logits.shape[0], device=cand.device)
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
    cand_keep[rows, cand_scaled.argmax(-1)] = True
    probs = torch.softmax(cand_scaled.masked_fill(~cand_keep, float("-inf")), -1)
    return cand[torch.multinomial(probs, 1, generator=generator)[:, 0]]


def step(cfg: VibeVoiceConfig, params, carry: DecodeCarry, ext_finish: torch.Tensor, *,
         tokens: SpecialTokens, opts: GenerateOptions, coeffs: dpm.SolverCoeffs,
         generator: torch.Generator, hooks: Optional[Dict] = None):
    """One fused frame. ``hooks`` (injection) holds "forced" (B,) tokens or
    -1, "init" (E, B, D) per-event initial latents and, for SDE, "sde"
    (E, S, B, D), indexed by the per-sample diffusion-event count."""
    lm_cfg = cfg.decoder_config
    hcfg = cfg.diffusion_head_config
    b = carry.h_pos.shape[0]
    dev = carry.h_pos.device
    cand = torch.tensor(tokens.candidates, dtype=torch.long, device=dev)

    # 1. constrained token choice
    next_tok = _choose_tokens(params, carry, tokens, opts, cand, generator)
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
    timesteps = torch.from_numpy(coeffs.timesteps).to(dev)
    mods = dh.precompute_mods(head, hcfg, timesteps, torch.cat([carry.h_pos, carry.h_neg]))
    extras = [dh.step_mods(mods, i) for i in range(coeffs.num_steps)]
    sde_noise = None
    if hooks is not None:
        rows = torch.arange(b, device=dev)
        e = carry.n_diff.clamp(0, hooks["init"].shape[0] - 1)
        x_init = hooks["init"][e, rows].float()
        if opts.sde:
            sde_noise = hooks["sde"][e, :, rows].transpose(0, 1).float()  # (S, B, D)
    else:
        x_init = torch.randn(b, cfg.acoustic_vae_dim, generator=generator, device=dev)
    latent = dpm.cfg_sample(
        coeffs, lambda x, t, e: dh.apply_with_mods(head, hcfg, x, e), carry.h_pos, carry.h_neg,
        opts.cfg_scale, x_init, generator=generator, noise=sde_noise, extras=extras,
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
    h_both, cache = qwen2.forward(lm_cfg, params["lm"], both, cache=cache, advance=advance)

    new_carry = DecodeCarry(cache, dec_state, sem_state, h_both[:b, 0], h_both[b:, 0], finished,
                            carry.n_diff + diff_mask.to(torch.int64))
    return new_carry, StepOut(next_tok, audio, diff_mask, finished)


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


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
    noise_bank: Optional[Dict[str, np.ndarray]] = None,
    forced_tokens: Optional[np.ndarray] = None,
) -> GenerationOutput:
    """Prefill once, then one step per frame on the parameters' device.

    input_ids must be RIGHT-padded; ``valid_mask`` marks real tokens.
    Injection hooks (replaying another implementation's draws):
      noise_bank: {"init": (E, B, D), "sde": (E, S, B, D) [sde only],
                   "vae_std": (N,), "vae_eps": (N, F, D) [voice prompt only]}
      forced_tokens: (T, B) int token script; -1 falls through to the model.
    """
    dev = params["lm"]["embed"].device
    b, t0 = input_ids.shape
    if valid_mask is None:
        valid_mask = np.ones((b, t0), bool)
    lengths = valid_mask.sum(axis=1).astype(np.int64)
    max_length = opts.max_length or cfg.decoder_config.max_position_embeddings
    if max_length <= t0:
        raise ValueError(f"max_length={max_length} must exceed the prompt length ({t0} tokens)")
    opts = resolve_kv_int8(opts, max_length)
    max_steps = int(min(max_length - t0, opts.max_length_times * t0))
    max_step_per_sample = np.minimum(max_length - lengths,
                                     (opts.max_length_times * lengths).astype(np.int64))
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    as_dev = lambda a, dt=None: torch.as_tensor(np.asarray(a), device=dev, dtype=dt)

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
        carry = chunked_prefill(cfg, params, ids, vmask, max_length, tokens, speech_args,
                                chunk=opts.prefill_chunk, speech_type=speech_type,
                                kv_int8=opts.kv_int8)
    else:
        carry = prefill_fn(cfg, params, ids, max_length, vmask, speech_args, tokens, speech_type,
                           opts.kv_int8)

    coeffs = make_solver(cfg, opts)
    inject = noise_bank is not None or forced_tokens is not None
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

    k_frames = max(1, opts.frames_per_dispatch)
    sequences = [np.asarray(input_ids)]
    audio_chunks: List[List[np.ndarray]] = [[] for _ in range(b)]
    reach_max = np.zeros(b, bool)
    finished_host = np.zeros(b, bool)

    def run_window(carry, step0):
        """Enqueue K frames; returns (carry, stacked outputs, ext_cap, n_live)."""
        steps_now = np.arange(step0, step0 + k_frames)
        # per-sample cap (drives reach_max) plus the global bound: frames
        # past max_steps are masked for every sample, so outputs are
        # identical for any K
        ext_cap = steps_now[:, None] >= max_step_per_sample[None, :]
        ext_finish = as_dev(ext_cap | (steps_now >= max_steps)[:, None])
        forced = np.full((k_frames, b), -1, np.int64)
        if forced_tokens is not None:
            avail = forced_tokens[step0: step0 + k_frames]
            forced[: len(avail)] = avail
        forced = as_dev(forced)
        outs = []
        for f in range(k_frames):
            hooks = {**hooks_base, "forced": forced[f]} if inject else None
            carry, out = step(cfg, params, carry, ext_finish[f], tokens=tokens, opts=opts,
                              coeffs=coeffs, generator=generator, hooks=hooks)
            outs.append(out)
        stacked = StepOut(*(torch.stack(x) for x in zip(*outs)))
        return carry, stacked, ext_cap, max(0, min(k_frames, max_steps - step0))

    def process_window(out: StepOut, ext_cap, n_live):
        """Read one window back (one synchronisation) and deliver it."""
        nonlocal reach_max, finished_host
        toks = out.tokens.cpu().numpy()
        amask = out.audio_mask.cpu().numpy()
        audio = out.audio.float().cpu().numpy()
        fin = out.finished.cpu().numpy()
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

    # One window kept in flight: window N+1 is enqueued before window N is
    # read back, so the device works while the host delivers.
    inflight = None
    for step0 in range(0, max_steps, k_frames):
        if stop_check_fn is not None and stop_check_fn():
            if inflight is not None:
                process_window(*inflight)
                inflight = None
            if audio_streamer is not None:
                audio_streamer.end()
            break
        if audio_streamer is not None and any(getattr(audio_streamer, "finished_flags", None) or []):
            if inflight is not None:
                process_window(*inflight)
                inflight = None
            break
        carry, out, ext_cap, n_live = run_window(carry, step0)
        prev, inflight = inflight, (out, ext_cap, n_live)
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
