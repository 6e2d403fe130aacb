"""σ-VAE acoustic / semantic tokenizers in channels-last (B, T, C) layout
(port of vibevoice_tpu/models/tokenizer.py).

  encoder: stem conv(k=7) -> [downsample conv(k=2r, s=r) + Block1D stack] x N
           -> head conv(k=7) -> vae_dim (decoder mirrors it with transposed convs)
  Block1D: RMSNorm -> depthwise conv(k=7) -> layer scale -> residual;
           RMSNorm -> 4x GELU MLP -> layer scale -> residual

Batch mode encodes/decodes whole utterances (voice prompts). Streaming mode
threads a dict of fixed-shape conv context buffers; after ``fuse_hot_stages``
the T=1 stacks (acoustic decoder stage 0, semantic encoder last stage) run as
kernel D (ops/vocoder_fused.fused_stage_step).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import (
    causal_conv1d,
    causal_conv1d_streaming,
    conv_context_size,
    conv_transpose1d,
    conv_transpose1d_streaming,
    conv_transpose_context_size,
)
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant import mm
from ..ops.vocoder_fused import fused_stage_step, pack_stage

Params = Dict
State = Dict

BLOCK_KERNEL = 7
STEM_KERNEL = 7
HEAD_KERNEL = 7


def encoder_spec(cfg) -> dict:
    """Encoder structure; the encoder uses reversed ratios."""
    depths = tuple(cfg.encoder_depths)
    nf = cfg.encoder_n_filters
    return dict(depths=depths, ratios=tuple(reversed(cfg.encoder_ratios)),
                dims=tuple(nf * (2 ** i) for i in range(len(depths))),
                in_channels=cfg.channels, out_dim=cfg.vae_dim)


def decoder_spec(cfg) -> dict:
    depths = tuple(cfg.resolved_decoder_depths)
    n = len(depths)
    nf = cfg.decoder_n_filters
    return dict(depths=depths, ratios=tuple(cfg.resolved_decoder_ratios),
                dims=tuple(nf * (2 ** (n - 1 - i)) for i in range(n)),
                in_channels=cfg.vae_dim, out_dim=cfg.channels)


def init_encoder_state(cfg, batch: int, dtype=torch.float32, device=None) -> State:
    spec = encoder_spec(cfg)
    depths, ratios, dims = spec["depths"], spec["ratios"], spec["dims"]
    z = lambda ctx, c: torch.zeros(batch, ctx, c, dtype=dtype, device=device)
    st: State = {"down0": z(conv_context_size(STEM_KERNEL), spec["in_channels"])}
    for i in range(len(depths) - 1):
        st[f"down{i + 1}"] = z(conv_context_size(ratios[i] * 2, ratios[i]), dims[i])
    for i, depth in enumerate(depths):
        for j in range(depth):
            st[f"s{i}_{j}"] = z(conv_context_size(BLOCK_KERNEL), dims[i])
    st["head"] = z(conv_context_size(HEAD_KERNEL), dims[-1])
    return st


def init_decoder_state(cfg, batch: int, dtype=torch.float32, device=None) -> State:
    spec = decoder_spec(cfg)
    depths, ratios, dims = spec["depths"], spec["ratios"], spec["dims"]
    z = lambda ctx, c: torch.zeros(batch, ctx, c, dtype=dtype, device=device)
    st: State = {"up0": z(conv_context_size(STEM_KERNEL), spec["in_channels"])}
    for i in range(len(depths) - 1):
        st[f"up{i + 1}"] = z(conv_transpose_context_size(ratios[i] * 2), dims[i])
    for i, depth in enumerate(depths):
        for j in range(depth):
            st[f"s{i}_{j}"] = z(conv_context_size(BLOCK_KERNEL), dims[i])
    st["head"] = z(conv_context_size(HEAD_KERNEL), dims[-1])
    return st


def fuse_hot_stages(tok_params: Params, cfg, quantize: bool = True) -> Params:
    """Pack the T=1 streaming stacks for kernel D: stage 0 of a {'decoder'}
    entry, the last stage of an {'encoder'} entry. The packed stage's dense
    blocks are dropped, so that stage then runs in streaming mode only."""

    def packable(blocks) -> bool:
        if not blocks or "w" not in blocks[0]["norm"]:
            return False
        b0 = blocks[0]
        if any(k not in b0 for k in ("gamma", "ffn_gamma", "ffn_norm")):
            return False
        if "w" not in b0["ffn"]["fc1"] or "b" not in b0["ffn"]["fc1"]:
            return False
        if "b" not in b0["mixer"] or "b" not in b0["ffn"]["fc2"]:
            return False
        return b0["mixer"]["w"].shape[1] == 1  # depthwise mixer

    out = dict(tok_params)
    for part, pos, key in (("decoder", 0, "stage0_packed"), ("encoder", -1, "stageN_packed")):
        if part in tok_params and packable(tok_params[part]["stages"][pos]):
            sub = dict(tok_params[part])
            stages = list(sub["stages"])
            sub[key] = pack_stage(stages[pos], cfg.layernorm_eps, quantize)
            stages[pos] = []
            sub["stages"] = stages
            out[part] = sub
    return out


def reset_state(state: State, sample_mask: torch.Tensor) -> State:
    """Zero the context buffers of samples where ``sample_mask`` is True."""
    m = sample_mask.reshape(-1, 1, 1)
    return {k: torch.where(m, torch.zeros_like(v), v) for k, v in state.items()}


def _norm_apply(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.layernorm == "RMSNorm":
        return rms_norm(x, p.get("w"), cfg.layernorm_eps)
    return layer_norm(x, p.get("w"), p.get("b"), cfg.layernorm_eps)


def _block_apply(p: Params, x: torch.Tensor, cfg, state: Optional[torch.Tensor]):
    """Block1D forward. Returns (x, new_conv_state)."""
    groups = x.shape[-1] // p["mixer"]["w"].shape[1]
    res = x
    h = _norm_apply(p["norm"], x, cfg)
    if state is None:
        h = causal_conv1d(h, p["mixer"]["w"], p["mixer"].get("b"), groups=groups,
                          pad_mode=cfg.pad_mode)
        new_state = None
    else:
        h, new_state = causal_conv1d_streaming(h, state, p["mixer"]["w"], p["mixer"].get("b"),
                                               groups=groups)
    if "gamma" in p:
        h = h * p["gamma"].to(h.dtype)
    x = res + h
    res = x
    h = _norm_apply(p["ffn_norm"], x, cfg)
    h = mm(F.gelu(mm(h, p["ffn"]["fc1"]), approximate="none"), p["ffn"]["fc2"])
    if "ffn_gamma" in p:
        h = h * p["ffn_gamma"].to(h.dtype)
    return res + h, new_state


def _stage(params: Params, packed, x, state: Optional[State], new_state: State, i: int,
           depth: int, cfg):
    """Stage i's Block1D stack; a packed stack runs as kernel D on T=1 frames."""
    if packed is not None and state is not None and x.shape[1] == 1:
        states = torch.stack([state[f"s{i}_{j}"] for j in range(depth)])
        x, new = fused_stage_step(packed, x, states)
        for j in range(depth):
            new_state[f"s{i}_{j}"] = new[j]
        return x
    if packed is not None:
        raise ValueError(f"stage {i} is packed for T=1 streaming frames; batch mode and "
                         "multi-frame windows need the unfused parameters")
    for j in range(depth):
        x, bs = _block_apply(params["stages"][i][j], x, cfg,
                             None if state is None else state[f"s{i}_{j}"])
        if state is not None:
            new_state[f"s{i}_{j}"] = bs
    return x


def _head(params: Params, x, state: Optional[State], new_state: State, cfg):
    if "final_norm" in params:
        x = _norm_apply(params["final_norm"], x, cfg)
    hp = params["head"]
    if state is None:
        return causal_conv1d(x, hp["w"], hp.get("b"), pad_mode=cfg.pad_mode), None
    x, new_state["head"] = causal_conv1d_streaming(x, state["head"], hp["w"], hp.get("b"))
    return x, new_state


def encoder_apply(cfg, params: Params, x: torch.Tensor,
                  state: Optional[State] = None) -> Tuple[torch.Tensor, Optional[State]]:
    """Audio (B, T, channels) -> latents (B, T // hop, vae_dim); streaming
    when ``state`` is given (returns the new state)."""
    spec = encoder_spec(cfg)
    depths, ratios = spec["depths"], spec["ratios"]
    n = len(depths)
    new_state: State = {}
    for i in range(n):
        dp = params["down"][i]
        k, s = (STEM_KERNEL, 1) if i == 0 else (ratios[i - 1] * 2, ratios[i - 1])
        if state is None:
            x = causal_conv1d(x, dp["w"], dp.get("b"), stride=s, pad_mode=cfg.pad_mode)
        else:
            x, new_state[f"down{i}"] = causal_conv1d_streaming(x, state[f"down{i}"], dp["w"],
                                                               dp.get("b"), stride=s)
        packed = params.get("stageN_packed") if i == n - 1 else None
        x = _stage(params, packed, x, state, new_state, i, depths[i], cfg)
    return _head(params, x, state, new_state, cfg)


def decoder_apply(cfg, params: Params, x: torch.Tensor,
                  state: Optional[State] = None) -> Tuple[torch.Tensor, Optional[State]]:
    """Latents (B, T, vae_dim) -> audio (B, T * hop, channels)."""
    spec = decoder_spec(cfg)
    depths, ratios = spec["depths"], spec["ratios"]
    new_state: State = {}
    for i in range(len(depths)):
        up = params["up"][i]
        if i == 0:
            if state is None:
                x = causal_conv1d(x, up["w"], up.get("b"), pad_mode=cfg.pad_mode)
            else:
                x, new_state["up0"] = causal_conv1d_streaming(x, state["up0"], up["w"],
                                                              up.get("b"))
        elif state is None:
            x = conv_transpose1d(x, up["w"], up.get("b"), stride=ratios[i - 1], causal=cfg.causal)
        else:
            x, new_state[f"up{i}"] = conv_transpose1d_streaming(
                x, state[f"up{i}"], up["w"], up.get("b"), stride=ratios[i - 1])
        packed = params.get("stage0_packed") if i == 0 else None
        x = _stage(params, packed, x, state, new_state, i, depths[i], cfg)
    return _head(params, x, state, new_state, cfg)


def encode(cfg, params: Params, audio: torch.Tensor, state: Optional[State] = None):
    """(mean latents (B, T', D), new_state); audio is (B, T, channels)."""
    return encoder_apply(cfg, params["encoder"], audio, state)


def decode(cfg, params: Params, latents: torch.Tensor, state: Optional[State] = None):
    """(audio (B, T*hop, channels), new_state)."""
    return decoder_apply(cfg, params["decoder"], latents, state)


def sample_latents(mean: torch.Tensor, fix_std: float, dist_type: str,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample the σ-VAE posterior with draws from ``generator``."""
    if dist_type == "none":
        return mean
    std_eps = torch.randn(mean.shape[0], generator=generator, device=mean.device)
    eps = torch.randn(mean.shape, generator=generator, device=mean.device)
    return sample_latents_from_noise(mean, fix_std, dist_type, std_eps, eps)


def sample_latents_from_noise(mean: torch.Tensor, fix_std: float, dist_type: str,
                              std_eps: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """'fix': mean + fix_std * eps; 'gaussian': a per-sample std drawn as
    std_eps * (fix_std / 0.8); 'none': mean."""
    if dist_type == "none":
        return mean
    if dist_type == "fix":
        return mean + fix_std * eps.to(mean.dtype)
    if dist_type == "gaussian":
        std = std_eps.reshape((mean.shape[0],) + (1,) * (mean.ndim - 1)).to(mean.dtype) * (
            fix_std / 0.8)
        return mean + std * eps.to(mean.dtype)
    raise ValueError(f"unknown dist_type {dist_type}")


def kl_loss(mean: torch.Tensor) -> torch.Tensor:
    """Per-element "KL" of the σ-VAE posterior: the reference takes the
    plain square of the mean (its encoder output's ``kl``)."""
    return mean.square()
