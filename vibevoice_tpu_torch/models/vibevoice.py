"""Composite VibeVoice model: Qwen2 LM + σ-VAE tokenizers + connectors +
diffusion head (port of vibevoice_tpu/models/vibevoice.py).

Parameters are one nested dict of tensors with the JAX pytree's keys
(utils/params.py builds it):

  {"lm", "acoustic_tokenizer", "semantic_tokenizer", "acoustic_connector",
   "semantic_connector", "diffusion_head", "speech_scaling_factor",
   "speech_bias_factor", optional "lm_head" (untied) / "lm_head_q" (int8)}
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from ..configs import VibeVoiceConfig

from ..ops import quant
from ..ops.norms import rms_norm
from . import diffusion_head as dh
from . import tokenizer as tok

Params = Dict

CONNECTOR_NORM_EPS = 1e-6


def connector_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """fc1 -> RMSNorm -> fc2."""
    h = torch.matmul(x, p["fc1"]["w"].to(x.dtype)) + p["fc1"]["b"].to(x.dtype)
    h = rms_norm(h, p["norm"]["w"], CONNECTOR_NORM_EPS)
    return torch.matmul(h, p["fc2"]["w"].to(h.dtype)) + p["fc2"]["b"].to(h.dtype)


def _head_q(params: Params):
    return params["lm"].get("lm_head_q") or params.get("lm_head_q")


def lm_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Full-vocab logits (top-p sampling and the training CE); an int8 head
    runs through kernel A, and kernel E carries the CE gradient into the
    hidden states."""
    head_q = _head_q(params)
    if head_q is not None:
        return quant.mm(hidden, head_q)
    w = params.get("lm_head")
    if w is None:
        w = params["lm"]["embed"]
    return torch.matmul(hidden, w.T.to(hidden.dtype))


def lm_logits_cand(params: Params, hidden: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Logits of the candidate token columns only: gathers C int8 columns
    (scales are per column, so slicing commutes with dequantization)."""
    head_q = _head_q(params)
    if head_q is not None:
        w = head_q["w8"][:, cand].float()
        return torch.matmul(hidden.float(), w) * head_q["scale"][cand].float()
    w = params.get("lm_head")
    if w is None:
        w = params["lm"]["embed"]
    return torch.matmul(hidden, w[cand, :].T.to(hidden.dtype))


def quantize_for_inference(params: Params,
                           components: Tuple[str, ...] = ("lm", "lm_head")) -> Params:
    """Weight-only per-column int8 for serving: the LM linears ("lm"), the
    logits projection ("lm_head"), the diffusion head's AdaLN and FFN
    linears ("diffusion_head") and the tokenizers' ConvNeXt FFNs
    ("tokenizers"); the last two only where both dims are multiples of 512
    (ops/quant._quant_entry). Every int8 linear runs through kernel A."""
    unknown = set(components) - {"lm", "lm_head", "diffusion_head", "tokenizers"}
    if unknown:
        raise ValueError(f"unknown quantize_for_inference components {sorted(unknown)}")
    out = dict(params)
    if "lm" in components:
        out["lm"] = quant.quantize_lm(params["lm"])
    if "lm_head" in components:
        head_w = params.get("lm_head")
        if head_w is None:
            head_w = params["lm"]["embed"]
        else:
            out.pop("lm_head", None)
        out["lm_head_q"] = quant.quantize_weight(head_w.T)
    if "diffusion_head" in components:
        out["diffusion_head"] = quant.quantize_diffusion_head(params["diffusion_head"])
    if "tokenizers" in components:
        out["acoustic_tokenizer"] = quant.quantize_tokenizer(params["acoustic_tokenizer"])
        if "semantic_tokenizer" in params:
            out["semantic_tokenizer"] = quant.quantize_tokenizer(params["semantic_tokenizer"])
    return out


def fuse_vocoder(params: Params, cfg: VibeVoiceConfig, quantize: bool = True) -> Params:
    """Pack the per-frame stacks (acoustic decoder stage 0, semantic encoder
    last stage) for kernel D; quantize stores their FFN weights int8."""
    out = dict(params)
    ac = dict(params["acoustic_tokenizer"])
    ac.update(tok.fuse_hot_stages({"decoder": ac["decoder"]}, cfg.acoustic_tokenizer_config,
                                  quantize))
    out["acoustic_tokenizer"] = ac
    if "semantic_tokenizer" in params:
        se = dict(params["semantic_tokenizer"])
        se.update(tok.fuse_hot_stages({"encoder": se["encoder"]}, cfg.semantic_tokenizer_config,
                                      quantize))
        out["semantic_tokenizer"] = se
    return out


def fuse_for_serving(params: Params, cfg: VibeVoiceConfig, quantize: bool = True) -> Params:
    """All serving packs: fused vocoder stages (kernel D) and the fused
    diffusion-head FFN stack (kernel C). With ``LM_PACK=1`` in the
    environment and an int8 LM, each layer's q|k|v and gate|up are also
    packed into one int8 linear each (ops/quant.pack_lm_projections)."""
    out = fuse_vocoder(params, cfg, quantize)
    out["diffusion_head"] = dh.fuse_head(params["diffusion_head"], cfg.diffusion_head_config,
                                         quantize)
    layers = out["lm"]["layers"]
    if (quantize and os.environ.get("LM_PACK") == "1" and layers
            and "w8" in layers[0]["attn"].get("q", {})):
        out["lm"] = quant.pack_lm_projections(out["lm"])
    return out


def splice_speech_features(embeds: torch.Tensor, speech_input_mask: torch.Tensor,
                           features: torch.Tensor, feature_valid: torch.Tensor) -> torch.Tensor:
    """Overwrite embeddings at masked positions with the valid feature rows,
    both in flat row-major order. embeds (B, T, H), speech_input_mask (B, T),
    features (N, F, H), feature_valid (N, F)."""
    b, t, h = embeds.shape
    feat = features.reshape(-1, h)[feature_valid.reshape(-1)].to(embeds.dtype)
    mask = speech_input_mask.reshape(-1)
    m = features.shape[0] * features.shape[1]
    table = torch.zeros(m + 1, h, dtype=embeds.dtype, device=embeds.device)
    table[: feat.shape[0]] = feat
    slot_rank = (torch.cumsum(mask.to(torch.int64), 0) - 1).clamp(0, m - 1)
    out = torch.where(mask[:, None], table[slot_rank], embeds.reshape(-1, h))
    return out.reshape(b, t, h)


def encode_voice_features(
    cfg: VibeVoiceConfig,
    params: Params,
    speech_tensors: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    speech_type: str = "audio",
    vae_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Voice prompt -> connector features (N, F, H): acoustic encode (or a
    precomputed latent mean for speech_type="pt"), σ-VAE sample (from
    ``vae_noise`` = (std_eps (N,), eps (N, F, D)) when given, else from
    ``generator``, else the mean), scale and bias, connector."""
    acfg = cfg.acoustic_tokenizer_config
    dtype = params["acoustic_connector"]["fc1"]["w"].dtype
    speech_tensors = speech_tensors.to(dtype)
    if speech_type == "pt":
        mean = speech_tensors
    elif speech_type == "audio":
        mean, _ = tok.encode(acfg, params["acoustic_tokenizer"], speech_tensors[..., None])
    else:
        raise NotImplementedError(f"speech_type {speech_type}")
    if vae_noise is not None:
        latents = tok.sample_latents_from_noise(mean, acfg.fix_std, acfg.std_dist_type,
                                                vae_noise[0], vae_noise[1])
    elif generator is not None:
        latents = tok.sample_latents(mean, acfg.fix_std, acfg.std_dist_type, generator)
    else:
        latents = mean
    # the factors are f32 scalars: the sum and product are f32, as in JAX
    scaled = (latents.float() + params["speech_bias_factor"]) * params["speech_scaling_factor"]
    return connector_apply(params["acoustic_connector"], scaled.to(mean.dtype))
