"""Per-token diffusion head, AdaLN-zero MLP stack
(port of vibevoice_tpu/models/diffusion_head.py).

  x = noisy_proj(latent); c = cond_proj(cond) + t_embed(t)
  repeat head_layers: x += gate * SwiGLU(modulate(rmsnorm(x), shift, scale))
  out = final_linear(modulate(affine-free-rmsnorm(x), shift, scale))

At inference the AdaLN modulations of all solver steps are computed once per
frame (``precompute_mods``) and each denoise call runs ``apply_with_mods``;
after ``fuse_head`` the FFN stack runs as kernel C
(ops/head_fused.fused_head_ffn_stack).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..configs import DiffusionHeadConfig

from ..ops.head_fused import fused_head_ffn_stack, pack_head_ffns
from ..ops.norms import rms_norm
from ..ops.quant import mm

Params = Dict

FREQ_EMBED_SIZE = 256


def timestep_embedding(t: torch.Tensor, dim: int = FREQ_EMBED_SIZE,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] layout, float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _ffn(f: Params, h: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(h, f["gate"])) * mm(h, f["up"]), f["down"])


def apply(params: Params, cfg: DiffusionHeadConfig, noisy: torch.Tensor, timesteps: torch.Tensor,
          condition: torch.Tensor) -> torch.Tensor:
    """noisy (B, latent), timesteps (B,), condition (B, hidden) -> (B, latent)."""
    x = mm(noisy, params["noisy_proj"])
    t_freq = timestep_embedding(timesteps).to(x.dtype)
    te = params["t_embedder"]
    t_emb = mm(F.silu(mm(t_freq, te["fc1"])), te["fc2"])
    c = mm(condition, params["cond_proj"]) + t_emb
    for lp in params["layers"]:
        shift, scale, gate = mm(F.silu(c), lp["adaln"]).chunk(3, dim=-1)
        h = rms_norm(x, lp["norm"]["w"], cfg.rms_norm_eps)
        x = x + gate * _ffn(lp["ffn"], h * (1 + scale) + shift)
    shift, scale = mm(F.silu(c), params["final"]["adaln"]).chunk(2, dim=-1)
    h = rms_norm(x, None, cfg.rms_norm_eps)
    return mm(h * (1 + scale) + shift, params["final"]["linear"])


def precompute_mods(params: Params, cfg: DiffusionHeadConfig, timesteps: torch.Tensor,
                    condition: torch.Tensor) -> Dict:
    """timesteps (K,), condition (B, H) -> {"layers": [(K, B, 3H)] * L,
    "final": (K, B, 2H)}: the AdaLN weights are read once per frame."""
    k, b = timesteps.shape[0], condition.shape[0]
    t_freq = timestep_embedding(timesteps).to(condition.dtype)
    te = params["t_embedder"]
    t_emb = mm(F.silu(mm(t_freq, te["fc1"])), te["fc2"])  # (K, H)
    c = mm(condition, params["cond_proj"])[None, :, :] + t_emb[:, None, :]  # (K, B, H)
    sc = F.silu(c).reshape(k * b, -1)
    return {
        "layers": [mm(sc, lp["adaln"]).reshape(k, b, -1) for lp in params["layers"]],
        "final": mm(sc, params["final"]["adaln"]).reshape(k, b, -1),
    }


def step_mods(mods: Dict, i: int) -> Dict:
    """Solver step i's slice of ``precompute_mods``."""
    return {"layers": [m[i] for m in mods["layers"]], "final": mods["final"][i]}


def apply_with_mods(params: Params, cfg: DiffusionHeadConfig, noisy: torch.Tensor,
                    mods: Dict) -> torch.Tensor:
    """One denoise call with this step's modulations
    {"layers": [(B, 3H)] * L, "final": (B, 2H)}."""
    x = mm(noisy, params["noisy_proj"])
    packed = params.get("ffn_packed")
    if packed is not None:
        stacked = torch.stack([m.to(x.dtype) for m in mods["layers"]])
        x = fused_head_ffn_stack(packed, x, stacked)
    else:
        for lp, mod in zip(params["layers"], mods["layers"]):
            shift, scale, gate = mod.to(x.dtype).chunk(3, dim=-1)
            h = rms_norm(x, lp["norm"]["w"], cfg.rms_norm_eps)
            x = x + gate * _ffn(lp["ffn"], h * (1 + scale) + shift)
    shift, scale = mods["final"].to(x.dtype).chunk(2, dim=-1)
    h = rms_norm(x, None, cfg.rms_norm_eps)
    return mm(h * (1 + scale) + shift, params["final"]["linear"])


def fuse_head(head_params: Params, cfg: DiffusionHeadConfig, quantize: bool = True) -> Params:
    """Serving prep: pack the AdaLN-FFN stack for kernel C. The AdaLN and
    norm weights stay; the dense FFN weights move into the pack. An int8
    head (``quantize_for_inference(components=("diffusion_head",))``) is
    refused: the pack reads dense weights (and quantizes them itself), and
    the JAX package's ``fuse_head`` cannot take one either."""
    if any("w" not in p for lp in head_params["layers"] for p in lp["ffn"].values()):
        raise ValueError("fuse_head takes the dense diffusion head: an int8 head (quantized "
                         "by quantize_for_inference's 'diffusion_head') runs its FFNs through "
                         "kernel A unfused; fuse the dense head with quantize=True instead")
    out = dict(head_params)
    out["ffn_packed"] = pack_head_ffns(head_params["layers"], cfg.rms_norm_eps, quantize)
    out["layers"] = [{"norm": lp["norm"], "adaln": lp["adaln"]} for lp in head_params["layers"]]
    return out
