"""Qwen2 decoder LM with the right-padded per-sample KV cache
(port of vibevoice_tpu/models/qwen2.py, cached forward).

Sequences are right-padded and each sample carries its own valid length.
A chunk of W tokens is written at ``length[b]`` and attends keys
``j <= length[b] + i``; not advancing a sample's length "deletes" its
speculative token (the negative CFG stream's trick). Pad query rows take
position ``length[b]``.

Every linear goes through ``ops.quant.mm`` (int8 entries take kernel A) and
the cached attention through ``ops.flash_attention.flash_cached_attention``
(kernel B on CUDA, its plain version on the CPU).

Unlike the JAX package, the cache tensors are updated in place: the port
returns a KVCache that shares the buffers with the one it was given and
carries the new lengths, which saves a copy of the whole cache per step.
The no-cache training forward is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vibevoice_tpu.configs import Qwen2Config

from ..ops.flash_attention import flash_cached_attention
from ..ops.norms import rms_norm
from ..ops.quant import mm

Params = Dict


class KVCache(NamedTuple):
    """Per-layer (B, KH, S, D) buffers and the (B,) int32 valid lengths.
    int8 mode adds per-(token, kv-head) row scales (B, KH, 1, S) f32."""

    k: tuple
    v: tuple
    length: torch.Tensor
    k_scale: Optional[tuple] = None
    v_scale: Optional[tuple] = None

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def make_cache(cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16, *,
               quantized: bool = False, device=None) -> KVCache:
    shape = (batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    scale_shape = (batch, cfg.num_key_value_heads, 1, max_len)
    nl = cfg.num_hidden_layers
    buf_dtype = torch.int8 if quantized else dtype

    def bufs(shp, dt):
        return tuple(torch.zeros(shp, dtype=dt, device=device) for _ in range(nl))

    return KVCache(
        k=bufs(shape, buf_dtype),
        v=bufs(shape, buf_dtype),
        length=torch.zeros(batch, dtype=torch.int32, device=device),
        k_scale=bufs(scale_shape, torch.float32) if quantized else None,
        v_scale=bufs(scale_shape, torch.float32) if quantized else None,
    )


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, W, KH, D) -> int8 rows and (B, W, KH) f32 scales with q * scale ~ x;
    all-zero rows get scale 0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    inv = torch.where(amax > 0, 127.0 / amax.clamp_min(1e-30), torch.zeros_like(amax))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, amax / 127.0


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float, dtype):
    """positions (B, T) -> cos/sin (B, T, D) in HF half-split layout."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
                  / head_dim)
    )
    freqs = positions.float()[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); HF rotate-half convention."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rot * sin[:, :, None, :]


def _write_rows(buf: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """Write new (B, W, KH, ...) into buf (B, KH, S, ...) at slots idx (B, W)."""
    bi = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[bi, :, idx] = new


def _layer(cfg: Qwen2Config, lp, x, cos, sin, cache_kv, idx, base):
    b, t, h = x.shape
    nh, kh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    res = x
    hdn = rms_norm(x, lp["input_norm"]["w"], cfg.rms_norm_eps)
    a = lp["attn"]
    q = apply_rope(mm(hdn, a["q"]).reshape(b, t, nh, d), cos, sin)
    k = apply_rope(mm(hdn, a["k"]).reshape(b, t, kh, d), cos, sin)
    v = mm(hdn, a["v"]).reshape(b, t, kh, d)

    ck, cv, cks, cvs = cache_kv
    if cks is not None:
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        _write_rows(ck, kq, idx)
        _write_rows(cv, vq, idx)
        _write_rows(cks[:, :, 0], ks, idx)
        _write_rows(cvs[:, :, 0], vs, idx)
        attn = flash_cached_attention(q, ck, cv, base, k_scale=cks, v_scale=cvs, scale=d ** -0.5)
    else:
        _write_rows(ck, k.to(ck.dtype), idx)
        _write_rows(cv, v.to(cv.dtype), idx)
        attn = flash_cached_attention(q, ck.to(q.dtype), cv.to(q.dtype), base, scale=d ** -0.5)
    x = res + mm(attn.reshape(b, t, h), a["o"])

    res = x
    hdn = rms_norm(x, lp["post_norm"]["w"], cfg.rms_norm_eps)
    m = lp["mlp"]
    hdn = mm(F.silu(mm(hdn, m["gate"])) * mm(hdn, m["up"]), m["down"])
    return res + hdn


def forward(
    cfg: Qwen2Config,
    params: Params,
    embeds: torch.Tensor,
    *,
    cache: KVCache,
    valid_mask: Optional[torch.Tensor] = None,
    advance: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the LM over a chunk (B, T, H) appended at ``cache.length``.

    ``advance`` (B,) int32 is how far each length moves (default: the
    count of valid tokens); zeros evaluate speculatively. Returns
    (hidden (B, T, H) after the final norm, cache with the new lengths)."""
    b, t, _ = embeds.shape
    if valid_mask is None:
        valid_mask = torch.ones(b, t, dtype=torch.bool, device=embeds.device)
    base = cache.length
    q_abs = base[:, None] + torch.cumsum(valid_mask.to(torch.int32), dim=1) - 1
    positions = torch.where(valid_mask, q_abs, base[:, None])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, embeds.dtype)
    # the chunk lands at base, clamped so it fits (lax.dynamic_update_slice
    # semantics: a finished sample's length may sit at S)
    start = base.clamp(0, cache.max_len - t)
    idx = start[:, None].long() + torch.arange(t, device=embeds.device)

    x = embeds
    quant = cache.quantized
    for li, lp in enumerate(params["layers"]):
        cache_kv = (cache.k[li], cache.v[li],
                    cache.k_scale[li] if quant else None, cache.v_scale[li] if quant else None)
        x = _layer(cfg, lp, x, cos, sin, cache_kv, idx, base)
    x = rms_norm(x, params["final_norm"]["w"], cfg.rms_norm_eps)
    if advance is None:
        advance = valid_mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return x, cache._replace(length=cache.length + advance)


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids]
