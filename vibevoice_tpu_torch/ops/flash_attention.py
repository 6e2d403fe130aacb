"""Kernel B: causal GQA attention over the persistent KV cache
(port of vibevoice_tpu/ops/flash_attention.py, cached half).

One function serves chunked prefill (W > 1) and decode (W = 1). Query row i
of sample b sits at absolute slot ``base[b] + i`` and attends keys
``j <= base[b] + i`` (clamped to the cache). Right padding is assumed: pad
rows of a chunk attend like valid rows at their slot, as on the TPU.
int8 caches carry per-row scales (B, KH, 1, S): the K scale multiplies the
scores and the V scale the probabilities.

On a CUDA tensor ``flash_cached_attention`` launches the hand-written
flash-decoding kernel (csrc/flash_attention.cu); on a CPU tensor it runs
``flash_cached_attention_plain``. The ring-attention hop kernel of the JAX
file is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda

SPLIT_KEYS = 128  # keys per split at decode (csrc/flash_attention.cu)


def flash_cached_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B over the whole cache, f32 softmax."""
    b, w, nh, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    g = nh // kh
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, w, kh, g, d) * scale
    sc = torch.einsum("bwkgd,bksd->bkgws", qg, k_cache.float())
    if k_scale is not None:
        sc = sc * k_scale.float()[:, :, None]  # (B, KH, 1, 1, S)
    lim = base_lens.to(torch.int64)[:, None] + torch.arange(w, device=q.device)  # (B, W)
    live = torch.arange(s, device=q.device)[None, None, :] <= lim[:, :, None]  # (B, W, S)
    sc = sc.masked_fill(~live[:, None, None], float("-inf"))
    p = torch.softmax(sc, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None]
    out = torch.einsum("bkgws,bksd->bwkgd", p, v_cache.float())
    return out.reshape(b, w, nh, d).to(q.dtype)


def flash_cached_attention(
    q: torch.Tensor,  # (B, W, NH, D)
    k_cache: torch.Tensor,  # (B, KH, S, D), the chunk already written at base
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # (B,) int32
    *,
    k_scale: Optional[torch.Tensor] = None,  # (B, KH, 1, S) f32 for int8 caches
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, W, NH, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_cached_attention_plain(
            q, k_cache, v_cache, base_lens, k_scale=k_scale, v_scale=v_scale, scale=scale
        )
    b, w, nh, d = q.shape
    kh, s = k_cache.shape[1], k_cache.shape[2]
    quant = k_scale is not None
    tensors = [q, k_cache, v_cache, base_lens] + ([k_scale, v_scale] if quant else [])
    _cuda.require_cuda(*tensors)
    if d > 128 or nh % kh or k_cache.shape != (b, kh, s, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"unsupported shapes q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if base_lens.dtype != torch.int32 or base_lens.shape != (b,):
        raise ValueError("base_lens must be (B,) int32")
    if quant:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise ValueError("scales given but the cache is not int8")
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or t.shape != (b, kh, 1, s):
                raise ValueError(f"scales must be (B, KH, 1, S) f32, got {tuple(t.shape)}")
    elif k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"a {k_cache.dtype} cache needs q of the same dtype, got {q.dtype}")
    r = w * (nh // kh)
    q_tiles = -(-r // 16)
    n_splits = max(1, min(-(-s // SPLIT_KEYS), 256 // q_tiles))
    kspl = -(-(-(-s // n_splits)) // 32) * 32
    n_splits = -(-s // kspl)
    out = torch.empty_like(q)
    ws = torch.empty(b * kh * n_splits * r * (d + 2), dtype=torch.float32, device=q.device)
    _cuda.library().call(
        "vv_flash_cached_attention", q.data_ptr(), _cuda.dtype_code(q), k_cache.data_ptr(),
        v_cache.data_ptr(), _cuda.dtype_code(k_cache), _cuda.ptr(k_scale), _cuda.ptr(v_scale),
        base_lens.data_ptr(), out.data_ptr(), ws.data_ptr(), b, w, nh, kh, s, d, n_splits, kspl,
        float(d ** -0.5 if scale is None else scale), _cuda.stream_ptr(q.device),
    )
    flash_cached_attention.launches += 1
    return out


flash_cached_attention.launches = 0
