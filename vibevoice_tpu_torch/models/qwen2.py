"""Qwen2 decoder LM with the right-padded per-sample KV cache
(port of vibevoice_tpu/models/qwen2.py, cached forward).

Sequences are right-padded and each sample carries its own valid length.
A chunk of W tokens is written at ``length[b]`` and attends keys
``j <= length[b] + i``; not advancing a sample's length "deletes" its
speculative token (the negative CFG stream's trick). Pad query rows take
position ``length[b]``.

Every linear goes through ``ops.quant.mm`` (int8 entries take kernel A, and
kernel E in the backward) and the cached attention through
``ops.flash_attention.flash_cached_attention`` (kernel B on CUDA, its plain
version on the CPU).

Unlike the JAX package, the cache tensors are updated in place: the port
returns a KVCache that shares the buffers with the one it was given and
carries the new lengths, which saves a copy of the whole cache per step.

Without a cache, ``forward`` is the training path: causal self-attention
over a right-padded chunk through ``ops.flash_attention.flash_train_attention``
(the hand-written training kernels on CUDA at every T, the masked plain
version on the CPU), optionally rematerialising each layer in the backward
(``torch.utils.checkpoint``).

Tensor parallelism (``tp_group``): each rank holds its shard of the LM by
``parallel.mesh.qwen2_param_shardings`` (q/k/v/gate/up columns, o/down
rows) and the KV cache of its own KV heads (``make_cache(kv_heads=)``).
Head counts are read from the local weights, so the kernels run unchanged
on the local heads. The partial sums after o and down are all-reduced over
the group in f32 (``parallel.collectives``: Megatron's g, with f where a
replicated activation enters the local part, for the backward).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs import Qwen2Config

from ..ops.flash_attention import flash_cached_attention, flash_train_attention
from ..ops.norms import rms_norm
from ..ops.quant import mm
from ..parallel.collectives import copy_to_group, group_size, reduce_from_group

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


def local_kv_heads(cfg: Qwen2Config, tp_group=None) -> int:
    """The KV heads one rank of a tensor-parallel group holds."""
    return cfg.num_key_value_heads // group_size(tp_group)


def make_cache(cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16, *,
               quantized: bool = False, device=None, kv_heads: Optional[int] = None) -> KVCache:
    """Zero buffers of ``kv_heads`` KV heads (default: all of cfg's; a
    tensor-parallel rank holds ``local_kv_heads``)."""
    kh = cfg.num_key_value_heads if kv_heads is None else kv_heads
    shape = (batch, kh, max_len, cfg.head_dim)
    scale_shape = (batch, kh, 1, max_len)
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


def project_qkv(ap: Params, hdn: torch.Tensor, cfg: Qwen2Config, tp_group=None):
    """q/k/v projections (B, T, heads, D); the head counts are those of the
    (local) weights. A packed "qkv" entry (ops/quant.pack_lm_projections)
    runs one int8 matmul, split by the heads of its scale: q, k and v are
    then views of its output, which no kernel reads as such (RoPE makes new
    q and k, the cache writes copy v, and the training attention takes
    contiguous copies)."""
    b, t, _ = hdn.shape
    d = cfg.head_dim
    hdn = copy_to_group(hdn, tp_group)
    if "qkv" in ap:
        nh = cfg.num_attention_heads // group_size(tp_group)
        kh = (ap["qkv"]["scale"].shape[0] // d - nh) // 2
        q, k, v = mm(hdn, ap["qkv"]).split([nh * d, kh * d, kh * d], dim=-1)
    else:
        q, k, v = mm(hdn, ap["q"]), mm(hdn, ap["k"]), mm(hdn, ap["v"])
    return q.reshape(b, t, -1, d), k.reshape(b, t, -1, d), v.reshape(b, t, -1, d)


def mlp_forward(m: Params, hdn: torch.Tensor, tp_group=None) -> torch.Tensor:
    """SwiGLU MLP (under TP: the local columns, the sum over the group); a
    packed "gateup" entry runs both input projections as one int8 matmul."""
    hdn = copy_to_group(hdn, tp_group)
    if "gateup" in m:
        g, u = mm(hdn, m["gateup"]).chunk(2, dim=-1)
    else:
        g, u = mm(hdn, m["gate"]), mm(hdn, m["up"])
    return reduce_from_group(mm(F.silu(g) * u, m["down"]), tp_group)


def _layer(cfg: Qwen2Config, lp, x, cos, sin, cache_kv, idx, base, tp_group=None):
    b, t, _ = x.shape
    d = cfg.head_dim
    res = x
    hdn = rms_norm(x, lp["input_norm"]["w"], cfg.rms_norm_eps)
    a = lp["attn"]
    q, k, v = project_qkv(a, hdn, cfg, tp_group)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

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
    x = res + reduce_from_group(mm(attn.reshape(b, t, -1), a["o"]), tp_group)

    return x + mlp_forward(lp["mlp"], rms_norm(x, lp["post_norm"]["w"], cfg.rms_norm_eps),
                           tp_group)


def _train_layer(cfg: Qwen2Config, lp, x, cos, sin, valid, tp_group=None):
    """One block of the no-cache training forward."""
    b, t, _ = x.shape
    hdn = rms_norm(x, lp["input_norm"]["w"], cfg.rms_norm_eps)
    q, k, v = project_qkv(lp["attn"], hdn, cfg, tp_group)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    attn = flash_train_attention(q, k, v, valid, scale=cfg.head_dim ** -0.5)
    x = x + reduce_from_group(mm(attn.reshape(b, t, -1), lp["attn"]["o"]), tp_group)
    return x + mlp_forward(lp["mlp"], rms_norm(x, lp["post_norm"]["w"], cfg.rms_norm_eps),
                           tp_group)


def _train_layer_at(cfg: Qwen2Config, lp, x, cos, sin, valid, tp_group, materialize, i):
    if materialize is not None:
        lp = materialize(i, lp)
    return _train_layer(cfg, lp, x, cos, sin, valid, tp_group)


# remat_policy="dots" is the JAX package's dots_with_no_batch_dims_saveable:
# the outputs of products without batch dimensions are kept, everything else
# is recomputed in the backward. The policy sees the ATen ops that run under
# the block: torch.matmul of an activation by a 2-D weight (the dense
# linears, the LoRA branches) reaches aten.mm or aten.addmm, which it keeps;
# aten.bmm (batched, the attention's plain version) and every other op are
# recomputed. The port's kernels run through ctypes into buffers that
# aten.empty makes, so kernel A's and E's outputs and the training
# attention's are recomputed, as JAX recomputes its Pallas calls; on a CPU
# tensor kernel A's plain version is itself an aten.mm and is kept. The
# collectives inside a block (FSDP's all-gather, the f32 all-reduces under
# tp_group) are recomputed, as under remat=True: they write into fresh
# buffers, never into a kept output.
_SAVED_UNDER_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_UNDER_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def check_remat_policy(policy: Optional[str]) -> None:
    if policy not in (None, "dots"):
        raise ValueError(f"unknown remat_policy {policy!r} (None | 'dots')")


def checkpointed(fn, *args, policy: Optional[str] = None):
    """fn(*args) recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant): all of it (policy None) or all but the matmul outputs
    ("dots")."""
    check_remat_policy(policy)
    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(_dots_policy))


def train_layers(cfg: Qwen2Config, layers, x, cos, sin, valid, remat: bool = False,
                 tp_group=None, materialize=None, remat_policy: Optional[str] = None):
    """The training forward's blocks over x, each recomputed in the
    backward under ``remat`` (all but its matmul outputs with
    ``remat_policy="dots"``). ``materialize(i, layer params)`` gives the
    tensors layer i runs on, inside the block (FSDP's all-gather of its
    shards: under remat the backward gathers them again)."""
    for i, lp in enumerate(layers):
        args = (cfg, lp, x, cos, sin, valid, tp_group, materialize, i)
        x = (checkpointed(_train_layer_at, *args, policy=remat_policy) if remat
             else _train_layer_at(*args))
    return x


def train_attention_inputs(valid_mask: torch.Tensor) -> torch.Tensor:
    """Positions of the no-cache forward of a right-padded batch: the count
    of valid tokens before each token, clamped at 0 (pads repeat the last)."""
    return (torch.cumsum(valid_mask.to(torch.int32), dim=1) - 1).clamp_min(0)


def _final_norm(cfg: Qwen2Config, params: Params, x: torch.Tensor, skip: bool) -> torch.Tensor:
    return x if skip else rms_norm(x, params["final_norm"]["w"], cfg.rms_norm_eps)


def forward(
    cfg: Qwen2Config,
    params: Params,
    embeds: torch.Tensor,
    *,
    cache: Optional[KVCache] = None,
    valid_mask: Optional[torch.Tensor] = None,
    advance: Optional[torch.Tensor] = None,
    skip_final_norm: bool = False,
    remat: bool = False,
    remat_policy: Optional[str] = None,
    tp_group=None,
    materialize=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the LM over a chunk (B, T, H).

    With a cache the chunk is appended at ``cache.length``; ``advance`` (B,)
    int32 is how far each length moves (default: the count of valid
    tokens); zeros evaluate speculatively. Without a cache it is the
    training path: causal self-attention within the chunk, and ``remat``
    recomputes each layer in the backward so that only the residual stream
    is kept between layers (``remat_policy="dots"``: the matmul outputs are
    kept too, ``checkpointed``). ``skip_final_norm`` leaves out the final RMSNorm
    (the streaming model's lower text LM). Returns (hidden (B, T, H), the
    cache with the new lengths or None). ``tp_group``: the params and the
    cache are this rank's tensor-parallel shards; ``materialize``: the
    training path's per-layer hook (``train_layers``)."""
    b, t, _ = embeds.shape
    if valid_mask is None:
        valid_mask = torch.ones(b, t, dtype=torch.bool, device=embeds.device)
    check_remat_policy(remat_policy)
    if cache is None:
        positions = train_attention_inputs(valid_mask)
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, embeds.dtype)
        x = train_layers(cfg, params["layers"], embeds, cos, sin, valid_mask, remat, tp_group,
                         materialize, remat_policy)
        return _final_norm(cfg, params, x, skip_final_norm), None
    if remat:
        raise ValueError("remat is a training-path option (cache must be None)")
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
        x = _layer(cfg, lp, x, cos, sin, cache_kv, idx, base, tp_group)
    x = _final_norm(cfg, params, x, skip_final_norm)
    if advance is None:
        advance = valid_mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return x, cache._replace(length=cache.length + advance)


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids]


def lm_head_logits(params: Params, hidden: torch.Tensor,
                   lm_head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits over the vocabulary; with tied embeddings ``lm_head`` is the
    embedding matrix (V, H)."""
    w = params["embed"] if lm_head is None else lm_head
    return torch.matmul(hidden, w.T.to(hidden.dtype))
