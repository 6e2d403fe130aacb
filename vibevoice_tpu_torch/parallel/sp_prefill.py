"""Sequence-parallel (ring-attention) prefill of long prompts
(port of vibevoice_tpu/parallel/sp_prefill.py).

Each rank of the mesh's "tp" group embeds the whole prompt (voice features
spliced in), then runs the Qwen2 layers over its contiguous shard of T/n
positions: norms, projections, RoPE and the MLP on its own rows, attention
as a ring (``ring_attention.ring_attention_local``, kernel F on each hop).
The hidden states and every layer's K/V are then gathered on every rank and
written into a right-padded KV cache, bf16 or int8 rows
(``qwen2.make_cache`` semantics), so an n-rank group prefills a prompt with
1/n of the attention work per rank. The negative CFG stream and the conv
states come from ``inference._init_streams`` exactly as in ``prefill_fn``;
``ring_prefill_carry`` returns the ``DecodeCarry`` that ``inference.step``
takes unchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..configs import Qwen2Config, VibeVoiceConfig

from ..models import inference as inf
from ..models import qwen2
from ..ops.norms import rms_norm
from ..ops.quant import mm
from .ring_attention import all_gather_seq, ring_attention_local


def _local_layer(cfg: Qwen2Config, lp, x, cos, sin, lengths, group):
    b, t, h = x.shape
    hdn = rms_norm(x, lp["input_norm"]["w"], cfg.rms_norm_eps)
    q, k, v = qwen2.project_qkv(lp["attn"], hdn, cfg)
    q, k = qwen2.apply_rope(q, cos, sin), qwen2.apply_rope(k, cos, sin)
    attn = ring_attention_local(q, k, v, lengths, group=group, scale=cfg.head_dim ** -0.5)
    x = x + mm(attn.reshape(b, t, h), lp["attn"]["o"])
    x = x + qwen2.mlp_forward(lp["mlp"], rms_norm(x, lp["post_norm"]["w"], cfg.rms_norm_eps))
    return x, k, v


def _local_forward(cfg: Qwen2Config, lm_params, x, positions, lengths, group):
    """This rank's shard x (B, Tl, H) at slots ``positions`` (B, Tl) ->
    (hidden after the final norm, per-layer k list, v list of (B, Tl, KH, D))."""
    cos, sin = qwen2.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
    ks, vs = [], []
    for lp in lm_params["layers"]:
        x, k, v = _local_layer(cfg, lp, x, cos, sin, lengths, group)
        ks.append(k)
        vs.append(v)
    return rms_norm(x, lm_params["final_norm"]["w"], cfg.rms_norm_eps), ks, vs


def _sp_forward(cfg: Qwen2Config, lm_params, embeds: torch.Tensor, valid: torch.Tensor,
                mesh: DeviceMesh, axis: str = "tp"):
    """Sequence-sharded LM prefill forward over the ranks of ``axis``.

    embeds (B, T, H) right-padded, T divisible by the axis size, the same on
    every rank. Returns the gathered hidden (B, T, H) and per-layer k, v
    lists of (B, T, KH, D). Slot index is the RoPE position (pad slots
    included; their rows are never attended)."""
    group = mesh.get_group(axis)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    b, t, _ = embeds.shape
    if t % n:
        raise ValueError(f"sequence length {t} is not divisible by the {n} ranks of '{axis}'")
    tl = t // n
    lengths = valid.sum(dim=1, dtype=torch.int32)
    positions = torch.arange(rank * tl, (rank + 1) * tl, device=embeds.device).expand(b, tl)
    x, ks, vs = _local_forward(cfg, lm_params, embeds[:, rank * tl:(rank + 1) * tl], positions,
                               lengths, group)
    return (all_gather_seq(x, group), [all_gather_seq(k, group) for k in ks],
            [all_gather_seq(v, group) for v in vs])


def _same_on_every_rank(x: torch.Tensor, group) -> bool:
    """Whether every rank of ``group`` holds the same integer tensor x (all
    ranks get the same answer, so they fail together, not in a hang)."""
    ref = x.clone()
    dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
    bad = torch.tensor([int(not torch.equal(ref, x))], device=x.device)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
    return not bad.item()


def ring_prefill_carry(cfg: VibeVoiceConfig, params, ids: torch.Tensor, valid_mask: torch.Tensor,
                       max_len: int, tokens: inf.SpecialTokens, mesh: DeviceMesh, *,
                       axis: str = "tp", speech_args=None, speech_type: str = "audio",
                       kv_int8: bool = False) -> inf.DecodeCarry:
    """Sequence-parallel counterpart of ``inference.prefill_fn``.

    ids and valid_mask (B, T) are right-padded and the same on every rank
    (checked: a tokenizer that hashes with Python's per-process salt gives
    each rank other ids), as are ``speech_args`` (``prefill_fn``'s tuple);
    the prompt is padded to a multiple of the axis size. Every rank returns
    the same carry."""
    lm_cfg = cfg.decoder_config
    b, t = ids.shape
    group = mesh.get_group(axis)
    if not _same_on_every_rank(torch.stack([ids.long(), valid_mask.long()]), group):
        raise ValueError(f"the prompt (ids, valid_mask) differs between the ranks of '{axis}'")
    n = dist.get_world_size(group)
    pad_t = -(-t // n) * n
    if pad_t > max_len:
        raise ValueError(f"the prompt padded to {pad_t} slots does not fit max_len={max_len}")
    embeds = inf._prompt_embeds(cfg, params, ids, speech_args, speech_type)
    valid = valid_mask
    if pad_t != t:
        embeds = F.pad(embeds, (0, 0, 0, pad_t - t))
        valid = F.pad(valid, (0, pad_t - t))
    hidden, ks, vs = _sp_forward(lm_cfg, params["lm"], embeds, valid, mesh, axis)
    lengths = valid.sum(dim=1, dtype=torch.int32)
    h_pos = hidden[torch.arange(b, device=hidden.device), (lengths.long() - 1).clamp_min(0)]

    pos_cache, neg_cache, h_neg, dec_state, sem_state = inf._init_streams(
        cfg, params, b, max_len, tokens, kv_int8)
    for li in range(lm_cfg.num_hidden_layers):
        for kv, buf, scales in ((ks[li], pos_cache.k[li], pos_cache.k_scale),
                                (vs[li], pos_cache.v[li], pos_cache.v_scale)):
            if kv_int8:
                rows, row_scale = qwen2.quantize_kv_rows(kv)
                scales[li][:, :, 0, :pad_t] = row_scale.transpose(1, 2)
                buf[:, :, :pad_t] = rows.transpose(1, 2)
            else:
                buf[:, :, :pad_t] = kv.transpose(1, 2)
        ks[li] = vs[li] = None  # free each layer's gathered K/V once written
    pos_cache = pos_cache._replace(length=lengths)
    return inf.DecodeCarry(inf._combine_caches(pos_cache, neg_cache), dec_state, sem_state,
                           h_pos, h_neg, torch.zeros(b, dtype=torch.bool, device=h_pos.device),
                           torch.zeros(b, dtype=torch.int64, device=h_pos.device))
