"""Ring attention over a sequence-sharded prompt
(port of vibevoice_tpu/parallel/ring_attention.py).

Each of the n ranks of a process group owns a contiguous shard of Tl
positions: rank r holds slots [r * Tl, (r + 1) * Tl). Queries stay; K and V
rotate: at hop h rank r folds the block of rank (r - h) mod n through
kernel F (``ops.flash_attention.flash_ring_block``), which keeps the online
softmax state (m, l, acc) in f32, so after n hops every rank has attended
over every key exactly once, as one global softmax would. Between hops the
blocks pass to the next rank with ``dist.batch_isend_irecv``, posted before
the fold so that the exchange overlaps it; the last hop exchanges nothing,
so a group of one does no communication.

Sequences are right-padded (the models' invariant): sample b holds tokens in
slots [0, lengths[b]), so a key is valid iff its slot is below
``lengths[b]`` and only K and V travel. The JAX package's jnp hop and its
``impl``/``RING_IMPL``/``interpret`` switches are TPU choices with no
counterpart: CUDA tensors take the kernel, CPU tensors its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import flash_attention as fa


def all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's (B, Tl, ...) shard along dim 1, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, group, scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Causal GQA attention of this rank's shard over the whole sequence.

    q (B, Tl, NH, D), k/v (B, Tl, KH, D) are the rank's shard, lengths (B,)
    int32 the valid tokens of each sample. Returns (B, Tl, NH, D) in q's
    dtype."""
    b, tl, nh, d = q.shape
    kh = k.shape[2]
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    q = q.contiguous()
    k_blk = k.transpose(1, 2).contiguous()  # (B, KH, Tl, D): the hop kernel's layout
    v_blk = v.transpose(1, 2).contiguous()
    state = fa.ring_state_init(b, kh, tl * (nh // kh), d, device=q.device)
    for hop in range(n):
        pending = []
        if hop + 1 < n:
            k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
            pending = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_blk, nxt, group), dist.P2POp(dist.isend, v_blk, nxt, group),
                dist.P2POp(dist.irecv, k_next, prv, group), dist.P2POp(dist.irecv, v_next, prv, group),
            ])
        fa.flash_ring_block(state, q, k_blk, v_blk, q_start=rank * tl,
                            k_start=(rank - hop) % n * tl, k_len=lengths, scale=scale)
        for req in pending:
            req.wait()
        if pending:
            k_blk, v_blk = k_next, v_next
    return fa.ring_state_out(state, tl, q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                   mesh: DeviceMesh, *, axis: str = "tp", scale: Optional[float] = None
                   ) -> torch.Tensor:
    """Sequence-sharded causal attention, the standalone entry: every rank
    passes the global q (B, T, NH, D), k/v (B, T, KH, D) and the
    right-padded valid mask (B, T), T divisible by the size of the mesh's
    ``axis``; every rank gets the whole (B, T, NH, D) output."""
    group = mesh.get_group(axis)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    b, t = valid.shape
    if t % n:
        raise ValueError(f"sequence length {t} is not divisible by the {n} ranks of '{axis}'")
    lengths = valid.sum(dim=1, dtype=torch.int32)
    if not torch.equal(valid, torch.arange(t, device=valid.device) < lengths[:, None]):
        raise ValueError("valid must be right-padded: each sample's tokens a prefix")
    tl = t // n
    sl = slice(rank * tl, (rank + 1) * tl)
    out = ring_attention_local(q[:, sl], k[:, sl], v[:, sl], lengths, group=group, scale=scale)
    return all_gather_seq(out, group)
