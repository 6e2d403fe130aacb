"""Collectives that autograd sees (the port's counterpart of what XLA
inserts for the JAX package's shardings).

Megatron's two operators of a tensor-parallel block, over the ranks of a
"tp" group:

* ``copy_to_group`` (f): identity forward, the gradient all-reduced in the
  backward; it stands where a replicated activation enters the rank-local
  part of a block (q/k/v, gate/up) and where a replicated adapter factor
  is merged into a local weight shard;
* ``reduce_from_group`` (g): the partial sums after o and down all-reduced
  in the forward, identity backward. The sum is taken in f32 and cast back
  to the activation dtype, so that a bf16 run stays close to the dense one.

FSDP's weight gather: ``all_gather_dim`` concatenates the shards of one
dimension across a group in the forward and reduce-scatters (sums) the
gradient back onto the shard in the backward.

Every rank passes plain local tensors; the kernels never see anything else.
With no group (None) each operator is the identity, so the one-device paths
run the same code.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group, accumulated in f32, in x's dtype (x is not
    modified)."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_f32(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: x unchanged; its gradient summed over the group."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of every rank's partial x (f32 accumulation)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromGroup.apply(x, group)
    return all_reduce_f32(x, group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).to(torch.float32).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).to(x.dtype)


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor from every rank's shard of dimension ``dim`` (rank
    order); the gradient of the full tensor is summed over the group onto
    each shard (reduce-scatter)."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGatherDim.apply(x, dim, group)
    return _gather(x, dim, group)


def all_reduce_sum(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """x summed over the group in place (no autograd), returned."""
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x
