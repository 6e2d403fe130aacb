"""GPipe pipeline parallelism for the Qwen2 LM training forward
(port of vibevoice_tpu/parallel/pipeline.py).

The LM's layers split into ``pp`` contiguous stages over the "pp"
dimension of a ("dp", "pp") mesh; micro-batches flow through the stages
GPipe-style. The JAX package writes the schedule as one ``lax.scan`` over
M + pp - 1 ticks in ``shard_map`` and gets the backward from ``jax.grad``;
the port runs one process per stage and writes both passes out in one
autograd ``Function``:

* parameters: ``stack_layers`` gives every layer leaf a leading (pp, L/pp)
  pair of dimensions, the JAX layout; ``pp_lm_param_shardings`` splits the
  first over "pp", so a rank holds (1, L/pp, ...) leaves of its own
  contiguous layers (``mesh.shard_params``). Saves go through
  ``unstack_layers``, which restores the list layout;
* forward: at tick i stage s runs micro-batch i - s, if there is one: stage
  0 reads it from the embeddings, the others receive it from stage s - 1;
  each stage sends its output to stage s + 1, and the last stage keeps it.
  Each micro-batch runs ``qwen2.train_layers`` with the positions, RoPE and
  masks that ``qwen2.forward`` builds for its samples, so the forward is
  bit-equal to the dense one. The last stage broadcasts the hidden states
  to the group, and the final norm runs on every rank;
* backward: the ticks in reverse; each stage receives the gradient of its
  outputs from stage s + 1 (the last takes the loss's), differentiates its
  saved micro-batch graphs into its layers' gradients and sends the
  gradient of its inputs to stage s - 1. Stage 0 broadcasts the
  embeddings' gradient, so that every rank's replicated parameters get the
  same gradient. Gradients agree with the dense ones up to float
  associativity (the per-micro-batch sums).

The hand-offs are point-to-point ``torch.distributed`` sends and receives
(NCCL on the card, gloo on the CPU); the stage's inputs are kept for the
backward (GPipe's activation memory), or recomputed per layer under remat.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..configs import Qwen2Config
from ..models import qwen2
from ..ops.norms import rms_norm
from .mesh import REPLICATED, _init, _tree_map, axis_index


def make_pp_mesh(pp: int, dp: int = 1) -> DeviceMesh:
    """A mesh with a pipeline dimension: ("dp", "pp"), world dp * pp."""
    return _init((dp, pp), ("dp", "pp"))


def stack_layers(lm_params: Dict, pp: int) -> Dict:
    """The pipeline layout: {"embed", "final_norm", ..., "layers_stacked"},
    every layer leaf with a leading (pp, L/pp) pair of dimensions."""
    layers = lm_params["layers"]
    n = len(layers)
    if n % pp != 0:
        raise ValueError(f"{n} layers not divisible by pp={pp}")
    stacked = _tree_map(lambda *ls: torch.stack(ls).reshape((pp, n // pp) + tuple(ls[0].shape)),
                        *layers)
    out = {k: v for k, v in lm_params.items() if k != "layers"}
    out["layers_stacked"] = stacked
    return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unstack(stacked) -> List[Dict]:
    """The per-layer trees of (S, per, ...) leaves, stage-major."""
    s, per = _leaves(stacked)[0].shape[:2]
    return [_tree_map(lambda l, a=a, i=i: l[a, i], stacked) for a in range(s) for i in range(per)]


def unstack_layers(pp_lm_params: Dict) -> Dict:
    """Inverse of stack_layers (checkpoints keep the list layout)."""
    out = {k: v for k, v in pp_lm_params.items() if k != "layers_stacked"}
    out["layers"] = _unstack(pp_lm_params["layers_stacked"])
    return out


def pp_lm_param_shardings(pp_lm_params: Dict) -> Dict:
    """The stage dimension of layers_stacked over "pp"; embed and
    final_norm replicated (they run outside the pipe)."""
    out = _tree_map(lambda _: REPLICATED, pp_lm_params)
    out["layers_stacked"] = _tree_map(lambda _: ("pp",), pp_lm_params["layers_stacked"])
    return out


def pp_model_param_shardings(params: Dict) -> Dict:
    """The composite model: the LM pipelined, everything else replicated."""
    out = _tree_map(lambda _: REPLICATED, params)
    out["lm"] = pp_lm_param_shardings(params["lm"])
    return out


def _stage_forward(cfg: Qwen2Config, layers, x, valid, remat: bool,
                   remat_policy: Optional[str] = None):
    """One micro-batch through this stage's layers (qwen2.forward's
    training path, without the final norm)."""
    positions = qwen2.train_attention_inputs(valid)
    cos, sin = qwen2.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
    return qwen2.train_layers(cfg, layers, x, cos, sin, valid, remat,
                              remat_policy=remat_policy)


class _Plan:
    """What the pipe's Function needs besides tensors."""

    def __init__(self, cfg, stacked, valid, m, remat, mesh, remat_policy=None):
        self.cfg, self.valid, self.m, self.remat = cfg, valid, m, remat
        self.remat_policy = remat_policy
        self.group = mesh.get_group("pp")
        self.ranks = dist.get_process_group_ranks(self.group)
        self.pp = len(self.ranks)
        self.stage = axis_index(mesh, "pp")
        self.keys = stacked  # the structure of the (1, per, ...) leaves

    def layers(self, leaves: List[torch.Tensor]) -> List[Dict]:
        it = iter(leaves)

        def rebuild(t):
            if isinstance(t, dict):
                return {k: rebuild(t[k]) for k in sorted(t)}
            return next(it)

        return _unstack(rebuild(self.keys))

    def peer(self, delta: int) -> int:
        return self.ranks[self.stage + delta]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, x, *leaves):
        m, pp, stage = plan.m, plan.pp, plan.stage
        live = [l.detach().requires_grad_(l.requires_grad) for l in leaves]
        with torch.enable_grad():  # the layer views must carry the gradient too
            layers = plan.layers(live)
        xs, vs = x.chunk(m), plan.valid.chunk(m)
        graphs, outs, sends = {}, [None] * m, []
        for tick in range(m + pp - 1):
            mb = tick - stage
            if not 0 <= mb < m:
                continue
            if stage == 0:
                inp = xs[mb].detach()
            else:
                inp = torch.empty_like(xs[mb])
                dist.recv(inp, src=plan.peer(-1), group=plan.group)
            inp.requires_grad_(True)
            with torch.enable_grad():
                y = _stage_forward(plan.cfg, layers, inp, vs[mb], plan.remat, plan.remat_policy)
            graphs[mb] = (inp, y)
            if stage < pp - 1:
                out = y.detach()
                sends.append((dist.isend(out, dst=plan.peer(1), group=plan.group), out))
            else:
                outs[mb] = y.detach()
        for work, _ in sends:
            work.wait()
        hidden = torch.cat(outs) if stage == pp - 1 else torch.empty_like(x)
        dist.broadcast(hidden, src=plan.ranks[-1], group=plan.group)
        ctx.plan, ctx.graphs, ctx.live = plan, graphs, live
        return hidden

    @staticmethod
    def backward(ctx, grad):
        plan, graphs, live = ctx.plan, ctx.graphs, ctx.live
        m, pp, stage = plan.m, plan.pp, plan.stage
        wanted = [l for l in live if l.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(wanted)
        gouts = grad.chunk(m)
        dxs, sends = [None] * m, []
        for tick in reversed(range(m + pp - 1)):
            mb = tick - stage
            if not 0 <= mb < m:
                continue
            inp, y = graphs.pop(mb)
            if stage == pp - 1:
                g = gouts[mb].contiguous()
            else:
                g = torch.empty_like(y)
                dist.recv(g, src=plan.peer(1), group=plan.group)
            got = torch.autograd.grad(y, [inp] + wanted, g, allow_unused=True)
            acc = [a if d is None else (d if a is None else a + d) for a, d in zip(acc, got[1:])]
            if stage > 0:
                dx = got[0].contiguous()
                sends.append((dist.isend(dx, dst=plan.peer(-1), group=plan.group), dx))
            else:
                dxs[mb] = got[0]
        for work, _ in sends:
            work.wait()
        dx = torch.cat(dxs) if stage == 0 else torch.empty_like(grad)
        dist.broadcast(dx, src=plan.ranks[0], group=plan.group)
        it = iter(acc)
        leaf_grads = [next(it) if l.requires_grad else None for l in live]
        return (None, dx, *leaf_grads)


def pipelined_forward(cfg: Qwen2Config, pp_lm_params: Dict, embeds: torch.Tensor,
                      mesh: DeviceMesh, *, valid_mask: Optional[torch.Tensor] = None,
                      n_microbatches: int = 4, remat: bool = False,
                      remat_policy: Optional[str] = None) -> torch.Tensor:
    """GPipe forward over the mesh's "pp" dimension: hidden (B, T, H) after
    the final norm, the pipelined ``qwen2.forward(cfg, lm_params, embeds,
    valid_mask=...)[0]``. ``pp_lm_params`` is this rank's tree (its stage's
    (1, L/pp, ...) layers_stacked leaves); every rank of the pipe passes the
    same embeddings (this data rank's batch), whose batch dimension splits
    into ``n_microbatches``."""
    b = embeds.shape[0]
    m = n_microbatches
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by n_microbatches={m}")
    qwen2.check_remat_policy(remat_policy)
    if valid_mask is None:
        valid_mask = torch.ones(embeds.shape[:2], dtype=torch.bool, device=embeds.device)
    stacked = pp_lm_params["layers_stacked"]
    plan = _Plan(cfg, stacked, valid_mask, m, remat, mesh, remat_policy)
    hidden = _GPipe.apply(plan, embeds, *_leaves(stacked))
    return rms_norm(hidden, pp_lm_params["final_norm"]["w"], cfg.rms_norm_eps)


def make_pp_lm_forward(mesh: DeviceMesh, n_microbatches: int = 4):
    """An ``lm_forward`` hook for finetune.loss.train_forward: the LM
    through the pipeline (params["lm"] in the stack_layers layout, this
    rank's stage)."""

    def lm_forward(cfg, lm_params, embeds, valid_mask, remat, remat_policy=None):
        return pipelined_forward(cfg, lm_params, embeds, mesh, valid_mask=valid_mask,
                                 n_microbatches=n_microbatches, remat=remat,
                                 remat_policy=remat_policy)

    return lm_forward
