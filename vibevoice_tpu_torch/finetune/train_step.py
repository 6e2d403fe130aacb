"""Optimizer and training steps (port of vibevoice_tpu/finetune/train_step.py).

``make_optimizer`` writes out the optax chain of the JAX package:

  warmup_cosine_decay_schedule(0 -> peak), evaluated at the update count
  before its increment (lr 0 on the first update);
  clip_by_global_norm over the trainable leaves;
  adamw (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay);
  set_to_zero for frozen leaves (no decay either);
  MultiSteps accumulation (the mean gradient of k micro-steps, one update
  every k-th call).

Parameters are trees of tensors (dicts and lists); a leaf's path is the
tuple of its dict keys and list indices, as the JAX path filters see it.
Updates are functional: a step returns new parameter tensors.

Over a mesh (``Parallel``) every rank holds its shards of the tree by the
shardings of ``parallel.mesh`` and its samples of the global batch, and a
step is the JAX package's step over the sharded global batch:

* leaves split over a data axis (FSDP) are all-gathered where they are
  used by an autograd all-gather whose backward reduce-scatters (sums)
  their gradient: an LM layer's inside its block (under remat the backward
  gathers it again, so one layer's weights are whole at a time), the rest
  at the step's start, and a LoRA step's base whole at its start (the
  merge needs it); the AdamW moments are zeros_like the shards, so they
  are stored split too;
* every other gradient is summed over the data group (the loss carries
  each rank's share of the global loss, ``loss.py``), so all data ranks
  apply the same update;
* the global norm that clipping reads is the full tree's: each leaf's
  squares over its local shard, divided by the ranks that hold the same
  shard, summed over the world;
* ``lm_forward`` (GPipe) and the tensor-parallel group reach the loss.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..configs import VibeVoiceConfig

from ..models import qwen2
from ..parallel import mesh as pmesh
from ..schedule.dpm_solver import NoiseSchedule
from .loss import Batch, Draws, TrainOptions, TrainOut, train_forward


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def tree_leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    """(path, tensor) for every tensor leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)] if isinstance(tree, torch.Tensor) else []


def tree_replace(tree, new: Dict[Tuple, torch.Tensor], path: Tuple = ()):
    """A copy of the tree's containers with the leaves at the paths in `new` swapped."""
    if path in new:
        return new[path]
    if isinstance(tree, dict):
        return {k: tree_replace(v, new, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_replace(v, new, path + (i,)) for i, v in enumerate(tree))
    return tree


def _float_leaves(tree) -> List[Tuple[Tuple, torch.Tensor]]:
    return [(p, x) for p, x in tree_leaves_with_path(tree) if x.is_floating_point()]


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


class OptState(NamedTuple):
    count: int  # inner (Adam) updates so far
    mu: Dict[Tuple, torch.Tensor]
    nu: Dict[Tuple, torch.Tensor]
    mini_step: int  # MultiSteps micro-step within the current update
    acc: Dict[Tuple, torch.Tensor]  # running mean of the micro-step gradients


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, decay_steps)."""

    def schedule(count: int) -> float:
        if count < warmup_steps:  # linear_schedule(0, peak, warmup_steps)
            return (0.0 - peak) * (1.0 - count / warmup_steps) + peak
        c = min(count - warmup_steps, decay_steps - warmup_steps)
        return peak * (0.5 * (1.0 + math.cos(math.pi * c / (decay_steps - warmup_steps))))

    return schedule


class Optimizer:
    """clip_by_global_norm -> adamw(schedule), frozen leaves set to zero,
    optional gradient accumulation over k micro-steps."""

    def __init__(self, learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 grad_clip: float = 1.0, warmup_steps: int = 100, total_steps: int = 10_000,
                 accumulation_steps: int = 1, trainable_filter=None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = warmup_cosine_decay(learning_rate, warmup_steps,
                                            max(total_steps, warmup_steps + 1))
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.accumulation_steps = accumulation_steps
        self.trainable_filter = trainable_filter
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> OptState:
        f = self.trainable_filter
        zeros = {p: torch.zeros_like(x, dtype=torch.float32) for p, x in _float_leaves(params)
                 if f is None or f(p)}
        return OptState(count=0, mu=zeros, nu={p: z.clone() for p, z in zeros.items()},
                        mini_step=0, acc={p: z.clone() for p, z in zeros.items()})

    def update(self, grads: Dict[Tuple, Optional[torch.Tensor]], state: OptState,
               params, global_sq: Optional[Callable] = None
               ) -> Tuple[Dict[Tuple, torch.Tensor], OptState]:
        """grads maps each trainable path to its gradient (None = zero).
        Returns (new leaf tensors by path, new state); frozen leaves keep
        their tensors. ``global_sq`` maps {path: squares summed over the
        local leaf} to the full tree's squared norm (sharded trees)."""
        with record_function("vv.optimizer"):
            return self._update(grads, state, params, global_sq)

    def _update(self, grads, state: OptState, params, global_sq=None):
        leaves = dict(_float_leaves(params))
        paths = list(state.mu)
        g = {p: (grads.get(p) if grads.get(p) is not None else torch.zeros_like(leaves[p]))
             .float() for p in paths}
        k = self.accumulation_steps
        if k > 1:
            acc = {p: state.acc[p] + (g[p] - state.acc[p]) / (state.mini_step + 1) for p in paths}
            if state.mini_step < k - 1:
                return {}, state._replace(mini_step=state.mini_step + 1, acc=acc)
            g = acc
        if global_sq is not None:
            norm = torch.sqrt(global_sq({p: x.square().sum() for p, x in g.items()}))
        else:
            norm = torch.sqrt(sum((x.square().sum() for x in g.values()),
                                  torch.zeros((), device=next(iter(g.values())).device)))
        if not bool(norm < self.grad_clip):
            g = {p: x / norm * self.grad_clip for p, x in g.items()}
        b1, b2, count = self.b1, self.b2, state.count + 1
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
        lr = self.schedule(state.count)
        mu, nu, new = {}, {}, {}
        for p in paths:
            mu[p] = (1 - b1) * g[p] + b1 * state.mu[p]
            nu[p] = (1 - b2) * g[p].square() + b2 * state.nu[p]
            u = (mu[p] / bc1.item()) / (torch.sqrt(nu[p] / bc2.item()) + self.eps)
            u = u + self.weight_decay * leaves[p].float()
            new[p] = (leaves[p].float() - lr * u).to(leaves[p].dtype)
        zeros = {p: torch.zeros_like(x) for p, x in state.acc.items()} if k > 1 else state.acc
        return new, OptState(count=count, mu=mu, nu=nu, mini_step=0, acc=zeros)


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.01, grad_clip: float = 1.0,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   accumulation_steps: int = 1, trainable_filter=None) -> Optimizer:
    return Optimizer(learning_rate, weight_decay, grad_clip, warmup_steps, total_steps,
                     accumulation_steps, trainable_filter)


class TrainState(NamedTuple):
    params: Dict
    opt_state: OptState
    step: int


def init_train_state(params: Dict, optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------


class Parallel(NamedTuple):
    """A step's layout over a mesh: ``shardings`` of the trainable tree
    (state.params), ``base_shardings`` of a LoRA step's frozen base, and
    the LM hook of GPipe (``parallel.pipeline.make_pp_lm_forward``)."""

    mesh: object
    shardings: Dict
    base_shardings: Optional[Dict] = None
    lm_forward: Optional[Callable] = None

    def layer_specs(self):
        """The LM layers' shardings when FSDP splits them (and no other LM
        forward is set): their gathers then run layer by layer."""
        specs = self.shardings.get("lm", {}).get("layers")
        axes = set(pmesh.data_axes(self.mesh))
        if self.lm_forward is not None or not specs or not any(
                pmesh.shard_axes(spec) & axes for _, spec in _spec_leaves(specs)):
            return None
        return specs

    def groups(self) -> Dict:
        """train_forward's parallel arguments."""
        tp_group = pmesh.axis_group(self.mesh, "tp")
        lm_forward, layer_specs, mesh = self.lm_forward, self.layer_specs(), self.mesh
        if layer_specs is not None:
            def lm_forward(cfg, lm, embeds, valid, remat, remat_policy=None):
                gather = lambda i, lp: gather_for_use(lp, layer_specs[i], mesh)
                return qwen2.forward(cfg, lm, embeds, valid_mask=valid, remat=remat,
                                     remat_policy=remat_policy, tp_group=tp_group,
                                     materialize=gather)[0]
        return dict(dp_group=pmesh.axis_group(self.mesh, pmesh.data_axes(self.mesh)),
                    tp_group=tp_group, lm_forward=lm_forward)


def _spec_leaves(specs, path: Tuple = ()):
    """(path, spec) of every leaf of a tree of shardings."""
    if isinstance(specs, dict):
        return [x for k in specs for x in _spec_leaves(specs[k], path + (k,))]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs) for x in _spec_leaves(v, path + (i,))]
    return [(path, specs)]


def _spec_of(shardings, path: Tuple):
    for k in path:
        shardings = shardings[k]
    return shardings


def gather_for_use(tree, shardings, mesh, skip: Optional[Tuple] = None):
    """The tree with its data-axis (FSDP) splits all-gathered (autograd:
    the gradients are reduce-scattered back onto the shards), but for the
    leaves under the path prefix ``skip``."""
    axes = pmesh.data_axes(mesh)
    new = {}
    for p, x in tree_leaves_with_path(tree):
        if skip is not None and p[:len(skip)] == skip:
            continue
        spec = _spec_of(shardings, p)
        if pmesh.shard_axes(spec) & set(axes):
            new[p] = pmesh.gather_leaf(x, spec, mesh, axes)
    return tree_replace(tree, new) if new else tree


def reduce_grads(grads: Dict, params, shardings, mesh) -> Dict:
    """Sum every gradient over the data group, except those of leaves
    split over a data axis, whose all-gather's backward summed them."""
    axes = pmesh.data_axes(mesh)
    group = pmesh.axis_group(mesh, axes)
    if group is None:
        return grads
    leaves = dict(_float_leaves(params))
    out = {}
    for p, g in grads.items():
        if g is None:  # every rank reaches the same leaves: this one nowhere
            g = torch.zeros_like(leaves[p], dtype=torch.float32)
        if not pmesh.shard_axes(_spec_of(shardings, p)) & set(axes):
            g = g.clone()
            dist.all_reduce(g, group=group)
        out[p] = g
    return out


def global_sq_fn(shardings, mesh) -> Callable:
    """{path: local squares} -> the full tree's squared norm: each leaf's
    share over the ranks holding the same shard, summed over the world."""

    def global_sq(sq: Dict) -> torch.Tensor:
        total = sum(x.float() / pmesh.replicas(_spec_of(shardings, p), mesh)
                    for p, x in sq.items())
        dist.all_reduce(total)
        return total

    return global_sq


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _rng_kwargs(rng) -> Dict:
    """A step's randomness: a torch.Generator, or the explicit Draws."""
    return {"draws": rng} if isinstance(rng, Draws) else {"generator": rng}


def value_and_grad(loss_fn, tree, paths: List[Tuple]):
    """(loss, aux, {path: grad}) of loss_fn(tree) w.r.t. the leaves at `paths`;
    a leaf the loss does not reach gets None."""
    leaves = dict(_float_leaves(tree))
    live = {p: leaves[p].detach().requires_grad_(True) for p in paths}
    loss, aux = loss_fn(tree_replace(tree, live))
    with record_function("vv.backward"):
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss.detach(), aux, dict(zip(live, grads))


def _detach_out(out: TrainOut) -> TrainOut:
    return TrainOut(*(x.detach() for x in out))


def make_train_step(cfg: VibeVoiceConfig, optimizer: Optimizer, opts: TrainOptions = TrainOptions(),
                    trainable_filter=None, parallel: Optional[Parallel] = None):
    """train_step(state, batch, rng) -> (state, TrainOut). Frozen leaves
    (trainable_filter False) get no gradient and no update. ``parallel``:
    state.params and batch are this rank's shards (module docstring)."""
    hcfg = cfg.diffusion_head_config
    noise_schedule = NoiseSchedule.create(hcfg.ddpm_num_steps, hcfg.ddpm_beta_schedule)
    par = {} if parallel is None else parallel.groups()
    layerwise = None if parallel is None or parallel.layer_specs() is None else ("lm", "layers")

    def train_step(state: TrainState, batch: Batch, rng) -> Tuple[TrainState, TrainOut]:
        paths = [p for p, _ in _float_leaves(state.params)
                 if trainable_filter is None or trainable_filter(p)]

        def loss_fn(params):
            if parallel is not None:  # the LM layers' gathers run layer by layer
                params = gather_for_use(params, parallel.shardings, parallel.mesh, layerwise)
            out = train_forward(cfg, params, batch, opts=opts, noise_schedule=noise_schedule,
                                **_rng_kwargs(rng), **par)
            return out.loss, out

        _, out, grads = value_and_grad(loss_fn, state.params, paths)
        global_sq = None
        if parallel is not None:
            grads = reduce_grads(grads, state.params, parallel.shardings, parallel.mesh)
            global_sq = global_sq_fn(parallel.shardings, parallel.mesh)
        new, opt_state = optimizer.update(grads, state.opt_state, state.params, global_sq)
        params = dict(tree_replace(state.params, new))
        # the first-batch speech statistics persist (buffer semantics)
        params["speech_scaling_factor"] = out.speech_scaling_factor
        params["speech_bias_factor"] = out.speech_bias_factor
        return TrainState(params, opt_state, state.step + 1), _detach_out(out)

    return train_step


def build_trainable_filter(
    *,
    freeze_acoustic_tokenizer: bool = True,
    freeze_semantic_tokenizer: bool = True,
    train_connectors: bool = False,
    train_diffusion_head: bool = True,
    head_layers_to_freeze: Tuple[int, ...] = (),
    freeze_embed: bool = True,
    lm_layers_to_freeze: Tuple[int, ...] = (),
):
    """Path filter of the selective freeze/unfreeze options: tokenizers
    frozen by default, connectors and diffusion head opt-in, embeddings and
    the tied lm_head frozen, per-layer freezing of head and LM blocks."""
    head_frozen = set(head_layers_to_freeze)
    lm_frozen = set(lm_layers_to_freeze)

    def trainable(path) -> bool:
        root = path[0]
        if root == "acoustic_tokenizer":
            return not freeze_acoustic_tokenizer
        if root == "semantic_tokenizer":
            return not freeze_semantic_tokenizer
        if root in ("acoustic_connector", "semantic_connector"):
            return train_connectors
        if root == "diffusion_head":
            if not train_diffusion_head:
                return False
            return not (len(path) >= 3 and path[1] == "layers" and path[2] in head_frozen)
        if root in ("speech_scaling_factor", "speech_bias_factor"):
            return False  # buffers
        if root == "lm_head":
            return not freeze_embed
        if root == "lm":
            if len(path) >= 2 and path[1] == "embed":
                return not freeze_embed
            return not (len(path) >= 3 and path[1] == "layers" and path[2] in lm_frozen)
        return True

    return trainable


def make_component_train_step(cfg: VibeVoiceConfig, optimizer: Optimizer,
                              opts: TrainOptions = TrainOptions(),
                              train_keys: Tuple[str, ...] = ("diffusion_head", "acoustic_connector",
                                                             "semantic_connector")):
    """step(state, frozen_params, batch, rng) -> (state, TrainOut), training
    only the listed top-level components (state.params holds just those);
    the frozen rest may be int8. The caller persists the first-batch speech
    statistics from TrainOut, as in the JAX package."""
    del train_keys  # as in the JAX package: the caller builds state.params from these keys
    hcfg = cfg.diffusion_head_config
    noise_schedule = NoiseSchedule.create(hcfg.ddpm_num_steps, hcfg.ddpm_beta_schedule)

    def step(state: TrainState, frozen_params: Dict, batch: Batch, rng):
        def loss_fn(sub):
            out = train_forward(cfg, {**frozen_params, **sub}, batch, opts=opts,
                                noise_schedule=noise_schedule, **_rng_kwargs(rng))
            return out.loss, out

        _, out, grads = value_and_grad(loss_fn, state.params, list(state.opt_state.mu))
        new, opt_state = optimizer.update(grads, state.opt_state, state.params)
        return TrainState(tree_replace(state.params, new), opt_state, state.step + 1), \
            _detach_out(out)

    return step


def make_eval_step(cfg: VibeVoiceConfig, opts: TrainOptions = TrainOptions(),
                   parallel: Optional[Parallel] = None):
    """eval_step(params, batch, rng) -> TrainOut, without gradients
    (``parallel``: params are this rank's shards of the full model, by
    ``parallel.shardings``)."""
    hcfg = cfg.diffusion_head_config
    noise_schedule = NoiseSchedule.create(hcfg.ddpm_num_steps, hcfg.ddpm_beta_schedule)
    par = {} if parallel is None else parallel.groups()
    layerwise = None if parallel is None or parallel.layer_specs() is None else ("lm", "layers")

    def eval_step(params: Dict, batch: Batch, rng) -> TrainOut:
        with torch.no_grad():
            if parallel is not None:
                params = gather_for_use(params, parallel.shardings, parallel.mesh, layerwise)
            return train_forward(cfg, params, batch, opts=opts, noise_schedule=noise_schedule,
                                 **_rng_kwargs(rng), **par)

    return eval_step


def make_lora_grad_fn(cfg: VibeVoiceConfig, lora_cfg, opts: TrainOptions = TrainOptions(),
                      parallel: Optional[Parallel] = None):
    """grad_fn(lora, base_params, batch, rng) -> (loss, TrainOut, {path: grad})
    with the adapters applied to the frozen base inside the loss. Under
    ``parallel`` (shardings: the adapters', base_shardings: the base's) the
    gradients are the global ones."""
    from .lora import apply_lora

    hcfg = cfg.diffusion_head_config
    noise_schedule = NoiseSchedule.create(hcfg.ddpm_num_steps, hcfg.ddpm_beta_schedule)
    par = {} if parallel is None else parallel.groups()

    def grad_fn(lora: Dict, base_params: Dict, batch: Batch, rng):
        def loss_fn(lr):
            base = base_params
            if parallel is not None:
                base = gather_for_use(base, parallel.base_shardings, parallel.mesh)
                lr = gather_for_use(lr, parallel.shardings, parallel.mesh)
            out = train_forward(cfg, apply_lora(base, lr, lora_cfg, par.get("tp_group")), batch,
                                opts=opts, noise_schedule=noise_schedule, **_rng_kwargs(rng),
                                **par)
            return out.loss, out

        loss, out, grads = value_and_grad(loss_fn, lora, [p for p, _ in _float_leaves(lora)])
        if parallel is not None:
            grads = reduce_grads(grads, lora, parallel.shardings, parallel.mesh)
        return loss, _detach_out(out), grads

    return grad_fn


def make_lora_train_step(cfg: VibeVoiceConfig, optimizer: Optimizer, lora_cfg,
                         opts: TrainOptions = TrainOptions(), parallel: Optional[Parallel] = None):
    """lora_step(state, base_params, batch, rng) -> (state, TrainOut):
    gradients reach only the adapter tree (state.params)."""
    grad_fn = make_lora_grad_fn(cfg, lora_cfg, opts, parallel)
    global_sq = None if parallel is None else global_sq_fn(parallel.shardings, parallel.mesh)

    def lora_step(state: TrainState, base_params: Dict, batch: Batch, rng):
        _, out, grads = grad_fn(state.params, base_params, batch, rng)
        new, opt_state = optimizer.update(grads, state.opt_state, state.params, global_sq)
        return TrainState(tree_replace(state.params, new), opt_state, state.step + 1), out

    return lora_step
