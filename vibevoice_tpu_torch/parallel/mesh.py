"""Device meshes and sharding rules (port of vibevoice_tpu/parallel/mesh.py).

The JAX package declares NamedShardings and lets XLA insert the
collectives; the port runs one process per rank and holds plain local
shards. A sharding here is the JAX PartitionSpec as a tuple: one entry per
leading dimension of a leaf, each None (not split), a mesh dimension's name
or a tuple of names (split over their product, the first outermost); a leaf
with fewer entries than dimensions is not split on the rest. The rules are
the JAX package's:

* ``qwen2_param_shardings``: the TP plan of the LM (the reference's
  colwise/rowwise table): q/k/v/gate/up split their output columns (with
  the q/k/v biases), o/down their input rows; the embedding, the norms and
  an untied lm_head are replicated;
* ``model_param_shardings``: the LM by that plan, everything else
  (tokenizers, connectors, diffusion head) replicated;
* ``fsdp_param_shardings``: ZeRO-3 on top, every leaf of at least
  ``min_leaf_size`` elements split over the data axis on its largest
  dimension that TP left whole and the axis size divides;
* ``batch_shardings``: a batch's leading dimension over the data axes
  (("dcn", "dp") on a hybrid mesh, "dp" otherwise).

``shard_params`` cuts this rank's local tree out of a full one,
``gather_params`` puts the full tree back together on every rank (the
pickle checkpoints). The collectives are explicit ``torch.distributed``
calls (``collectives``); ``axis_group`` gives the process group of one or
more mesh dimensions.

The caller initialises the default process group (NCCL on the card, gloo on
the CPU: address, world size, rank); a mesh spans every rank of it.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import collectives as coll

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]
REPLICATED: Spec = ()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _init(shape: Tuple[int, ...], names: Tuple[str, ...]) -> DeviceMesh:
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        dims = " x ".join(f"{s} ({a})" for s, a in zip(shape, names))
        raise ValueError(f"a {dims} mesh needs a world of {n} ranks, not {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def free_port() -> int:
    """A free TCP port on this host, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def make_mesh(dp: int = 1, tp: int = 1) -> DeviceMesh:
    """A DeviceMesh with dims ("dp", "tp") over every rank of the default
    process group, whose world size must be dp * tp. It holds CUDA devices
    when the group's backend is NCCL and CPU devices otherwise."""
    return _init((dp, tp), ("dp", "tp"))


def make_hybrid_mesh(dcn: int = 1, dp: int = 1, tp: int = 1) -> DeviceMesh:
    """The multi-host mesh, dims ("dcn", "dp", "tp"): "dcn" is the slow
    axis between hosts and carries only data parallelism (the batch and the
    speech statistics); "dp" and "tp" stay within a host. Ranks are laid out
    row-major, so with torchrun's host-major ranks a "dcn" index is a host."""
    return _init((dcn, dp, tp), ("dcn", "dp", "tp"))


def data_axes(mesh: DeviceMesh) -> tuple:
    """The mesh dimensions a batch's leading dim shards over (dcn first, then dp)."""
    return tuple(a for a in ("dcn", "dp") if a in mesh.mesh_dim_names)


def axis_size(mesh: Optional[DeviceMesh], axes) -> int:
    if mesh is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes:
        if a in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh: DeviceMesh, axes) -> int:
    """This rank's index along the product of ``axes`` (the first outermost)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    coords = mesh.get_coordinate()
    idx = 0
    for a in axes:
        if a in mesh.mesh_dim_names:
            d = mesh.mesh_dim_names.index(a)
            idx = idx * mesh.size(d) + coords[d]
    return idx


def axis_group(mesh: Optional[DeviceMesh], axes):
    """The process group of this rank along ``axes`` (a name or a tuple of
    names); None when the mesh is None. A tuple's groups are created once
    per mesh (kept on it), by every rank in the same order
    (``dist.new_group``)."""
    if mesh is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in groups:
        names = mesh.mesh_dim_names
        ranks = mesh.mesh.permute(*[names.index(a) for a in names if a not in axes],
                                  *[names.index(a) for a in axes])
        ranks = ranks.reshape(-1, axis_size(mesh, axes))
        mine = None
        for row in ranks.tolist():
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        groups[axes] = mine
    return groups[axes]


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _check_heads(lm_params: Dict, head_dim: int, tp: int) -> None:
    attn = lm_params["layers"][0]["attn"]
    nh = attn["q"]["w"].shape[1] // head_dim
    kh = attn["k"]["w"].shape[1] // head_dim
    if nh % tp or kh % tp:
        raise ValueError(f"tensor parallelism of {tp} needs it to divide both the {nh} query "
                         f"heads and the {kh} KV heads")


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)) and not hasattr(t, "_fields"):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in x)


def _spec_map(fn, tree, specs):
    """fn(leaf, spec) over a tree and its matching tree of specs."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return type(tree)(_spec_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def qwen2_param_shardings(lm_params: Dict, mesh: Optional[DeviceMesh] = None,
                          head_dim: Optional[int] = None) -> Dict:
    """The TP plan of the LM. With a mesh (and the head_dim), a "tp" size
    that does not divide both head counts raises ValueError."""
    if mesh is not None and head_dim is not None:
        _check_heads(lm_params, head_dim, axis_size(mesh, "tp"))
    col_w, col_b, row_w = (None, "tp"), ("tp",), ("tp", None)

    def linear(p, w_spec, b_spec=REPLICATED):
        return {k: (w_spec if k == "w" else b_spec if k == "b" else REPLICATED) for k in p}

    def layer(lp):
        a, m = lp["attn"], lp["mlp"]
        return {
            "input_norm": {"w": REPLICATED},
            "attn": {"q": linear(a["q"], col_w, col_b), "k": linear(a["k"], col_w, col_b),
                     "v": linear(a["v"], col_w, col_b), "o": linear(a["o"], row_w)},
            "post_norm": {"w": REPLICATED},
            "mlp": {"gate": linear(m["gate"], col_w), "up": linear(m["up"], col_w),
                    "down": linear(m["down"], row_w)},
        }

    out = _tree_map(lambda _: REPLICATED, {k: v for k, v in lm_params.items() if k != "layers"})
    out["layers"] = [layer(lp) for lp in lm_params["layers"]]
    return out


def model_param_shardings(params: Dict, mesh: Optional[DeviceMesh] = None,
                          head_dim: Optional[int] = None) -> Dict:
    """The composite model: the LM by the TP plan, everything else replicated."""
    out = _tree_map(lambda _: REPLICATED, params)
    out["lm"] = qwen2_param_shardings(params["lm"], mesh, head_dim)
    return out


def lora_param_shardings(lora: Dict) -> Dict:
    """The adapters over a TP-sharded LM: B (r, OUT) splits its columns
    under q/k/v/gate/up, A (IN, r) its rows under o/down; the other factor,
    the head's adapters and the extras are replicated."""
    out = _tree_map(lambda _: REPLICATED, lora)
    for entry, spec in zip(lora["lm_layers"], out["lm_layers"]):
        for name in entry:
            if name in ("o", "down"):
                spec[name]["a"] = ("tp", None)
            else:
                spec[name]["b"] = (None, "tp")
    return out


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def fsdp_param_shardings(params: Dict, mesh: DeviceMesh, *, axis: str = "dp",
                         min_leaf_size: int = 1 << 16, base: Optional[Dict] = None,
                         head_dim: Optional[int] = None) -> Dict:
    """ZeRO-3 on top of ``base`` (default: ``model_param_shardings``): every
    leaf of at least ``min_leaf_size`` elements additionally splits, over
    ``axis``, its largest dimension that is not split already and that the
    axis size divides; smaller leaves keep the base layout. Parameters and
    the AdamW moments made from them are stored so."""
    if base is None:
        base = model_param_shardings(params, mesh, head_dim)
    n = axis_size(mesh, axis)
    if n == 1:
        return base

    def upgrade(p, spec):
        if _numel(p) < min_leaf_size:
            return spec
        spec = list(spec) + [None] * (p.ndim - len(spec))
        cands = [i for i in range(p.ndim) if spec[i] is None and p.shape[i] % n == 0]
        if not cands:
            return tuple(spec)
        i = max(cands, key=lambda j: p.shape[j])
        spec[i] = axis
        return tuple(spec)

    return _spec_map(upgrade, params, base)


def batch_shardings(mesh: DeviceMesh, batch_tree):
    """Every batch leaf's leading dim over the data axes."""
    spec = (data_axes(mesh),)
    if isinstance(batch_tree, tuple) and hasattr(batch_tree, "_fields"):
        return type(batch_tree)(*(spec for _ in batch_tree))
    return _tree_map(lambda _: spec, batch_tree)


def _split(x, spec: Spec, mesh: DeviceMesh):
    if not isinstance(x, torch.Tensor):
        return x
    x0 = x
    for dim, axes in enumerate(spec):
        n = 1 if axes is None else axis_size(mesh, axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split {n} ways "
                             f"over {axes}")
        x = x.chunk(n, dim=dim)[axis_index(mesh, axes)]
    # a copy even where the slice is contiguous: a view would keep the
    # whole tensor's memory alive
    return x.clone(memory_format=torch.contiguous_format) if x is not x0 else x


def shard_params(params, shardings, mesh: DeviceMesh):
    """This rank's local tree: each split leaf cut by its sharding (a copy);
    replicated leaves are the full tree's own tensors."""
    return _spec_map(lambda x, s: _split(x, s, mesh), params, shardings)


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of a batch (a NamedTuple or tree of arrays/tensors):
    the leading dim split over the data axes."""
    axes = data_axes(mesh)
    n, i = axis_size(mesh, axes), axis_index(mesh, axes)

    def cut(x):
        if x is None:
            return None
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {n} data shards")
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]

    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(cut(x) for x in batch))
    return _tree_map(cut, batch)


def _join(x, spec: Spec, mesh: DeviceMesh):
    if not isinstance(x, torch.Tensor):
        return x
    for dim in reversed(range(len(spec))):
        if spec[dim] is not None:
            x = coll.all_gather_dim(x, dim, axis_group(mesh, spec[dim]))
    return x


def gather_params(params, shardings, mesh: DeviceMesh):
    """The full tree on every rank (a collective: every rank calls it)."""
    with torch.no_grad():
        return _spec_map(lambda x, s: _join(x, s, mesh), params, shardings)


def gather_leaf(x: torch.Tensor, spec: Spec, mesh: Optional[DeviceMesh], axes: Sequence[str]):
    """x with its splits over ``axes`` undone (an autograd all-gather: the
    gradient is reduce-scattered back onto the shard); splits over other
    axes stay."""
    if mesh is None:
        return x
    for dim in reversed(range(len(spec))):
        e = spec[dim]
        if e is not None and (e in axes if isinstance(e, str) else set(e) <= set(axes)):
            x = coll.all_gather_dim(x, dim, axis_group(mesh, e))
    return x


def replicas(spec: Spec, mesh: Optional[DeviceMesh]) -> int:
    """How many ranks of the world hold each shard of a leaf so split."""
    if mesh is None:
        return 1
    n = mesh.size()
    for e in spec:
        if e is not None:
            n //= axis_size(mesh, e)
    return n


def shard_axes(spec: Spec) -> set:
    out = set()
    for e in spec:
        if e is not None:
            out |= {e} if isinstance(e, str) else set(e)
    return out
