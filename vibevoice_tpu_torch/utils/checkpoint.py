"""Sharded training-state checkpoints over ``torch.distributed.checkpoint``
(port of vibevoice_tpu/utils/checkpoint.py).

The JAX package writes orbax checkpoints; the port writes
``torch.distributed.checkpoint`` (DCP) directories instead, which the
trainer's ``--checkpoint_format orbax`` selects. The two formats are not
interchangeable: orbax cannot read these directories, nor this module
orbax's.

Every rank holds plain local shards by the shardings of
``parallel.mesh`` (a JAX PartitionSpec as a tuple per leaf). A save wraps
each shard as a DTensor of its mesh (``Shard(dim)`` along each split,
``Replicate`` elsewhere), so each rank writes only the shards it owns
(replicated leaves once) and the directory holds the global tensors; a
restore reads into the target's layout, which may differ from the saved
one. Without a mesh the leaves are whole tensors. Trees may hold dicts
(any keys), lists, tuples, NamedTuples, tensors and plain Python values.
Every rank calls these functions, on a path they all see.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.distributed.checkpoint as dcp

from ..parallel.mesh import REPLICATED, Spec, _is_spec, axis_size


def _flatten(tree, specs, prefix: str, out: Dict):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, specs[k] if isinstance(specs, dict) else specs, f"{prefix}/{k!r}", out)
    elif isinstance(tree, (list, tuple)):
        if isinstance(specs, (list, tuple)) and not _is_spec(specs):
            for i, (v, s) in enumerate(zip(tree, specs)):
                _flatten(v, s, f"{prefix}/{i}", out)
        else:
            for i, v in enumerate(tree):
                _flatten(v, specs, f"{prefix}/{i}", out)
    else:
        out[prefix] = (tree, specs if _is_spec(specs) else REPLICATED)


def _placements(spec: Spec, mesh):
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            if a in mesh.mesh_dim_names:
                out[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return out


def _state_dict(tree, mesh, shardings) -> Dict[str, Any]:
    """{name: DTensor (sharded leaf), tensor or value}."""
    from torch.distributed.tensor import DTensor

    flat: Dict = {}
    _flatten(tree, shardings if shardings is not None else REPLICATED, "", flat)
    out = {}
    for name, (x, spec) in flat.items():
        if isinstance(x, torch.Tensor) and mesh is not None and any(e is not None for e in spec):
            shape = list(x.shape)
            for dim, axes in enumerate(spec):
                if axes is not None:
                    shape[dim] *= axis_size(mesh, axes)
            x = DTensor.from_local(x, mesh, _placements(spec, mesh), run_check=False,
                                   shape=torch.Size(shape), stride=_stride(shape))
        out[name] = x
    return out


def _stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _rebuild(tree, values: Dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}/{k!r}") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, values, f"{prefix}/{i}") for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}/{i}") for i, v in enumerate(tree))
    return values[prefix]


def save_train_state(path: str, state: Any, mesh=None, shardings=None) -> None:
    """Save a tree (a TrainState, or any tree) as a DCP directory; each rank
    writes its own shards. ``shardings`` mirrors the tree (a subtree's
    single spec covers it all; default: replicated)."""
    dcp.save(_state_dict(state, mesh, shardings), checkpoint_id=os.path.abspath(path))


def restore_train_state(path: str, target: Any, mesh=None, shardings=None) -> Any:
    """The saved tree read into the structure, shapes and local layout of
    ``target`` (its tensors are overwritten in place and returned)."""
    flat: Dict = {}
    _flatten(target, shardings if shardings is not None else REPLICATED, "", flat)
    sd = _state_dict(target, mesh, shardings)
    dcp.load(sd, checkpoint_id=os.path.abspath(path))
    values = {}
    for k, v in sd.items():
        if hasattr(v, "to_local"):  # a DTensor of a CPU mesh holds a host copy
            v = flat[k][0].copy_(v.to_local())
        values[k] = v
    return _rebuild(target, values)


def save_params_sharded(path: str, params: Any, mesh=None, shardings=None) -> None:
    """Save a (possibly sharded) parameter tree: each rank writes the shards
    it owns, so no rank ever holds the whole model; every rank calls it."""
    save_train_state(path, params, mesh, shardings)


def restore_params_sharded(path: str, like: Any, mesh=None, shardings=None) -> Any:
    """Read parameters directly into this rank's layout: each rank reads
    only its shards. ``like`` gives the local shapes and dtypes (it is
    overwritten), ``shardings`` its layout."""
    return restore_train_state(path, like, mesh, shardings)
