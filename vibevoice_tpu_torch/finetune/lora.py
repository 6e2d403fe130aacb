"""LoRA adapters for the parameter tree (port of vibevoice_tpu/finetune/lora.py).

Adapters are a separate tree of low-rank factors, A (IN, r) and B (r, OUT),
with scaling alpha / r. Over a dense base the merged weight
``W + s * A @ B`` is built inside the loss, so gradients reach only the
factors; over an int8 base (QLoRA) the pair attaches as a run-time "lora"
branch of the linear (ops/quant.mm). The saved format is the JAX package's
(a pickle of numpy arrays), so either package loads the other's adapters.
Over a tensor-parallel LM (``tp_group``) each rank merges its shard of the
adapters (``parallel.mesh.lora_param_shardings``) into its weight shard;
the factor it holds whole passes through Megatron's f, so that its
gradient is summed over the group.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import copy_to_group


@dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 32
    target_modules: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
    train_diffusion_head: bool = True
    dropout: float = 0.0  # reserved, as in the JAX package
    # dense connectors trained beside the adapters (kept in lora["extras"])
    train_connectors: bool = False
    # full-rank diffusion head with a LoRA'd LM (no head adapters then)
    full_diffusion_head: bool = False

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def _entry_weight(p: Dict) -> torch.Tensor:
    """The base weight of a linear entry, dense 'w' or int8 'w8' (IN, OUT)."""
    return p["w"] if "w" in p else p["w8"]


def _lora_pair(gen: torch.Generator, w: torch.Tensor, r: int) -> Dict:
    cin, cout = w.shape
    a = torch.randn(cin, r, generator=gen) * (1.0 / max(cin, 1)) ** 0.5
    return {"a": a.to(w.device), "b": torch.zeros(r, cout, device=w.device)}


def copy_tree(tree):
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def init_lora(seed: int, params: Dict, cfg: LoraConfig) -> Dict:
    """Adapters for the LM attention/MLP projections (and the diffusion-head
    FFNs): A ~ N(0, 1/IN), B = 0, f32, drawn from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    lora: Dict = {"lm_layers": []}
    for layer in params["lm"]["layers"]:
        entry: Dict = {}
        for group, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            for name in names:
                if name in cfg.target_modules:
                    entry[name] = _lora_pair(gen, _entry_weight(layer[group][name]), cfg.r)
        lora["lm_layers"].append(entry)
    if cfg.train_diffusion_head and not cfg.full_diffusion_head:
        lora["diffusion_head_layers"] = [
            {name: _lora_pair(gen, layer["ffn"][name]["w"], cfg.r) for name in ("gate", "up", "down")}
            for layer in params["diffusion_head"]["layers"]
        ]
    extras: Dict = {}
    if cfg.train_connectors:
        extras["acoustic_connector"] = copy_tree(params["acoustic_connector"])
        extras["semantic_connector"] = copy_tree(params["semantic_connector"])
    if cfg.train_diffusion_head and cfg.full_diffusion_head:
        extras["diffusion_head"] = copy_tree(params["diffusion_head"])
    if extras:
        lora["extras"] = extras
    return lora


def _merge(w: torch.Tensor, pair: Dict, scaling: float) -> torch.Tensor:
    delta = (pair["a"] @ pair["b"]) * scaling
    return (w.float() + delta).to(w.dtype)


def _apply_entry(p: Dict, pair: Dict, scaling: float, whole: Optional[str] = None,
                 tp_group=None) -> Dict:
    """Dense base: the merged weight. int8 base (QLoRA): the pair as a
    run-time branch beside the int8 matmul. ``whole``: the factor a
    tensor-parallel rank holds unsplit."""
    if whole is not None and tp_group is not None:
        pair = {**pair, whole: copy_to_group(pair[whole], tp_group)}
    if "w8" in p:
        return {**p, "lora": (pair["a"], pair["b"], scaling)}
    return {**p, "w": _merge(p["w"], pair, scaling)}


def apply_lora(params: Dict, lora: Dict, cfg: LoraConfig, tp_group=None) -> Dict:
    """Params with the adapters applied (merged over dense weights, attached
    over int8 ones); the base tree is not modified. ``tp_group``: both trees
    are this rank's tensor-parallel shards (module docstring)."""
    out = dict(params)
    out["lm"] = dict(params["lm"])
    layers = []
    for layer, entry in zip(params["lm"]["layers"], lora["lm_layers"]):
        nl = {**layer, "attn": dict(layer["attn"]), "mlp": dict(layer["mlp"])}
        for group, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            for name in names:
                if name in entry:
                    whole = "b" if name in ("o", "down") else "a"
                    nl[group][name] = _apply_entry(layer[group][name], entry[name], cfg.scaling,
                                                   whole, tp_group)
        layers.append(nl)
    out["lm"]["layers"] = layers

    if "diffusion_head_layers" in lora:
        head = dict(params["diffusion_head"])
        hlayers = []
        for layer, entry in zip(params["diffusion_head"]["layers"], lora["diffusion_head_layers"]):
            nl = {**layer, "ffn": dict(layer["ffn"])}
            for name in ("gate", "up", "down"):
                nl["ffn"][name] = {**layer["ffn"][name],
                                   "w": _merge(layer["ffn"][name]["w"], entry[name], cfg.scaling)}
            hlayers.append(nl)
        head["layers"] = hlayers
        out["diffusion_head"] = head

    for key, value in lora.get("extras", {}).items():
        out[key] = value
    return out


merge_lora = apply_lora  # merging for export is the same materialisation


def to_numpy(tree):
    """The tree with every tensor as a numpy array (f32 for bf16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def to_torch(tree, device=None):
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


def save_lora_assets(path: str, lora: Dict, cfg: LoraConfig, extras: Optional[Dict] = None) -> None:
    """Write the lora/ checkpoint dir of the JAX package: adapters in
    lora_adapters.pkl ({"lora": numpy tree, "config": LoraConfig fields}),
    dense component overrides in extras.pkl."""
    os.makedirs(path, exist_ok=True)
    host = to_numpy(lora)
    if extras is None:
        extras = host.pop("extras", None)
    with open(os.path.join(path, "lora_adapters.pkl"), "wb") as f:
        pickle.dump({"lora": host, "config": dict(cfg.__dict__)}, f)
    if extras:
        with open(os.path.join(path, "extras.pkl"), "wb") as f:
            pickle.dump(to_numpy(extras), f)


def load_lora_assets(params: Dict, path: str) -> Dict:
    """Load adapters (and connector / full-head overrides) written by either
    package and return the params with them applied."""
    lora_dir = os.path.join(path, "lora") if os.path.isdir(os.path.join(path, "lora")) else path
    with open(os.path.join(lora_dir, "lora_adapters.pkl"), "rb") as f:
        blob = pickle.load(f)
    cfg = LoraConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in blob["config"].items()})
    device = params["lm"]["embed"].device
    merged = apply_lora(params, to_torch(blob["lora"], device), cfg)
    extras_path = os.path.join(lora_dir, "extras.pkl")
    if os.path.exists(extras_path):
        with open(extras_path, "rb") as f:
            extras = pickle.load(f)
        for key in ("acoustic_connector", "semantic_connector", "diffusion_head"):
            if key in extras:
                merged[key] = to_torch(extras[key], device)
    return merged
