"""EMA of the diffusion head (port of vibevoice_tpu/finetune/ema.py): f32
shadow weights updated after each optimizer update and swapped in for
export."""

from __future__ import annotations

from typing import Dict

import torch


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees) if isinstance(t0, torch.Tensor) else t0


def init_ema(head_params: Dict) -> Dict:
    return _map(lambda x: x.detach().float().clone(), head_params)


def update_ema(ema: Dict, head_params: Dict, decay: float = 0.999) -> Dict:
    return _map(lambda e, p: decay * e + (1.0 - decay) * p.detach().float(), ema, head_params)


def swap_in_ema(params: Dict, ema: Dict) -> Dict:
    out = dict(params)
    leaves = []
    _map(lambda x: leaves.append(x), params["diffusion_head"])
    dtype = leaves[0].dtype
    out["diffusion_head"] = _map(lambda e: e.to(dtype), ema)
    return out
