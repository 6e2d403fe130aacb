"""Normalization primitives (port of vibevoice_tpu/ops/norms.py).

Both norms accumulate in float32, cast back to the input dtype, then apply
the weight (and bias) in the input dtype, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm over the last axis."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    out = ((xf - mean) * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out
