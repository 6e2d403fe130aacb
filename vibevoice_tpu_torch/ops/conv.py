"""Causal 1-D convolutions in channels-last (B, T, C) layout
(port of vibevoice_tpu/ops/conv.py).

Weights are in PyTorch's layout: conv ``(C_out, C_in // groups, k)``,
transposed conv ``(C_in, C_out, k)`` (utils/params.from_jax converts the JAX
TIO / pre-flipped layouts). Activations stay (B, T, C) at every public
function; each op transposes to (B, C, T) around ``F.conv1d`` /
``F.conv_transpose1d``. The convolution sums in float32 and rounds once to
the input dtype; the bias is added in the input dtype, as in the JAX package.

Streaming mode carries a fixed-shape context buffer per conv: a zero
initial buffer equals the reference's first-chunk special case.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv_context_size(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """Streaming context (= causal left pad) of a causal conv."""
    return (kernel_size - 1) * dilation - (stride - 1)


def conv_transpose_context_size(kernel_size: int) -> int:
    return kernel_size - 1


def extra_padding_for_conv1d(length: int, kernel_size: int, stride: int, padding_total: int) -> int:
    """Right pad so every input sample is consumed."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal - length


def _pad_time(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the time axis of (B, T, C), with the reference's small-input
    reflect workaround."""
    if left == 0 and right == 0:
        return x
    if mode in ("constant", "zero", "zeros"):
        return F.pad(x, (0, 0, left, right))
    length = x.shape[1]
    extra = 0
    if mode == "reflect" and length <= max(left, right):
        extra = max(left, right) - length + 1
        x = F.pad(x, (0, 0, 0, extra))
    tmode = {"reflect": "reflect", "replicate": "replicate"}[mode]
    padded = F.pad(x.transpose(1, 2), (left, right), mode=tmode).transpose(1, 2)
    if extra:
        padded = padded[:, : padded.shape[1] - extra, :]
    return padded


def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *, stride: int,
          dilation: int, groups: int) -> torch.Tensor:
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype), None, stride=stride, dilation=dilation,
                 groups=groups).transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def causal_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Full-sequence causal conv, (B, T, C_in) -> (B, ceil(T/stride), C_out)."""
    k = w.shape[-1]
    padding_total = conv_context_size(k, stride, dilation)
    extra = extra_padding_for_conv1d(x.shape[1], k, stride, padding_total)
    x = _pad_time(x, padding_total, extra, pad_mode)
    return _conv(x, w, b, stride=stride, dilation=dilation, groups=groups)


def causal_conv1d_streaming(
    x: torch.Tensor,
    state: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming chunk; ``state`` is (B, ctx, C_in). Returns (y, new_state):
    the conv over [state, x] with no padding, and the trailing ctx samples of
    that concatenation."""
    ctx = state.shape[1]
    full = torch.cat([state, x], dim=1) if ctx > 0 else x
    y = _conv(full, w, b, stride=stride, dilation=dilation, groups=groups)
    new_state = full[:, full.shape[1] - ctx:, :] if ctx > 0 else state
    return y, new_state


def conv_transpose1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    stride: int,
    causal: bool = True,
    trim_right_ratio: float = 1.0,
) -> torch.Tensor:
    """Full-sequence transposed conv, (B, T, C_in) -> (B, T*stride, C_out),
    trimmed as the reference's SConvTranspose1d (padding_total = k - stride)."""
    k = w.shape[-1]
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), None, stride=stride).transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    padding_total = k - stride
    if causal:
        pad_r = math.ceil(padding_total * trim_right_ratio)
        pad_l = padding_total - pad_r
    else:
        pad_r = padding_total // 2
        pad_l = padding_total - pad_r
    if pad_l or pad_r:
        y = y[:, pad_l: y.shape[1] - pad_r, :]
    return y


def conv_transpose1d_streaming(
    x: torch.Tensor,
    state: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    *,
    stride: int,
    trim_right_ratio: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming chunk of causal transposed conv; ``state`` is (B, k-1,
    C_in) of trailing input frames. Keeps the last T*stride output samples."""
    k = w.shape[-1]
    t_new = x.shape[1]
    full = torch.cat([state, x], dim=1)
    y = conv_transpose1d(full, w, b, stride=stride, causal=True, trim_right_ratio=trim_right_ratio)
    y = y[:, y.shape[1] - t_new * stride:, :]
    new_state = full[:, full.shape[1] - (k - 1):, :]
    return y, new_state
