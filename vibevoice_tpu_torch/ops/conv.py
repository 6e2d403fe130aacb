"""Causal 1-D convolutions in channels-last (B, T, C) layout
(port of vibevoice_tpu/ops/conv.py).

Weights are in PyTorch's layout: conv ``(C_out, C_in // groups, k)``,
transposed conv ``(C_in, C_out, k)`` (utils/params.from_jax converts the JAX
TIO / pre-flipped layouts). Activations stay (B, T, C) at every public
function. Every convolution sums in float32 and rounds once to the input
dtype; the bias is added in the input dtype, as in the JAX package.

A full-sequence causal conv (``causal_conv1d``: a voice prompt's encode, a
whole-utterance decode) comes at a new length with almost every call, so on
the card it takes no library routine that meets a new shape with each call
(cuDNN plans each shape; cuBLAS, at a shape it has not met, waits for the
work other streams have in flight: beside a prefill, the decode window): a
depthwise conv (one input channel a group: the mixers and the 1-channel
stem) is kernel G, ``depthwise_causal_conv1d`` (csrc/depthwise_conv.cu), a
dense one kernel H, ``dense_causal_conv1d`` (csrc/dense_conv.cu), both
forming the causal pad by index. Kernel H also runs a full sequence's
Block1D FFN linears as kernel-size-1 convs (``pointwise_conv1d``, which
``quant.mm(..., sequence=True)`` calls). On the CPU their plain versions
run. A streaming chunk, which the frame step captures in a CUDA graph at
one shape, and a transposed conv transpose to (B, C, T) around
``F.conv1d`` / ``F.conv_transpose1d``.

Streaming mode carries a fixed-shape context buffer per conv: a zero
initial buffer equals the reference's first-chunk special case.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda


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
    """Full-sequence causal conv, (B, T, C_in) -> (B, ceil(T/stride), C_out):
    kernel G where it is depthwise (``groups`` == C_in) at stride 1,
    kernel H where it is dense (``groups`` 1); dilation 1."""
    k = w.shape[-1]
    padding_total = conv_context_size(k, stride, dilation)
    extra = extra_padding_for_conv1d(x.shape[1], k, stride, padding_total)
    left = padding_total
    if pad_mode not in ("constant", "zero", "zeros"):  # the kernels pad with zeros by index
        x, left, extra = _pad_time(x, padding_total, extra, pad_mode), 0, 0
    t_out = (x.shape[1] + left + extra - dilation * (k - 1) - 1) // stride + 1
    if dilation == 1 and groups == x.shape[-1] and stride == 1:
        return depthwise_causal_conv1d(x, w, b, left=left, t_out=t_out)
    if dilation == 1 and groups == 1:
        return dense_causal_conv1d(x, w, b, stride=stride, left=left, t_out=t_out)
    raise ValueError(f"a full-sequence conv is depthwise (groups == C_in, stride 1) or dense "
                     f"(groups 1), at dilation 1; got groups {groups} over {x.shape[-1]} "
                     f"channels, stride {stride}, dilation {dilation}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def dense_causal_conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
                              stride: int, left: int, t_out: int) -> torch.Tensor:
    """Plain PyTorch version of kernel H, a window-view matmul: x padded
    with ``left`` zero rows (and zero rows on the right as the output
    needs), output t's window, rows t * stride to t * stride + k - 1, an
    overlapping view (B, t_out, C_in, k) of it, and one matmul of every
    window by ``w`` as a (C_in k, C_out) matrix; f32 sums rounded once,
    then the bias in x's dtype."""
    k, cin, cout = w.shape[-1], x.shape[-1], w.shape[0]
    right = max((t_out - 1) * stride + k - left - x.shape[1], 0)
    xp = F.pad(x, (0, 0, left, right)).contiguous()
    t = xp.shape[1]
    win = xp.as_strided((x.shape[0], t_out, cin, k), (t * cin, stride * cin, 1, cin))
    y = torch.matmul(win.reshape(x.shape[0], t_out, cin * k),
                     w.to(x.dtype).reshape(cout, cin * k).t())
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# Kernel H splits K into runs of at most DENSE_SPLIT_K (whole K steps of 16
# and 32) whatever the rows, so an output's sum runs in one order at any
# length: a sample encoded alone, or padded in a batch, gives the same bits.
# The last stages' few rows and long K still fill the card that way.
DENSE_SPLIT_K = 2048


def _dense_plan(kdim: int) -> int:
    """Kernel H's K splits for a product over ``kdim``: by K alone."""
    return -(-kdim // DENSE_SPLIT_K)


def _dense_launch(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *, k: int,
                  stride: int, left: int, t_out: int, w_kn: bool) -> torch.Tensor:
    """Kernel H on CUDA tensors; ``w`` (C_out, C_in, k), or (C_in, C_out)
    where ``w_kn`` (k 1)."""
    cin = x.shape[-1]
    cout = w.shape[1] if w_kn else w.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel H takes f32 or bf16 activations, got {x.dtype}")
    if stride < 1 or left < 0 or t_out < 1 or x.shape[1] < 1:
        raise ValueError(f"kernel H takes stride >= 1, left >= 0 and a non-empty input and "
                         f"output; got stride {stride}, left {left}, {x.shape[1]} rows in, "
                         f"{t_out} out")
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    b = None if b is None else b.to(x.dtype).contiguous()
    _cuda.require_cuda(x, w, *([] if b is None else [b]))
    m = x.shape[0] * t_out
    splits = _dense_plan(cin * k)
    y = torch.empty(x.shape[0], t_out, cout, dtype=x.dtype, device=x.device)
    part = (torch.empty(splits * m * cout, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    _cuda.library().call("vv_dense_conv1d", x.data_ptr(), _cuda.dtype_code(x), w.data_ptr(),
                         int(w_kn), _cuda.ptr(b), y.data_ptr(), _cuda.ptr(part), x.shape[0],
                         x.shape[1], cin, cout, k, stride, left, t_out, splits,
                         _cuda.stream_ptr(x.device))
    dense_causal_conv1d.launches += 1
    return y


def dense_causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
                        stride: int, left: int, t_out: int) -> torch.Tensor:
    """Kernel H: the dense causal conv of (B, T, C_in) ``x`` by ``w``
    (C_out, C_in, k): output t reads rows t * stride - left to
    t * stride - left + k - 1 of x, those outside it as zero (the left pad
    and any right pad, by index). Returns (B, t_out, C_out).

    On CUDA tensors: one launch (two where ``_dense_plan`` splits K), bf16
    on the tensor cores or f32, counted in ``dense_causal_conv1d.launches``;
    the same bits for an output whatever the length of x.
    On the CPU: the plain version. No backward: a call that needs a
    gradient raises."""
    if _needs_grad(x, w, b):
        raise RuntimeError("kernel H (dense_causal_conv1d) has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    cin, cout = x.shape[-1], w.shape[0]
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != cin or (b is not None
                                                              and b.shape != (cout,)):
        raise ValueError(f"kernel H takes x (B, T, C_in), w (C_out, C_in, k) and a bias "
                         f"(C_out,); got x {tuple(x.shape)}, w {tuple(w.shape)}, bias "
                         f"{None if b is None else tuple(b.shape)}")
    if x.device.type == "cpu":
        return dense_causal_conv1d_plain(x, w, b, stride=stride, left=left, t_out=t_out)
    return _dense_launch(x, w, b, k=w.shape[-1], stride=stride, left=left, t_out=t_out,
                         w_kn=False)


def pointwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor]) -> torch.Tensor:
    """A dense linear at every step of a full sequence (B, T, C_in), ``w``
    (C_in, C_out) and an optional bias (C_out,): a kernel-size-1 conv. On a
    CUDA tensor, kernel H, which reads ``w`` in that layout; on the CPU,
    torch.matmul, then the bias. ``quant.mm(..., sequence=True)`` calls it
    for a dense entry."""
    if x.device.type == "cpu":
        y = torch.matmul(x, w.to(x.dtype))
        return y if b is None else y + b.to(y.dtype)
    if _needs_grad(x, w, b):
        raise RuntimeError("kernel H (pointwise_conv1d) has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    return _dense_launch(x, w, b, k=1, stride=1, left=0, t_out=x.shape[1], w_kn=True)


_cuda.count_launches("dense_causal_conv1d", dense_causal_conv1d)


def depthwise_causal_conv1d_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
                                  left: int, t_out: int) -> torch.Tensor:
    """Plain PyTorch version of kernel G: y[:, t, o] = sum over taps j of
    x[:, t - left + j, o // m] * w[o, 0, j] (m = C_out / C_in; rows outside
    x read as zero), summed in f32 in tap order, rounded once to x's dtype;
    then the bias in x's dtype."""
    k, cin, cout = w.shape[-1], x.shape[-1], w.shape[0]
    right = max(t_out + k - 1 - left - x.shape[1], 0)
    xp = F.pad(x, (0, 0, left, right))
    if cout != cin:
        xp = xp.repeat_interleave(cout // cin, dim=-1)
    wf = w[:, 0, :].float()
    acc = xp[:, 0:t_out].float() * wf[:, 0]
    for j in range(1, k):
        acc = acc + xp[:, j: j + t_out].float() * wf[:, j]
    y = acc.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def depthwise_causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
                            left: int, t_out: int) -> torch.Tensor:
    """Kernel G: the depthwise causal conv of (B, T, C_in) ``x`` by ``w``
    (C_out, 1, k), C_out a multiple of C_in, at stride 1: output t reads
    rows t - left to t - left + k - 1 of x, those outside it as zero (the
    left pad and any right pad, by index). Returns (B, t_out, C_out).

    On CUDA tensors: one launch (k 7, f32 or bf16), counted in
    ``depthwise_causal_conv1d.launches``; the same bits as the plain version
    in bf16, where each product is exact in f32. On the CPU: the plain
    version. No backward: a call that needs a gradient raises."""
    if _needs_grad(x, w, b):
        raise RuntimeError("kernel G (depthwise_causal_conv1d) has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    cin, cout, k = x.shape[-1], w.shape[0], w.shape[-1]
    if x.dim() != 3 or w.shape[1] != 1 or cout % cin or (b is not None and b.shape != (cout,)):
        raise ValueError(f"kernel G takes x (B, T, C_in), w (C_out, 1, k) with C_out a "
                         f"multiple of C_in and a bias (C_out,); got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, bias {None if b is None else tuple(b.shape)}")
    if x.device.type == "cpu":
        return depthwise_causal_conv1d_plain(x, w, b, left=left, t_out=t_out)
    if k != 7 or left < 0 or t_out < 1 or x.shape[1] < 1:
        raise ValueError(f"kernel G takes k 7 (the tokenizers' depthwise convs), left >= 0 and a "
                         f"non-empty input and output; got k {k}, left {left}, {x.shape[1]} rows "
                         f"in, {t_out} out")
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    b = None if b is None else b.to(x.dtype).contiguous()
    _cuda.require_cuda(x, w, *([] if b is None else [b]))
    y = torch.empty(x.shape[0], t_out, cout, dtype=x.dtype, device=x.device)
    _cuda.library().call("vv_depthwise_conv1d", x.data_ptr(), _cuda.dtype_code(x), w.data_ptr(),
                         _cuda.ptr(b), y.data_ptr(), x.shape[0], x.shape[1], cin, cout, k, left,
                         t_out, _cuda.stream_ptr(x.device))
    depthwise_causal_conv1d.launches += 1
    return y


_cuda.count_launches("depthwise_causal_conv1d", depthwise_causal_conv1d)


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
