"""Weight-only int8 quantization, kernel A (the dequantizing matmul) and
kernel E (its activation gradient) (port of vibevoice_tpu/ops/quant.py).

Layout as in the JAX package: w8 (IN, OUT) int8 with per-output-column f32
scales (OUT,); w = w8 * scale. ``quantize_weight`` does the same f32
``max|w| / 127``, division and round-half-even as the JAX version, so the
int8 tensors and scales are bit-equal.

``int8_matmul`` on a CUDA tensor launches the hand-written kernel
(csrc/int8_matmul.cu, which replaces the Pallas TPU kernel
vibevoice_tpu/ops/quant.py:129). On a CPU tensor it runs
``int8_matmul_plain``, the same function in plain PyTorch. Unlike the TPU
port, every shape takes the kernel (no 512-divisibility gate).

``int8_matmul_t`` is the backward w.r.t. x, dx = bf16(g * scale) @ w8^T: on
a CUDA tensor kernel E (csrc/int8_matmul_t.cu, replacing the Pallas TPU
kernel vibevoice_tpu/ops/quant.py:220), on a CPU tensor
``int8_matmul_t_plain``. ``mm`` routes every int8 linear whose input needs a
gradient through ``Int8MatmulDx``, the autograd Function with kernel A
forward and kernel E backward (the JAX custom VJP ``_int8_matmul_dx``); the
int8 weights and scales are frozen and get no gradient.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import _cuda


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w (IN, OUT) float -> {'w8': int8 (IN, OUT), 'scale': (OUT,) f32}."""
    wf = w.float()
    scale = wf.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w8": wq.contiguous(), "scale": scale}


def int8_matmul_plain(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A: bf16-rounded x, f32 sum, scale after."""
    y = torch.matmul(x.to(torch.bfloat16).float(), w8.float()) * scale.float()
    return y.to(x.dtype)


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = x @ (w8 * scale) for x (..., IN); the output has x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w8, scale)
    cin, cout = w8.shape
    x2 = x.reshape(-1, cin).contiguous()
    _cuda.require_cuda(x2, w8, scale)
    if w8.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != (cout,):
        raise ValueError(f"expected int8 w8 and f32 scale ({cout},), got {w8.dtype} "
                         f"{tuple(w8.shape)} and {scale.dtype} {tuple(scale.shape)}")
    if cout % 4 or w8.data_ptr() % 4:
        raise ValueError(f"the kernel reads 4 int8 columns at once: OUT={cout} must be a "
                         "multiple of 4 and w8 4-byte aligned")
    rows = x2.shape[0]
    out = torch.empty(rows, cout, dtype=x.dtype, device=x.device)
    splits, kps = _cuda.split_k(rows, cin, cout)
    ws = torch.empty(splits, rows, cout, dtype=torch.float32, device=x.device)
    _cuda.library().call(
        "vv_int8_matmul", x2.data_ptr(), _cuda.dtype_code(x2), w8.data_ptr(), scale.data_ptr(),
        out.data_ptr(), ws.data_ptr(), rows, cin, cout, splits, kps, _cuda.stream_ptr(x.device),
    )
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], cout)


int8_matmul.launches = 0


def int8_matmul_t_plain(g: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E: g * scale rounded to bf16, f32 sum
    against w8^T, output in g's dtype."""
    gs = (g.float() * scale.float()).to(torch.bfloat16).float()
    return torch.matmul(gs, w8.float().t()).to(g.dtype)


def int8_matmul_t(g: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dx = g @ (w8 * scale)^T for g (..., OUT); the output has g's dtype."""
    if g.device.type == "cpu":
        return int8_matmul_t_plain(g, w8, scale)
    cin, cout = w8.shape
    g2 = g.reshape(-1, cout).contiguous()
    _cuda.require_cuda(g2, w8, scale)
    if w8.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != (cout,):
        raise ValueError(f"expected int8 w8 and f32 scale ({cout},), got {w8.dtype} "
                         f"{tuple(w8.shape)} and {scale.dtype} {tuple(scale.shape)}")
    rows = g2.shape[0]
    out = torch.empty(rows, cin, dtype=g.dtype, device=g.device)
    if rows:
        _cuda.library().call(
            "vv_int8_matmul_t", g2.data_ptr(), _cuda.dtype_code(g2), w8.data_ptr(),
            scale.data_ptr(), out.data_ptr(), rows, cin, cout, _cuda.stream_ptr(g.device),
        )
        int8_matmul_t.launches += 1
    return out.reshape(*g.shape[:-1], cin)


int8_matmul_t.launches = 0


class Int8MatmulDx(torch.autograd.Function):
    """y = int8_matmul(x, w8, scale) with the gradient w.r.t. x only:
    kernel A forward, kernel E backward. w8 and scale are frozen (QLoRA):
    they get no gradient, and asking for one is not an error."""

    @staticmethod
    def forward(ctx, x, w8, scale):
        ctx.save_for_backward(w8, scale)
        return int8_matmul(x, w8, scale)

    @staticmethod
    def backward(ctx, g):
        w8, scale = ctx.saved_tensors
        return int8_matmul_t(g, w8, scale), None, None


def quantize_lm(lm_params: Dict) -> Dict:
    """Quantize the Qwen2 linears in place of their 'w' entries; biases,
    norms and embeddings stay as they are."""
    out = dict(lm_params)
    layers = []
    for layer in lm_params["layers"]:
        nl = {**layer, "attn": dict(layer["attn"]), "mlp": dict(layer["mlp"])}
        for group, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
            for name in names:
                p = dict(layer[group][name])
                p.update(quantize_weight(p.pop("w")))
                nl[group][name] = p
        layers.append(nl)
    out["layers"] = layers
    return out


def mm(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """Linear apply on a dense ('w') or int8 ('w8' + 'scale') entry, plus bias.

    A "lora" entry (A (IN, r), B (r, OUT), scaling), as finetune/lora.py
    attaches it over an int8 base, adds the low-rank branch at run time:
    y += ((x @ A) @ B) * s, so gradients reach A and B while the int8 base
    stays frozen (QLoRA)."""
    if "w8" in p:
        if x.requires_grad and torch.is_grad_enabled():
            y = Int8MatmulDx.apply(x, p["w8"], p["scale"])
        else:
            y = int8_matmul(x, p["w8"], p["scale"])
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    if "lora" in p:
        a, b, s = p["lora"]
        y = y + torch.matmul(torch.matmul(x, a.to(x.dtype)), b.to(x.dtype)) * s
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
