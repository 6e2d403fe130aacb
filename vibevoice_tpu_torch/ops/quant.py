"""Weight-only int8 quantization and kernel A, the dequantizing matmul
(port of vibevoice_tpu/ops/quant.py).

Layout as in the JAX package: w8 (IN, OUT) int8 with per-output-column f32
scales (OUT,); w = w8 * scale. ``quantize_weight`` does the same f32
``max|w| / 127``, division and round-half-even as the JAX version, so the
int8 tensors and scales are bit-equal.

``int8_matmul`` on a CUDA tensor launches the hand-written kernel
(csrc/int8_matmul.cu, which replaces the Pallas TPU kernel
vibevoice_tpu/ops/quant.py:129). On a CPU tensor it runs
``int8_matmul_plain``, the same function in plain PyTorch. Unlike the TPU
port, every shape takes the kernel (no 512-divisibility gate).
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
    x2 = x.reshape(-1, cin)
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
    """Linear apply on a dense ('w') or int8 ('w8' + 'scale') entry, plus bias."""
    if "w8" in p:
        y = int8_matmul(x, p["w8"], p["scale"])
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
