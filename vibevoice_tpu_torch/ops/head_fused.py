"""Kernel C: the diffusion head's AdaLN-FFN stack for one denoise call
(port of vibevoice_tpu/ops/head_fused.py).

Per layer: RMSNorm * w -> ``h * (1 + scale) + shift`` with the hoisted
modulations -> SwiGLU FFN -> ``x += gate * ffn``. The FFN weights may be
int8 (per-column scales). The AdaLN weights stay outside (they are read once
per frame by diffusion_head.precompute_mods).

On a CUDA tensor ``fused_head_ffn_stack`` launches the hand-written kernel
(csrc/head_ffn.cu: two launches a layer of the streaming core
csrc/weight_stream.cuh, gate|up then down, with the norm and modulation fused
into the first one's loader and SwiGLU into the second's); on a CPU tensor it
runs ``fused_head_ffn_stack_plain``. Both hold the modulated input and the
SwiGLU output in the activation dtype, as the TPU kernel's scratch does. The
pack lays the gate and up weights side by side, one (L, H, 2F) matrix
(``wgu``, or int8 ``wgu_q`` with (L, 2F) ``wgu_scale``), so that one pass
streams both; the per-column scales are those of the two matrices quantized
apart.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import _cuda, quant
from .vocoder_fused import PackedStage


def pack_head_ffns(layers: List[Dict], eps: float, quantize: bool = False) -> PackedStage:
    """Stack the head layers' norm + FFN params into kernel-ready tensors:
    norm_w (L, H) f32, the gate and up weights side by side (L, H, 2F), down
    (L, F, H); int8 with per-column scales if ``quantize``."""
    nb = len(layers)
    dim = layers[0]["norm"]["w"].shape[0]
    hid = layers[0]["ffn"]["gate"]["w"].shape[1]
    arrays = {"norm_w": torch.stack([l["norm"]["w"] for l in layers]).float()}
    wgu = torch.stack([torch.cat([l["ffn"]["gate"]["w"], l["ffn"]["up"]["w"]], dim=1)
                       for l in layers])  # (L, H, 2F)
    wd = torch.stack([l["ffn"]["down"]["w"] for l in layers])  # (L, F, H)
    if quantize:
        for name, w in (("wgu", wgu), ("wd", wd)):
            qs = [quant.quantize_weight(w[i]) for i in range(nb)]
            arrays[name + "_q"] = torch.stack([q["w8"] for q in qs])
            arrays[name + "_scale"] = torch.stack([q["scale"] for q in qs])
    else:
        arrays["wgu"], arrays["wd"] = wgu, wd.contiguous()
    return PackedStage(arrays, float(eps), dim, hid, nb, bool(quantize))


def fused_head_ffn_stack_plain(packed: PackedStage, x: torch.Tensor, mods: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C. x (B, H), mods (L, B, 3H)."""
    dt, dim, hid = x.dtype, packed.dim, packed.hidden
    y = x
    for i in range(packed.n_blocks):
        xf = y.float()
        h = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + packed.eps) * packed["norm_w"][i]
        m = mods[i].float()
        shift, scale, gate = m[:, :dim], m[:, dim: 2 * dim], m[:, 2 * dim:]
        hmod = (h * (1.0 + scale) + shift).to(dt).float()
        (wgu, sgu), (wd, sd) = packed.weight("wgu", i), packed.weight("wd", i)
        uv = torch.matmul(hmod, wgu.float())
        if sgu is not None:
            uv = uv * sgu
        g = (F.silu(uv[:, :hid]) * uv[:, hid:]).to(dt).float()
        d = torch.matmul(g, wd.float())
        if sd is not None:
            d = d * sd
        y = (xf + gate * d).to(dt)
    return y


def _plan(rows: int, dim: int, hid: int, wbytes: int):
    """The launch plans of a layer's two streaming passes, gate|up (dim ->
    2 hid) and down (hid -> dim), from the shapes alone: (rows per block,
    splits, k per split) each, as quant._gemv_plan gives them. The kernel
    reads 16-byte vectors of whole columns: widths must be multiples of 16."""
    if dim % 16 or hid % 16:
        raise ValueError(f"the kernel reads 16-byte vectors of 16 columns: the head's width "
                         f"({dim}) and FFN width ({hid}) must be multiples of 16")
    return (quant._gemv_plan(rows, dim, 2 * hid, wbytes),
            quant._gemv_plan(rows, hid, dim, wbytes))


def fused_head_ffn_stack(packed: PackedStage, x: torch.Tensor, mods: torch.Tensor) -> torch.Tensor:
    """Run all L AdaLN-FFN layers on one denoise step. x (B, H) post-noisy_proj
    activations, mods (L, B, 3H) shift|scale|gate in x's dtype. Returns (B, H).

    On CUDA tensors: 2L launches, nothing allocated but the output (the
    u|v sums and split-K partials live in quant's persistent workspace), so
    a call can be captured in a CUDA graph after one call outside it."""
    if x.device.type == "cpu":
        return fused_head_ffn_stack_plain(packed, x, mods)
    nb, dim, hid = packed.n_blocks, packed.dim, packed.hidden
    rows = x.shape[0]
    if x.shape != (rows, dim) or mods.shape != (nb, rows, 3 * dim) or mods.dtype != x.dtype:
        raise ValueError(f"x {tuple(x.shape)} / mods {tuple(mods.shape)} {mods.dtype} do not "
                         f"fit a {nb}-layer head of width {dim}")
    a = packed.arrays
    wgu, wd = (a["wgu_q"], a["wd_q"]) if packed.quantized else (a["wgu"], a["wd"])
    scales = [a["wgu_scale"], a["wd_scale"]] if packed.quantized else [None, None]
    wb = wgu.element_size()
    gu, dn = _plan(max(rows, 1), dim, hid, wb)
    x, mods = x.contiguous(), mods.contiguous()
    _cuda.require_cuda(x, mods, a["norm_w"], wgu, wd, *[s for s in scales if s is not None])
    if wgu.data_ptr() % 16 or wd.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: the packed weights must be "
                         "16-byte aligned")
    y = torch.empty(rows, dim, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    n_part = max(gu[1] * rows * 2 * hid, dn[1] * rows * dim)  # then u|v (rows, 2 hid)
    ws, counters = quant._gemv_workspace(
        x.device, n_part + rows * 2 * hid,
        max(quant._gemv_tiles(rows, 2 * hid, gu[0], wb), quant._gemv_tiles(rows, dim, dn[0], wb)))
    _cuda.library().call(
        "vv_fused_head_ffn_stack", y.data_ptr(), x.data_ptr(), _cuda.dtype_code(x),
        mods.data_ptr(), a["norm_w"].data_ptr(), wgu.data_ptr(), wd.data_ptr(),
        _cuda.dtype_code(wgu), *[_cuda.ptr(s) for s in scales], ws.data_ptr() + 4 * n_part,
        ws.data_ptr(), counters.data_ptr(), nb, rows, dim, hid, packed.eps, *gu, *dn,
        _cuda.stream_ptr(x.device),
    )
    fused_head_ffn_stack.launches += 1
    return y


_cuda.count_launches("fused_head_ffn_stack", fused_head_ffn_stack)
