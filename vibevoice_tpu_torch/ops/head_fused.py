"""Kernel C: the diffusion head's AdaLN-FFN stack for one denoise call
(port of vibevoice_tpu/ops/head_fused.py).

Per layer: RMSNorm * w -> ``h * (1 + scale) + shift`` with the hoisted
modulations -> SwiGLU FFN -> ``x += gate * ffn``. The FFN weights may be
int8 (per-column scales). The AdaLN weights stay outside (they are read once
per frame by diffusion_head.precompute_mods).

On a CUDA tensor ``fused_head_ffn_stack`` launches the hand-written kernels
(csrc/head_ffn.cu); on a CPU tensor it runs ``fused_head_ffn_stack_plain``.
Both hold the modulated input and the SwiGLU output in the activation dtype,
as the TPU kernel's scratch does.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import _cuda
from .vocoder_fused import PackedStage


def pack_head_ffns(layers: List[Dict], eps: float, quantize: bool = False) -> PackedStage:
    """Stack the head layers' norm + FFN params into kernel-ready tensors."""
    nb = len(layers)
    dim = layers[0]["norm"]["w"].shape[0]
    hid = layers[0]["ffn"]["gate"]["w"].shape[1]
    arrays = {"norm_w": torch.stack([l["norm"]["w"] for l in layers]).float()}
    wg = torch.stack([l["ffn"]["gate"]["w"] for l in layers])  # (L, H, F)
    wu = torch.stack([l["ffn"]["up"]["w"] for l in layers])
    wd = torch.stack([l["ffn"]["down"]["w"] for l in layers])  # (L, F, H)
    if quantize:
        from .quant import quantize_weight

        for name, w in (("wg", wg), ("wu", wu), ("wd", wd)):
            qs = [quantize_weight(w[i]) for i in range(nb)]
            arrays[name + "_q"] = torch.stack([q["w8"] for q in qs])
            arrays[name + "_scale"] = torch.stack([q["scale"] for q in qs])
    else:
        arrays["wg"], arrays["wu"], arrays["wd"] = wg, wu, wd
    return PackedStage(arrays, float(eps), dim, hid, nb, bool(quantize))


def fused_head_ffn_stack_plain(packed: PackedStage, x: torch.Tensor, mods: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C. x (B, H), mods (L, B, 3H)."""
    dt, dim = x.dtype, packed.dim
    y = x
    for i in range(packed.n_blocks):
        xf = y.float()
        h = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + packed.eps) * packed["norm_w"][i]
        m = mods[i].float()
        shift, scale, gate = m[:, :dim], m[:, dim: 2 * dim], m[:, 2 * dim:]
        hmod = (h * (1.0 + scale) + shift).to(dt).float()
        (wg, sg), (wu, su), (wd, sd) = (packed.weight(n, i) for n in ("wg", "wu", "wd"))
        u = torch.matmul(hmod, wg.float())
        v = torch.matmul(hmod, wu.float())
        if sg is not None:
            u, v = u * sg, v * su
        g = (F.silu(u) * v).to(dt).float()
        d = torch.matmul(g, wd.float())
        if sd is not None:
            d = d * sd
        y = (xf + gate * d).to(dt)
    return y


def fused_head_ffn_stack(packed: PackedStage, x: torch.Tensor, mods: torch.Tensor) -> torch.Tensor:
    """Run all L AdaLN-FFN layers on one denoise step. x (B, H) post-noisy_proj
    activations, mods (L, B, 3H) shift|scale|gate in x's dtype. Returns (B, H)."""
    if x.device.type == "cpu":
        return fused_head_ffn_stack_plain(packed, x, mods)
    nb, dim, hid = packed.n_blocks, packed.dim, packed.hidden
    rows = x.shape[0]
    if x.shape != (rows, dim) or mods.shape != (nb, rows, 3 * dim) or mods.dtype != x.dtype:
        raise ValueError(f"x {tuple(x.shape)} / mods {tuple(mods.shape)} {mods.dtype} do not "
                         f"fit a {nb}-layer head of width {dim}")
    if dim % 4 or hid % 4:
        raise ValueError("the kernel reads 4 columns at once: widths must be multiples of 4")
    a = packed.arrays
    names = ("wg_q", "wu_q", "wd_q") if packed.quantized else ("wg", "wu", "wd")
    ws_ = [a[n] for n in names]
    scales = ([a["wg_scale"], a["wu_scale"], a["wd_scale"]] if packed.quantized
              else [None, None, None])
    mods = mods.contiguous()
    _cuda.require_cuda(x, mods, a["norm_w"], *ws_, *[s for s in scales if s is not None])
    y = torch.empty(rows, dim, dtype=x.dtype, device=x.device)
    y.copy_(x)
    split_gu, kps_gu = _cuda.split_k(rows, dim, hid)
    split_d, kps_d = _cuda.split_k(rows, hid, dim)
    f32 = dict(dtype=torch.float32, device=x.device)
    hmod, gbuf = torch.empty(rows, dim, **f32), torch.empty(rows, hid, **f32)
    ws = torch.empty(max(2 * split_gu * rows * hid, split_d * rows * dim), **f32)
    _cuda.library().call(
        "vv_fused_head_ffn_stack", y.data_ptr(), _cuda.dtype_code(x), mods.data_ptr(),
        a["norm_w"].data_ptr(), *[w.data_ptr() for w in ws_], _cuda.dtype_code(ws_[0]),
        *[_cuda.ptr(s) for s in scales], hmod.data_ptr(), gbuf.data_ptr(), ws.data_ptr(),
        nb, rows, dim, hid, packed.eps, split_gu, kps_gu, split_d, kps_d,
        _cuda.stream_ptr(x.device),
    )
    fused_head_ffn_stack.launches += 1
    return y


fused_head_ffn_stack.launches = 0
