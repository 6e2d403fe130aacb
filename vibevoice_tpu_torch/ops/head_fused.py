"""Kernel C: the diffusion head's AdaLN-FFN stack for one denoise call
(port of vibevoice_tpu/ops/head_fused.py).

Per layer: RMSNorm * w -> ``h * (1 + scale) + shift`` with the hoisted
modulations -> SwiGLU FFN -> ``x += gate * ffn``. The FFN weights may be
int8 (per-column scales). The AdaLN weights stay outside (they are read once
per frame by diffusion_head.precompute_mods).

On a CUDA tensor ``fused_head_ffn_stack`` launches a hand-written kernel,
two launches a layer (gate|up then down, with the norm and modulation fused
into the first one's loader and SwiGLU into the second's), by one of two
routes chosen by rows alone (``_route``): with int8 weights from
``TC_MIN_ROWS`` to ``TC_MAX_ROWS`` rows (the serving engine's batched rows)
the split-K tensor-core core csrc/splitk_core.cuh (csrc/head_ffn_tc.cu;
plans ``_tc_plan``), f32 activations as three bf16 terms; otherwise (1-2
rows at bs1, dense weights) the weight-streaming core csrc/weight_stream.cuh
(csrc/head_ffn.cu; plans ``_plan``). On a CPU tensor it runs
``fused_head_ffn_stack_plain``. Both hold the modulated input and the
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


def _check_widths(dim: int, hid: int) -> None:
    if dim % 16 or hid % 16:
        raise ValueError(f"the kernel reads 16-byte vectors of 16 columns: the head's width "
                         f"({dim}) and FFN width ({hid}) must be multiples of 16")


def _plan(rows: int, dim: int, hid: int, wbytes: int):
    """The launch plans of a layer's two streaming passes, gate|up (dim ->
    2 hid) and down (hid -> dim), from the shapes alone: (rows per block,
    splits, k per split) each, as quant._gemv_plan gives them. The kernel
    reads 16-byte vectors of whole columns: widths must be multiples of 16."""
    _check_widths(dim, hid)
    return (quant._gemv_plan(rows, dim, 2 * hid, wbytes),
            quant._gemv_plan(rows, hid, dim, wbytes))


# Kernel C's route by rows alone (int8 weights; dense ones always stream):
# the split-K tensor-core core (csrc/head_ffn_tc.cu) from TC_MIN_ROWS to
# TC_MAX_ROWS rows (three bf16 terms of f32 activations fill one 256-row
# tile at 85), the weight-streaming core (csrc/head_ffn.cu) below and above.
# chip_smoke.py's sweep (phase 15; an H100 SXM at 700 W; a call of 4 int8
# layers, f32 x, ms streaming / split-K): the 1.5B 0.0836 / 0.0869 at 1 row,
# 0.1041 / 0.0862 at 2, 0.1353 / 0.0962 at 3, 0.2401 / 0.1168 at 8, 0.6202 /
# 0.2608 at 32; the 7B 0.2727 / 0.2606 at 1, 0.3483 / 0.2726 at 2, 0.8459 /
# 0.3196 at 8. The split-K route wins from 2 rows; the 2 rows of bs1 with
# CFG stay on the streaming core all the same, with their bits and their
# kernel's place on the bs1 path (ROADMAP lists the move).
TC_MIN_ROWS = 3
TC_MAX_ROWS = quant.SK_FUSED_MAX_ROWS


def _route(rows: int, quantized: bool) -> str:
    """"tc" (the split-K tensor-core core) or "stream" for a call of
    ``rows`` rows."""
    return "tc" if quantized and TC_MIN_ROWS <= rows <= TC_MAX_ROWS else "stream"


def _tc_plan(rows: int, dim: int, hid: int, terms: int):
    """The launch plans of a layer's two passes on the split-K core, gate|up
    and down: (row tile, splits, k per split) each, as quant._sk_fused_plan
    gives them for ``terms`` bf16 terms a value (3 for f32 activations, 1
    for bf16)."""
    _check_widths(dim, hid)
    return (quant._sk_fused_plan(rows, dim, 2 * hid, terms),
            quant._sk_fused_plan(rows, hid, dim, terms))


def fused_head_ffn_stack(packed: PackedStage, x: torch.Tensor, mods: torch.Tensor) -> torch.Tensor:
    """Run all L AdaLN-FFN layers on one denoise step. x (B, H) post-noisy_proj
    activations, mods (L, B, 3H) shift|scale|gate in x's dtype. Returns (B, H).

    On CUDA tensors: 2L launches, nothing allocated but the output (the
    u|v sums and split-K partials live in quant's persistent workspace), so
    a call can be captured in a CUDA graph after one call outside it.
    Counted in ``fused_head_ffn_stack.launches`` (the streaming core) or
    ``.launches_tc`` (the split-K tensor-core core)."""
    if x.device.type == "cpu":
        return fused_head_ffn_stack_plain(packed, x, mods)
    return _launch(packed, x, mods, _route(x.shape[0], packed.quantized))


def _launch(packed: PackedStage, x: torch.Tensor, mods: torch.Tensor, route: str) -> torch.Tensor:
    """Kernel C on CUDA tensors by ``route`` ("tc" needs int8 weights)."""
    nb, dim, hid = packed.n_blocks, packed.dim, packed.hidden
    rows = x.shape[0]
    if x.shape != (rows, dim) or mods.shape != (nb, rows, 3 * dim) or mods.dtype != x.dtype:
        raise ValueError(f"x {tuple(x.shape)} / mods {tuple(mods.shape)} {mods.dtype} do not "
                         f"fit a {nb}-layer head of width {dim}")
    a = packed.arrays
    wgu, wd = (a["wgu_q"], a["wd_q"]) if packed.quantized else (a["wgu"], a["wd"])
    scales = [a["wgu_scale"], a["wd_scale"]] if packed.quantized else [None, None]
    wb = wgu.element_size()
    tc = route == "tc"
    if tc and not packed.quantized:
        raise ValueError("the split-K tensor-core route takes int8 weights only")
    terms = 3 if x.dtype == torch.float32 else 1
    gu, dn = _tc_plan(rows, dim, hid, terms) if tc else _plan(max(rows, 1), dim, hid, wb)
    x, mods = x.contiguous(), mods.contiguous()
    if tc:  # the split-K core's loader reads 16-byte vectors of both
        x, mods = (t.clone() if t.data_ptr() % 16 else t for t in (x, mods))
    _cuda.require_cuda(x, mods, a["norm_w"], wgu, wd, *[s for s in scales if s is not None])
    if wgu.data_ptr() % 16 or wd.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: the packed weights must be "
                         "16-byte aligned")
    y = torch.empty(rows, dim, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    if tc:  # then u|v (rows, 2 hid)
        n_part, n_tiles = quant._sk_fused_workspace(rows, terms, ((gu, 2 * hid), (dn, dim)))
    else:
        n_part = max(gu[1] * rows * 2 * hid, dn[1] * rows * dim)
        n_tiles = max(quant._gemv_tiles(rows, 2 * hid, gu[0], wb),
                      quant._gemv_tiles(rows, dim, dn[0], wb))
    ws, counters = quant._gemv_workspace(x.device, n_part + rows * 2 * hid, n_tiles)
    common = (y.data_ptr(), x.data_ptr(), _cuda.dtype_code(x), mods.data_ptr(),
              a["norm_w"].data_ptr(), wgu.data_ptr(), wd.data_ptr())
    tail = (ws.data_ptr() + 4 * n_part, ws.data_ptr(), counters.data_ptr(), nb, rows, dim, hid,
            packed.eps, *gu, *dn, _cuda.stream_ptr(x.device))
    if tc:
        _cuda.library().call("vv_fused_head_ffn_stack_tc", *common,
                             *[_cuda.ptr(s) for s in scales], *tail)
        fused_head_ffn_stack.launches_tc += 1
    else:
        _cuda.library().call("vv_fused_head_ffn_stack", *common, _cuda.dtype_code(wgu),
                             *[_cuda.ptr(s) for s in scales], *tail)
        fused_head_ffn_stack.launches += 1
    return y


_cuda.count_launches("fused_head_ffn_stack", fused_head_ffn_stack)
_cuda.count_launches("fused_head_ffn_stack_tc", fused_head_ffn_stack, "launches_tc")
