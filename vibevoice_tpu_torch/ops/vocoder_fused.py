"""Kernel D: one T=1 frame through a whole Block1D stack (the vocoder hot
stage; port of vibevoice_tpu/ops/vocoder_fused.py).

Per block: RMSNorm -> depthwise k=7 conv over 6 carried frames (the state
shifts) -> layer-scale residual -> RMSNorm -> fc1 + b1 -> exact GELU ->
fc2 + b2 -> layer-scale residual. The FFN weights may be int8.

On a CUDA tensor ``fused_stage_step`` launches the hand-written kernels
(csrc/vocoder_stage.cu: per block a prologue launch, then fc1 and fc2 as two
launches of the streaming core csrc/weight_stream.cuh with the bias, GELU,
layer scale and residual in their epilogues); on a CPU tensor it runs
``fused_stage_step_plain``.
Both keep the TPU kernel's rounding points: the FFN input and the GELU
output in the activation dtype, the mid-block residual in f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import _cuda, quant

CTX = 6  # depthwise kernel 7 -> 6 carried frames
_VECTORS = ("norm_w", "conv_w", "conv_b", "gamma", "ffn_norm_w", "b1", "b2", "ffn_gamma")


class PackedStage:
    """Stacked per-block params of a fused stack. Small per-channel vectors
    are stored f32 (both versions upcast them anyway); the FFN weights keep
    the model dtype, or are int8 with per-column scales."""

    def __init__(self, arrays: Dict[str, torch.Tensor], eps: float, dim: int, hidden: int,
                 n_blocks: int, quantized: bool):
        self.arrays = arrays
        self.eps = eps
        self.dim = dim
        self.hidden = hidden
        self.n_blocks = n_blocks
        self.quantized = quantized

    def __getitem__(self, k):
        return self.arrays[k]

    def weight(self, name: str, i: int) -> Tuple[torch.Tensor, torch.Tensor | None]:
        """Layer i's weight ``name`` (dense or int8) and its scale (None if dense)."""
        if self.quantized:
            return self.arrays[name + "_q"][i], self.arrays[name + "_scale"][i]
        return self.arrays[name][i], None


def pack_stage(blocks: List[Dict], eps: float, quantize: bool = False) -> PackedStage:
    """Stack a stage's Block1D params (depthwise k=7 mixers, biases and
    layer-scale gammas present, as in every shipped config)."""
    nb = len(blocks)
    dim = blocks[0]["norm"]["w"].shape[0]
    hid = blocks[0]["ffn"]["fc1"]["w"].shape[1]

    def stack(get):
        return torch.stack([get(b) for b in blocks])

    arrays = {
        "norm_w": stack(lambda b: b["norm"]["w"]),
        # torch depthwise layout (C, 1, 7) -> (7, C)
        "conv_w": stack(lambda b: b["mixer"]["w"][:, 0, :].T),
        "conv_b": stack(lambda b: b["mixer"]["b"]),
        "gamma": stack(lambda b: b["gamma"]),
        "ffn_norm_w": stack(lambda b: b["ffn_norm"]["w"]),
        "b1": stack(lambda b: b["ffn"]["fc1"]["b"]),
        "b2": stack(lambda b: b["ffn"]["fc2"]["b"]),
        "ffn_gamma": stack(lambda b: b["ffn_gamma"]),
    }
    arrays = {k: v.float().contiguous() for k, v in arrays.items()}
    w1 = stack(lambda b: b["ffn"]["fc1"]["w"])  # (NB, C, H)
    w2 = stack(lambda b: b["ffn"]["fc2"]["w"])  # (NB, H, C)
    if quantize:
        for name, w in (("w1", w1), ("w2", w2)):
            qs = [quant.quantize_weight(w[i]) for i in range(nb)]
            arrays[name + "_q"] = torch.stack([q["w8"] for q in qs])
            arrays[name + "_scale"] = torch.stack([q["scale"] for q in qs])
    else:
        arrays["w1"], arrays["w2"] = w1.contiguous(), w2.contiguous()
    return PackedStage(arrays, float(eps), dim, hid, nb, bool(quantize))


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def fused_stage_step_plain(
    packed: PackedStage, x: torch.Tensor, states: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel D. x (B, 1, C), states (NB, B, 6, C)."""
    dt, eps = x.dtype, packed.eps
    a = packed.arrays
    y = x[:, 0, :]
    new_states = []
    for i in range(packed.n_blocks):
        xf = y.float()
        h = _rms(xf, a["norm_w"][i], eps)
        st = states[i]
        conv = h * a["conv_w"][i, CTX]
        for t in range(CTX):
            conv = conv + st[:, t, :].float() * a["conv_w"][i, t]
        new_states.append(torch.cat([st[:, 1:, :], h.to(st.dtype)[:, None, :]], dim=1))
        xmid = xf + (conv + a["conv_b"][i]) * a["gamma"][i]
        hn = _rms(xmid, a["ffn_norm_w"][i], eps).to(dt).float()
        w1, s1 = packed.weight("w1", i)
        u = torch.matmul(hn, w1.float())
        u = (u * s1 if s1 is not None else u) + a["b1"][i]
        g = F.gelu(u, approximate="none").to(dt).float()
        w2, s2 = packed.weight("w2", i)
        d = torch.matmul(g, w2.float())
        d = (d * s2 if s2 is not None else d) + a["b2"][i]
        y = (xmid + d * a["ffn_gamma"][i]).to(dt)
    return y[:, None, :], torch.stack(new_states)


def _plan(rows: int, dim: int, hid: int, wbytes: int):
    """The launch plans of a block's two streaming passes, fc1 (dim -> hid)
    and fc2 (hid -> dim), from the shapes alone: (rows per block, splits, k
    per split) each, as quant._gemv_plan gives them. The kernel reads 16-byte
    vectors of whole columns: widths must be multiples of 16."""
    if dim % 16 or hid % 16:
        raise ValueError(f"the kernel reads 16-byte vectors of 16 columns: the stage's width "
                         f"({dim}) and FFN width ({hid}) must be multiples of 16")
    return quant._gemv_plan(rows, dim, hid, wbytes), quant._gemv_plan(rows, hid, dim, wbytes)


def fused_stage_step(
    packed: PackedStage, x: torch.Tensor, states: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the packed stack on one frame. x (B, 1, C), states (NB, B, 6, C);
    returns (y (B, 1, C), new_states (NB, B, 6, C)).

    On CUDA tensors: 3 launches a block, nothing allocated but the outputs
    (xmid, hn, g and the split-K partials live in quant's persistent
    workspace), so a call can be captured in a CUDA graph after one call
    outside it."""
    if x.device.type == "cpu":
        return fused_stage_step_plain(packed, x, states)
    nb, dim, hid = packed.n_blocks, packed.dim, packed.hidden
    b = x.shape[0]
    if x.shape != (b, 1, dim) or states.shape != (nb, b, CTX, dim) or states.dtype != x.dtype:
        raise ValueError(f"x {tuple(x.shape)} / states {tuple(states.shape)} {states.dtype} do "
                         f"not fit a {nb}-block stack of width {dim}")
    a = packed.arrays
    w1, w2 = (a["w1_q"], a["w2_q"]) if packed.quantized else (a["w1"], a["w2"])
    scales = [a["w1_scale"], a["w2_scale"]] if packed.quantized else [None, None]
    wb = w1.element_size()
    p1, p2 = _plan(max(b, 1), dim, hid, wb)
    vecs = [a[k] for k in _VECTORS]
    x, states = x.contiguous(), states.contiguous()
    _cuda.require_cuda(x, states, w1, w2, *vecs, *[s for s in scales if s is not None])
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: the packed weights must be "
                         "16-byte aligned")
    y = torch.empty(b, 1, dim, dtype=x.dtype, device=x.device)
    new_states = torch.empty_like(states)
    if b == 0:
        return y, new_states
    n_part = max(p1[1] * b * hid, p2[1] * b * dim)
    ws, counters = quant._gemv_workspace(
        x.device, n_part + b * (2 * dim + hid),
        max(quant._gemv_tiles(b, hid, p1[0], wb), quant._gemv_tiles(b, dim, p2[0], wb)))
    xmid = ws.data_ptr() + 4 * n_part  # then hn (B, C) and g (B, H), all f32
    # C-side StageVectors order: the 8 vectors, then the two scales
    ptrs = (ctypes.c_void_p * 10)(*[_cuda.ptr(t) for t in vecs + scales])
    _cuda.library().call(
        "vv_fused_stage_step", y.data_ptr(), x.data_ptr(), _cuda.dtype_code(x), states.data_ptr(),
        new_states.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), w1.data_ptr(), w2.data_ptr(),
        _cuda.dtype_code(w1), xmid, xmid + 4 * b * dim, xmid + 8 * b * dim, ws.data_ptr(),
        counters.data_ptr(), nb, b, dim, hid, packed.eps, *p1, *p2, _cuda.stream_ptr(x.device),
    )
    fused_stage_step.launches += 1
    return y, new_states


_cuda.count_launches("fused_stage_step", fused_stage_step)
