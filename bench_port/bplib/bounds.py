"""The chip's peaks, and the bytes and operations that the served work
needs, computed from a configuration's shapes alone (never from the
program's kernels), for the rooflines and the model-FLOP utilisation.

Peaks: one NVIDIA H100 SXM (the data sheet, dense): 3.35 TB/s of HBM,
989 TFLOP/s bf16 on the tensor cores. A roofline share is the least time
(the larger of bytes over the bandwidth and operations over the peak)
over the measured time. Each input byte is counted read once and each
output byte written once.
"""

from __future__ import annotations

from typing import List, Tuple

from . import spec as sp

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def lm_linears(m: sp.Model) -> List[Tuple[int, int]]:
    """(in, out) of one layer's seven linears."""
    h, kvw, i = m.hidden, m.kv_heads * m.head_dim, m.inter
    return [(h, h), (h, kvw), (h, kvw), (h, h), (h, i), (h, i), (i, h)]


def int8_linear(cin: int, cout: int, rows: int, act_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, flops) of rows x (cin -> cout) on an int8 weight with f32
    per-column scales: the weight and scales read once, x read, y written."""
    nbytes = cin * cout + 4 * cout + act_bytes * rows * (cin + cout)
    return float(nbytes), 2.0 * rows * cin * cout


def lm_frame(m: sp.Model, rows: int) -> Tuple[float, float]:
    """(bytes, flops) of kernel A's work in one frame step: every int8 LM
    linear at ``rows`` rows (both CFG streams of every slot)."""
    b = f = 0.0
    for cin, cout in lm_linears(m):
        nb, nf = int8_linear(cin, cout, rows)
        b, f = b + nb * m.layers, f + nf * m.layers
    return b, f


def head_call(m: sp.Model, rows: int) -> Tuple[float, float]:
    """(bytes, flops) of one call of the diffusion head's FFN stack (kernel
    C): per layer gate|up (hidden -> 2 ffn) and down (ffn -> hidden) int8
    with scales; x read and written f32, each layer's modulation read f32."""
    hh, ff, n = m.head_hidden, m.head_ffn, m.head_layers
    w = n * (hh * 2 * ff + 4 * 2 * ff + ff * hh + 4 * hh)
    act = 4 * rows * hh * 2 + 4 * rows * n * 3 * hh
    return float(w + act), 2.0 * rows * n * (hh * 2 * ff + ff * hh)


def _lm_tokens_flops(m: sp.Model, ctx0: int, count: int) -> float:
    """``count`` tokens through the LM, the first attending ``ctx0`` keys
    and each next one more."""
    params = sum(a * b for a, b in lm_linears(m))
    keys = count * ctx0 + count * (count - 1) / 2
    return m.layers * (2.0 * params * count + 4.0 * keys * m.heads * m.head_dim)


def coder_flops(c: sp.Coder, decoder: bool) -> float:
    """Operations of one frame (``hop`` samples) through a σ-VAE encoder
    or decoder: its convolutions, transposed convolutions and ConvNeXt
    blocks at each stage's rate."""
    n = len(c.depths)
    hop = c.hop
    flops = 0.0
    for i in range(n):
        if decoder:
            rate = 1
            for r in c.ratios[:i]:
                rate *= r
        else:
            rate = hop
            for r in c.ratios[:i]:
                rate //= r
        dim = c.dims[i]
        if i == 0:
            flops += 2.0 * rate * dim * c.in_ch * 7
        elif decoder:  # transposed conv over the previous stage's samples
            s = c.ratios[i - 1]
            flops += 2.0 * (rate // s) * c.dims[i - 1] * dim * 2 * s
        else:
            s = c.ratios[i - 1]
            flops += 2.0 * rate * c.dims[i - 1] * dim * 2 * s
        flops += c.depths[i] * rate * (2.0 * dim * 7 + 2.0 * 2 * dim * 4 * dim)
    last = 1 if not decoder else hop
    return flops + 2.0 * last * c.dims[-1] * c.out_ch * 7


def frame_flops(m: sp.Model, prompt_len: int, j: int) -> float:
    """Operations that frame j of a request (prompt of ``prompt_len``
    tokens) needs: token choice, the CFG solve (ddpm_steps head passes on
    the two streams), the vocoder and the semantic re-encode, the two
    connectors, one LM step of each CFG stream."""
    return _frame_fixed(m) + _lm_tokens_flops(m, prompt_len + j + 1, 1) \
        + _lm_tokens_flops(m, j + 2, 1)


def _frame_fixed(m: sp.Model) -> float:
    hh, ff, lat, steps = m.head_hidden, m.head_ffn, m.latent, int(m.bench["ddpm_steps"])
    h = m.hidden
    head_mods = 2 * (2 * hh * hh) + steps * 2 * (256 * hh + hh * hh) \
        + steps * 2 * 2 * (m.head_layers * hh * 3 * hh + hh * 2 * hh)
    head_pass = 2 * 2 * (lat * hh + m.head_layers * (hh * 2 * ff + ff * hh) + hh * lat)
    conn = 2 * (lat * h + h * h) + 2 * (m.semantic_dim * h + h * h)
    return (2.0 * h * len(sp.CANDIDATES) + head_mods + steps * head_pass
            + coder_flops(m.ac_dec, True) + coder_flops(m.se_enc, False) + conn)


def frame_step_flops(m: sp.Model, slots: int) -> float:
    """Operations of one frame step at every row it computes: each slot's
    frame without the LM (``_frame_fixed``) and the LM linears of both CFG
    streams of every slot (attention over the caches left out)."""
    params = sum(a * b for a, b in lm_linears(m))
    return slots * _frame_fixed(m) + 2 * slots * m.layers * 2.0 * params


def prompt_flops(m: sp.Model, prompt_len: int, voice_frames: int) -> float:
    """Operations of a request's prefill: the voice prompts through the
    acoustic encoder and its connector, the prompt through the LM (causal:
    token t attends t + 1 keys) and the negative stream's one token."""
    h = m.hidden
    voice = voice_frames * (coder_flops(m.ac_enc, False) + 2 * (m.latent * h + h * h))
    return _lm_tokens_flops(m, 1, prompt_len) + _lm_tokens_flops(m, 1, 1) + voice


def served_flops(m: sp.Model, frames: List[Tuple[int, int]],
                 prompts: List[Tuple[int, int]]) -> float:
    """frames: (prompt_len, frame index) of each frame delivered; prompts:
    (prompt_len, voice frames) of each prefill."""
    return (sum(frame_flops(m, plen, j) for plen, j in frames)
            + sum(prompt_flops(m, plen, vf) for plen, vf in prompts))
