"""Kernel C in the frame step: the least time of the diffusion head's
AdaLN SwiGLU stack at the rows it runs (both CFG rows of every slot),
ddpm_steps calls a frame, times the frames computed, at the chip's peaks,
over the device time of kernel C's entries on the frame step's stream."""

from bplib import bounds

# kernel C's loaders and epilogues (vibevoice_tpu_torch/csrc/head_ffn.cuh),
# on the streaming core and on the split-K tensor-core core
MARKS = ("XHeadMod", "XSwiGLU", "EpiGatedResidual")


def read(run):
    t = run.trace
    if t is None or not t.graph_launches():
        return None
    decode = t.decode_streams()
    ns = sum(d for n, _, d, s, _ in t.device if s in decode and any(k in n for k in MARKS))
    if not ns:
        return None
    calls = t.graph_launches() * run.frames_per_dispatch * int(run.m.bench["ddpm_steps"])
    least = bounds.least_seconds(*bounds.head_call(run.m, 2 * run.max_batch)) * calls
    return 100.0 * least / (ns / 1e9)
