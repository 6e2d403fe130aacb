"""Kernel A in the frame step: the least time of every int8 LM linear at
the rows the step computes it for (both CFG streams of every slot), times
the frames computed, at the chip's peaks, over the device time of kernel
A's entries on the frame step's stream. The LM head is not among them: the
frame step reads its four candidate columns with a plain matmul."""

from bplib import bounds

# kernel A's three routes (vibevoice_tpu_torch/csrc): the streaming GEMV,
# the split-K tensor-core GEMM (its x by TMA), the 256-row GEMM
ROUTES = (("stream_gemv_kernel", "XRoundBf16"), ("int8_gemm_sk_kernel", "XTma"),
          ("int8_gemm_kernel", ""))


def is_kernel_a(name):
    return any(a in name and b in name for a, b in ROUTES)


def read(run):
    t = run.trace
    if t is None or not t.graph_launches():
        return None
    decode = t.decode_streams()
    ns = sum(d for n, _, d, s, _ in t.device if s in decode and is_kernel_a(n))
    if not ns:
        return None
    frames = t.graph_launches() * run.frames_per_dispatch
    least = bounds.least_seconds(*bounds.lm_frame(run.m, 2 * run.max_batch)) * frames
    return 100.0 * least / (ns / 1e9)
