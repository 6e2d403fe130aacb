"""The frame step's share of the chip's bf16 peak: the operations of one
frame at every row the step computes (the LM linears of both CFG streams
of every slot, the token choice, the CFG solve's ddpm_steps head passes,
the vocoder, the semantic re-encode and the connectors of every slot;
attention over the caches left out), from the configuration's shapes, over
the frame step's device time a frame in the profile."""

from bplib import bounds


def read(run):
    t = run.trace
    if t is None or not t.graph_launches():
        return None
    decode = t.decode_streams()
    ns = sum(d for _, _, d, s, _ in t.device if s in decode)
    frames = t.graph_launches() * run.frames_per_dispatch
    flops = bounds.frame_step_flops(run.m, run.max_batch) * frames
    return 100.0 * flops / bounds.BF16_FLOPS / (ns / 1e9)
