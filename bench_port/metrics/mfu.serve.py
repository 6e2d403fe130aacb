"""The operations the window's served work needed, over the window's wall
and the chip's bf16 peak: each frame delivered inside the window (LM steps
of both CFG streams, ddpm_steps head passes on both, the vocoder, the
semantic re-encode, the connectors) and each prefill that ended inside it
(the voice prompts' encoder, the LM over the prompt), all from the
configuration's shapes, whatever implements them."""

from bplib import bounds


def read(run):
    w0, w1 = run.window
    frames = []
    for s in run.served:
        plen = len(s.req.input_ids)
        frames += [(plen, j) for j, t in enumerate(s.chunk_times) if w0 <= t < w1]
    prompts = [(n, vf) for a, e, n, vf in run.prefills if w0 <= e < w1]
    if not frames and not prompts:
        return None
    flops = bounds.served_flops(run.m, frames, prompts)
    return 100.0 * flops / bounds.BF16_FLOPS / (w1 - w0)
