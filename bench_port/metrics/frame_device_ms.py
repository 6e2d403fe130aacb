"""Device time of the operations on the frame step's stream (the stream
its CUDA graph replays on: the windows, the joins, the noise draws and the
output copies) in the profile, over the frames the windows computed
(replays x frames_per_dispatch)."""


def read(run):
    t = run.trace
    if t is None or not t.graph_launches():
        return None
    decode = t.decode_streams()
    ns = sum(d for _, _, d, s, _ in t.device if s in decode)
    return ns / 1e6 / (t.graph_launches() * run.frames_per_dispatch)
