"""Device time of the operations on the prefill worker's stream (every
stream but the frame step's) in the profile, over the prefills it covered:
each prefill counted by the share of its span inside the profile."""


def read(run):
    t = run.trace
    if t is None:
        return None
    decode = t.decode_streams()
    if not decode:
        return None
    ns = sum(d for _, _, d, s, _ in t.device if s not in decode)
    a, b = run.trace_span
    covered = sum(max(0.0, min(e, b) - max(s, a)) / (e - s)
                  for s, e, *_ in run.prefills if e > s)
    return ns / 1e6 / covered if covered >= 0.5 else None
