"""The serving engine's busy slots (``EngineStats.active``: slots decoding
and slots whose last window is still being delivered), sampled every few
ms over the traced stretch, as a share of ``max_batch``."""


def read(run):
    if not run.occupancy:
        return None
    return 100.0 * sum(run.occupancy) / len(run.occupancy) / run.max_batch
