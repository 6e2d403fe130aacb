"""Process start to the first request of the window: weights, set-up,
kernel build (first run of a checkout), warm-up and the warm traffic."""


def read(run):
    return run.setup_s
