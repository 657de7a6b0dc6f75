"""Device ms of one update (targets, the loss's forward and backward, the
optimizer, the episode fold), replayed as a graph of its own on that
rollout's outputs (CUDA events, mean of `core.SPLIT_REPEATS`)."""


def read(run):
    return None if run.split is None else run.split["update_ms"]
