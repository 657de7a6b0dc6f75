"""Device ms of one rollout (env steps and the actors' forward), replayed
as a graph of its own from the state after the check's steps (CUDA
events, mean of `core.SPLIT_REPEATS`)."""


def read(run):
    return None if run.split is None else run.split["rollout_ms"]
