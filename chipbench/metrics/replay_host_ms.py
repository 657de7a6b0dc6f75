"""Median host ms of a `CapturedStep.replay()` call over the untraced block
of a traced run: the graph launch's host cost (host clock)."""

import statistics


def read(run):
    if run.plain is None:
        return None
    return statistics.median(run.plain.host_replay_s) * 1e3
