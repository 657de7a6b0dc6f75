"""The 95th percentile of every iteration interval of the timed window
(event before a replay to the event before the next, or after the last),
in ms. The interval after each host read of the metrics carries the
replay's host launch and any stall."""

import statistics


def read(run):
    w = run.window
    if w is None or w.iterations < 2:
        return None
    intervals = [(b - a) * 1e3 for a, b in zip(w.marks_s, w.marks_s[1:])]
    return statistics.quantiles(intervals, n=100)[94]
