"""The share of an iteration in which the device runs nothing, in %: one
minus the profiler's busy time a replay (the union of the device
operations' intervals in the profiled block, over its replays) over the
iteration's device time in the untraced block (CUDA events). The
profiled block's own window is not the denominator: under the profiler
each replay's launch holds the device idle, which the untraced program
does not. Where the profiler's kernel times run longer than the
untraced iteration, the reading is below 0, as measured."""

from chipbench.core import busy_intervals


def read(run):
    if run.trace is None or not run.trace["device_ops"] or run.plain is None or run.plain.seconds <= 0:
        return None
    busy_us = sum(e - s for s, e in busy_intervals(run.trace["device_ops"]))
    busy_per_iter = busy_us / 1e6 / run.trace["iterations"]
    per_iter = run.plain.seconds / run.plain.iterations
    return 100.0 * (1.0 - busy_per_iter / per_iter)
