"""Device operations (kernels, memsets and copies) a replay runs, from
the profiler's trace of the profiled block."""


def read(run):
    if run.trace is None or not run.trace["device_ops"]:
        return None
    return len(run.trace["device_ops"]) / run.trace["iterations"]
