"""Arithmetic that several metric readers share."""

from chipbench import peaks


def roofline_pct(run, kernel: str):
    """A kernel's roofline share (%) in the profiled block, or None where
    the configuration moves no bytes for it or the trace has no launch of
    it. The kernel is found by `kernel` + "_kernel" in the device op's name."""
    if run.trace is None:
        return None
    nbytes = run.cell.config_mod.kernel_bytes(run.cell.conf, kernel, run.cell.num_envs, run.cell.steps)
    times = [e - s for name, s, e in run.trace["device_ops"] if f"{kernel}_kernel" in name]
    if nbytes is None or not times:
        return None
    mean_s = sum(times) / len(times) / 1e6
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / mean_s
