"""The GAE kernel's share of its roofline, in %: the least time its bytes
take at the card's HBM bandwidth (each input read once, each output
written once, the configuration's `kernel_bytes`) over its mean device
time a launch in the profiled block."""

from chipbench.metrics_common import roofline_pct


def read(run):
    return roofline_pct(run, "gae")
