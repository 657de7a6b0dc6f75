"""The V-trace kernel's share of its roofline, in %: as `gae_roofline`."""

from chipbench.metrics_common import roofline_pct


def read(run):
    return roofline_pct(run, "vtrace")
