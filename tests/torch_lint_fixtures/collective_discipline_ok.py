"""Near miss: the collective_discipline_flag.py shapes made safe — the
declared axis constant everywhere, branches keyed on fleet-uniform values,
a stop decision all-reduced as a vote instead of gating the exchange, and a
try whose handler re-raises. Parsed only — never imported."""

import time

import torch.distributed as dist

from actor_critic_tpu_torch.parallel.mesh import make_process_mesh, pmean, psum

FLEET_AXIS = "dp"

mesh = make_process_mesh((1,), (FLEET_AXIS,))


def reduce_declared_axis(x):
    return psum(x, mesh.group(FLEET_AXIS))  # the declared constant


def mode_gated_reduce(x, mode):
    if mode == "sync":  # fleet-uniform flag: every rank agrees
        return psum(x, mesh.group(FLEET_AXIS))
    return x


def voted_stop_reduce(x, deadline):
    # The designed shape: the process-local deadline rides INTO the
    # collective as a vote; the stop decision is its fleet-agreed sum.
    vote = x * 0 + (1.0 if time.monotonic() >= deadline else 0.0)
    dist.all_reduce(vote)
    return vote


def reraising_reduce(x):
    try:
        return pmean(x, mesh.group(FLEET_AXIS))
    except RuntimeError:
        raise  # a dead rank takes its fleet slot down loudly
