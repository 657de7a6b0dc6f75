"""Flag fixture (MUST FLAG collective-discipline, all three shapes): the
group of an axis no mesh declares, a collective gated on a process-local
branch, and a collective inside an exception-swallowing try. Parsed only —
never imported."""

import time

from actor_critic_tpu_torch.parallel.mesh import make_process_mesh, pmean, psum

FLEET_AXIS = "dp"

mesh = make_process_mesh((1,), (FLEET_AXIS,))


def reduce_bad_axis(x):
    return psum(x, mesh.group("dq"))  # typo'd axis: no mesh declares "dq"


def rank_gated_reduce(x, rank):
    if rank == 0:  # process-local predicate: only rank 0 enters
        return psum(x, mesh.group("dp"))  # ...the all-reduce the others sit in
    return x


def deadline_gated_reduce(x, deadline):
    while time.monotonic() < deadline:  # wall clocks differ per host
        x = pmean(x, mesh.group("dp"))
    return x


def swallowed_reduce(x):
    try:
        return pmean(x, mesh.group("dp"))
    except RuntimeError:
        return x  # this rank skips the exchange the fleet executes
