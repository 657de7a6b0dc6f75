"""Sequence (time-axis) parallelism of the trajectory scans (counterpart of
`actor_critic_tpu/parallel/seqpar.py`).

GAE, discounted returns and V-trace are first-order linear recurrences
run in reverse over time,

    y_t = b_t + a_t * y_{t+1},        y_T = y_init,

so a contiguous segment of T composes into one affine map,

    y_seg_start = B_seg + A_seg * y_next_seg_start,
    A_seg = prod(a_t over the segment),  B_seg = the segment's scan from 0,

and splitting T over the ranks of a process group leaves one affine chain
of length W between them. Each rank holds one segment, in rank order, and:

  1. receives the NEXT segment's first value (`_halo_from_next`, JAX's
     `ppermute`): the v_{t+1} that GAE's δ and V-trace's deltas need at the
     segment's last step;
  2. runs its segment's scan from 0 (`B`) through the hand-written kernels
     on the card: B is exactly what the GAE kernel returns as advantages,
     and what the V-trace kernel returns as vs − values, when the
     bootstrap value is the halo (discounted returns are the GAE kernel's
     advantages with zero values and λ = 1); the suffix products P of a
     are a flip–cumprod–flip;
  3. gathers every segment's (P_0, B_0) and solves the chain on every rank
     (`_solve_boundary_chain`, JAX's `all_gather` and replicated scan),
     then fixes its segment up elementwise: y = B + P·y_in.

V-trace's pg advantages need vs_{t+1} across the boundary, which is the
solved boundary itself (vs_halo = y_in + v_halo); they are recomputed
after the fix-up, since the kernel's own use the segment-local vs at the
segment's last step.

The collectives are `parallel/mesh.py`'s (all-reduces of NCCL on the card,
inside a CUDA graph too; gloo on the CPU). Without a group (one rank) the
halo is the bootstrap and the chain's input is y_init: each function is
the plain scan through the kernel. On CPU tensors the kernels' wrappers
take their plain versions (`ops/returns.py`), as everywhere.

Where JAX's `seqpar_*` runs inside `shard_map` on a [T/W, ...] shard, the
port's runs on each rank with that rank's segment; `make_seqpar_fn` takes
global [T, ...] arrays, cuts this rank's segment (and returns this rank's
segment of each output: the caller gathers them, as JAX's caller sees the
sharded global array).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda
from actor_critic_tpu_torch.ops.returns import LOG_RATIO_CAP, VTraceOutput
from actor_critic_tpu_torch.parallel import mesh as mesh_lib
from actor_critic_tpu_torch.parallel.mesh import Group

SP_AXIS = "sp"


def _halo_from_next(x_first: torch.Tensor, bootstrap: torch.Tensor, group: Group) -> torch.Tensor:
    """The first value of the NEXT rank's segment; `bootstrap` on the last
    rank (and without a group). Every rank's `x_first` is gathered (one
    all-reduce of W rows) and the next one picked: JAX's shift by one."""
    if group is None:
        return bootstrap
    gathered = mesh_lib.all_gather(x_first, group)
    idx, n = mesh_lib.axis_index(group), mesh_lib.world_size(group)
    return bootstrap if idx == n - 1 else gathered[idx + 1]


def _solve_boundary_chain(a_seg: torch.Tensor, b_seg: torch.Tensor, y_init: torch.Tensor,
                          group: Group) -> torch.Tensor:
    """This rank's INCOMING boundary y_start_{i+1} of the chain
    y_start_i = b_i + a_i · y_start_{i+1} over the group's segments
    (`y_init` on the last rank): the [W, ...] summaries are gathered in one
    all-reduce and the chain solved on every rank, from the last segment
    back to this one's successor."""
    if group is None:
        return y_init
    ab = mesh_lib.all_gather(torch.stack([a_seg, b_seg]), group)
    y = y_init
    for i in range(mesh_lib.world_size(group) - 1, mesh_lib.axis_index(group), -1):
        y = ab[i, 1] + ab[i, 0] * y
    return y


def _suffix_products(a: torch.Tensor) -> torch.Tensor:
    """P_t = prod_{s >= t} a_s over the time axis of a [T, E] `a`: a
    flip–cumprod–flip along the rows of its transpose (a [T, E] view of an
    [E, T] tensor). On an H100, PyTorch's CUDA cumprod over the leading
    axis of a [4096, 64] tensor takes ~10× the GAE kernel's time; over the
    last axis a fraction of it (`chip_smoke.py`'s sp phase times both)."""
    return torch.flip(torch.cumprod(torch.flip(a.t(), [1]), 1), [1]).t()


def _local_affine_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, P) of y_t = b_t + a_t·y_{t+1} with y = 0 past the segment, the
    reference loop (the `seqpar_*` functions get B from the kernels);
    the true solution is y_t = B_t + P_t · y_boundary_in."""
    B = torch.empty_like(b)
    y = torch.zeros_like(b[0])
    for t in range(b.shape[0] - 1, -1, -1):
        y = b[t] + a[t] * y
        B[t] = y
    return B, _suffix_products(a)


def _columns(x: torch.Tensor) -> torch.Tensor:
    """[T, ...] as a contiguous float32 [T, E] for the kernels."""
    return x.detach().to(torch.float32).reshape(x.shape[0], -1).contiguous()


def seqpar_discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                              bootstrap_value: torch.Tensor, gamma: float, *,
                              group: Group) -> torch.Tensor:
    """Time-sharded Monte-Carlo returns; this rank's segment of
    `ops.returns.discounted_returns` of the whole trajectory. B is the GAE
    kernel's advantages with zero values and λ = 1."""
    shape = rewards.shape
    r, d = _columns(rewards), _columns(dones)
    zeros = torch.zeros_like(r)
    B, _ = gae_cuda.gae(r, zeros, d, zeros[0], gamma, 1.0)
    P = _suffix_products(gamma * (1.0 - d))
    y_in = _solve_boundary_chain(P[0], B[0], _columns(bootstrap_value[None])[0], group)
    return torch.addcmul(B, P, y_in).reshape(shape)


def seqpar_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
               bootstrap_value: torch.Tensor, gamma: float, lam: float, *,
               group: Group) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-sharded GAE; this rank's segment of `ops.returns.gae`'s
    (advantages, returns). One halo (V of the next segment's first step),
    one GAE kernel launch (B, with the halo as its bootstrap), one chain."""
    shape = rewards.shape
    r, v, d = _columns(rewards), _columns(values), _columns(dones)
    v_halo = _halo_from_next(v[0], _columns(bootstrap_value[None])[0], group)
    B, _ = gae_cuda.gae(r, v, d, v_halo.contiguous(), gamma, lam)
    P = _suffix_products(gamma * lam * (1.0 - d))
    adv_in = _solve_boundary_chain(P[0], B[0], torch.zeros_like(v_halo), group)
    advantages = torch.addcmul(B, P, adv_in)
    return advantages.reshape(shape), (advantages + v).reshape(shape)


def seqpar_vtrace(
    target_log_probs: torch.Tensor,
    behaviour_log_probs: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
    *,
    group: Group,
) -> VTraceOutput:
    """Time-sharded V-trace; this rank's segment of `ops.returns.vtrace`.
    Two boundary dependencies: V(x_{t+1}) for the deltas (the halo of
    `values`) and vs_{t+1} for the pg advantages (the solved boundary
    itself: vs of the next segment's first step is y_in + v_halo). One
    V-trace kernel launch (B = vs − values with the halo as its
    bootstrap; its clipped ρ are the output's)."""
    shape = rewards.shape
    tlp, blp, r, v, d = (_columns(x) for x in (target_log_probs, behaviour_log_probs,
                                                rewards, values, dones))
    v_halo = _halo_from_next(v[0], _columns(bootstrap_value[None])[0], group).contiguous()
    local = vtrace_cuda.vtrace(tlp, blp, r, v, d, v_halo, gamma, rho_bar=rho_bar, c_bar=c_bar,
                               lam=lam)
    B = local.vs - v
    discounts = gamma * (1.0 - d)
    rhos = torch.exp(torch.clamp(tlp - blp, max=LOG_RATIO_CAP))
    P = _suffix_products(discounts * (lam * torch.clamp(rhos, max=c_bar)))
    y_in = _solve_boundary_chain(P[0], B[0], torch.zeros_like(v_halo), group)
    vs = torch.addcmul(B, P, y_in) + v
    vs_tp1 = torch.cat([vs[1:], (y_in + v_halo)[None]], dim=0)
    clipped_rhos = local.clipped_rhos
    pg_advantages = clipped_rhos * (r + discounts * vs_tp1 - v)
    return VTraceOutput(vs=vs.reshape(shape), pg_advantages=pg_advantages.reshape(shape),
                        clipped_rhos=clipped_rhos.reshape(shape))


def make_sp_mesh(n_devices: int | None = None) -> mesh_lib.Mesh:
    """The 1-D ("sp",) mesh over every rank (JAX's `make_sp_mesh`, whose
    `n_devices` picks the first devices; a rank cannot sit out of the
    default group's `new_group` calls, so here it must be the world)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"an sp mesh of {n_devices} ranks in a world of {world}")
    return mesh_lib.make_process_mesh((world,), (SP_AXIS,))


def time_segment(x: torch.Tensor, mesh: mesh_lib.Mesh, axis_name: str = SP_AXIS) -> torch.Tensor:
    """This rank's contiguous segment of a global [T, ...] array (T must
    divide by the axis's size)."""
    n, i = mesh.shape[axis_name], mesh.index(axis_name)
    T = x.shape[0]
    if T % n:
        raise ValueError(f"time axis {T} not divisible by {axis_name}={n}")
    return x[i * (T // n):(i + 1) * (T // n)].contiguous()


def make_seqpar_fn(fn: Callable, mesh: mesh_lib.Mesh, n_time_sharded_args: int,
                   axis_name: str = SP_AXIS) -> Callable:
    """Wrap a `seqpar_*` function into a callable on global [T, ...]
    arrays: the first `n_time_sharded_args` positional arguments are cut to
    this rank's time segment (T must divide by the axis's size), the rest
    (bootstrap value, scalars) passed whole; returns this rank's segment of
    each output."""
    run = partial(fn, group=mesh.group(axis_name))

    def wrapped(*args):
        sharded = [time_segment(x, mesh, axis_name) for x in args[:n_time_sharded_args]]
        return run(*sharded, *args[n_time_sharded_args:])

    return wrapped
