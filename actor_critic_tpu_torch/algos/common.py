"""Shared trainer plumbing (counterpart of `actor_critic_tpu/algos/common.py`).

The JAX package scans T steps of (policy forward → vmapped env step)
inside one jitted program. Here the rollout is a Python loop over T of
batched tensor ops on the card; the advantage seams go through the
hand-written kernels: `gae_targets` through the GAE kernel
(`ops/gae_cuda.py`), `corrected_advantages` through the V-trace kernel
(`ops/vtrace_cuda.py`) or GAE.

The off-policy trainers (`ddpg.py`, `sac.py`) share `OffPolicyTransition`,
`OffPolicyState`, `offpolicy_rollout` and `make_greedy_eval` from here.

Unlike JAX's immutable pytrees, `TrainState` is a mutable dataclass, and
every tensor it carries from one iteration to the next is updated in place
(parameters, optimizer moments and count, the rollout's obs and env state,
the episode accounting, the step counter): a CUDA graph that captured a
step reads and writes the addresses it saw, so a rebound tensor would be
read stale on every replay (`algos/loop.py`). The counts live on the device
alone (`TrainState.step_counter`, `AdamState.count`), and the scalars that
change from step to step (learning rate, bias corrections, annealed
coefficients) come from a `ScheduleTable` looked up there at those counts,
not from Python floats, which a capture would freeze.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from actor_critic_tpu_torch.envs.env import EnvSpec, TorchEnv
from actor_critic_tpu_torch.models.networks import (
    ActorCriticDiscrete,
    ActorCriticGaussian,
    shared_casts,
)
from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda
from actor_critic_tpu_torch.optim import AdamState, ClippedAdam, RMSPropState
from actor_critic_tpu_torch.parallel.mesh import Group, pmean
from actor_critic_tpu_torch.tree import named_leaves, tree_leaves, tree_map


class Transition(NamedTuple):
    """A rollout; every field is [T, E, ...]."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor        # episode ended this step (term or trunc)
    terminated: torch.Tensor  # true termination (cuts bootstrap)
    final_obs: torch.Tensor   # pre-reset obs of the step (== next obs if not done)


class RolloutState(NamedTuple):
    """Per-env state + current obs, carried from one rollout to the next."""

    env_state: Any
    obs: torch.Tensor


class OffPolicyTransition(NamedTuple):
    """One replay-ready transition (DDPG/TD3/SAC). `next_obs` is the
    pre-reset successor (the env's `final_obs`), so the TD bootstrap
    r + γ·(1−terminated)·Q(next_obs, ·) is right across terminations
    (masked) and time-limit truncations (bootstrapped through); `done` is
    kept for the episode accounting."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    terminated: torch.Tensor
    done: torch.Tensor


class ScheduleTable(NamedTuple):
    """A trainer's step-dependent scalars, built once on the host by the
    same float32 functions the eager code used (so the values are those
    functions' to the bit) and looked up on the device. Each lookup clamps
    its index at the last row, from which every value is constant."""

    optimizer: torch.Tensor     # [R, 3] `ClippedAdam.scalar_table()`, by Adam's count
    coefficients: torch.Tensor  # [S, C] the loss's annealed coefficients, by iteration

    def coefficients_at(self, iteration: torch.Tensor) -> torch.Tensor:
        """[C] coefficients of `iteration` (a [1] int64 tensor)."""
        row = torch.clamp(iteration, max=self.coefficients.shape[0] - 1)
        return self.coefficients.index_select(0, row)[0]


def schedule_table(
    opt: ClippedAdam,
    coefficients: Sequence[Callable[[int], float]],
    anneal_iters: int,
    device: torch.device,
) -> ScheduleTable:
    """The table of `opt`'s scalars and of `coefficients`, each a function
    of `update_step`, at update_step = 0 … anneal_iters (0 alone when
    annealing is off): `anneal_fraction` clips there, so they are constant
    from then on."""
    rows = [[fn(i) for fn in coefficients] for i in range(max(anneal_iters, 0) + 1)]
    return ScheduleTable(
        optimizer=torch.from_numpy(opt.scalar_table()).to(device),
        coefficients=torch.tensor(rows, dtype=torch.float32, device=device),
    )


@dataclasses.dataclass
class TrainState:
    """On-policy trainer state. Total env steps = update_step · T · E."""

    net: nn.Module
    opt_state: Union[AdamState, RMSPropState]
    rollout: RolloutState
    generator: torch.Generator  # on the trainer's device: actions and resets
    # Running episode-return accounting (per env).
    ep_return: torch.Tensor
    ep_length: torch.Tensor
    # Exponential-moving average of completed-episode returns (0-dim).
    avg_return: torch.Tensor
    # Number of train_step calls, a [1] int64 tensor on the trainer's device
    # advanced in place: the one count of iterations (`update_step` reads it).
    step_counter: torch.Tensor
    # The annealed scalars by step (A2C, PPO; IMPALA/A3C anneal nothing).
    schedule: Optional[ScheduleTable] = dataclasses.field(default=None, kw_only=True)

    @property
    def update_step(self) -> int:
        """Train steps taken; reading it waits for the device."""
        return int(self.step_counter)


@dataclasses.dataclass
class OffPolicyState:
    """The fused off-policy trainers' state (DDPG/TD3's `OffPolicyState`,
    SAC's `SACState` in the JAX package): the learner (its nets, targets,
    optimizers and replay ring), the env batch, the trainer's generator
    (exploration, resets, replay draws, target noise), the env-step count
    that gates the warm-up, the episode accounting and the count of train
    steps. Every tensor is written in place."""

    learner: Any
    rollout: RolloutState
    generator: torch.Generator
    env_steps: torch.Tensor  # 0-dim int64: env steps so far, saturating at 2^30
    ep_return: torch.Tensor
    ep_length: torch.Tensor
    avg_return: torch.Tensor
    step_counter: torch.Tensor  # [1] int64: train steps (`update_step` reads it)

    @property
    def update_step(self) -> int:
        """Train steps taken; reading it waits for the device."""
        return int(self.step_counter)


def named_carried(obj: Any, prefix: str) -> dict[str, torch.Tensor]:
    """The tensors under `obj` by name: a module's parameters (`<prefix>
    <param>`), an Adam state's moments and count (`<prefix> mu <param>`,
    `<prefix> nu <param>`, `<prefix> count`), a tuple's leaves by path
    (`<prefix> <path>`: the ring's storage, cursor and stats, the rollout),
    a dataclass's fields and a dict's items (`<prefix>.<name>`);
    generators, tables and other constants carry nothing."""
    if isinstance(obj, nn.Module):
        return {f"{prefix} {k}": p.detach() for k, p in obj.named_parameters()}
    if isinstance(obj, AdamState):
        out = {f"{prefix} mu {k}": t for k, t in obj.mu.items()}
        out.update({f"{prefix} nu {k}": t for k, t in obj.nu.items()})
        out[f"{prefix} count"] = obj.count
        return out
    if isinstance(obj, tuple):
        out = {}
        for k, t in named_leaves(obj).items():
            # A dict inside a tuple (the device ring's storage by key) is
            # a node too.
            out.update(named_carried(t, f"{prefix} {k}") if isinstance(t, dict)
                       else {f"{prefix} {k}": t})
        return out
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(named_carried(v, f"{prefix}.{k}" if prefix else k))
        return out
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(named_carried(getattr(obj, f.name),
                                      f"{prefix}.{f.name}" if prefix else f.name))
        return out
    return {}


def carried_tensors(state: Any) -> dict[str, torch.Tensor]:
    """Every tensor a train step reads from `state` and writes back, by
    name. What a checkpoint holds besides the generator's state, and what a
    graph replay must leave where eager execution would.

    On-policy (`TrainState`): the learner's parameters (`param <name>`) and
    any other network's (IMPALA's `actor_net <name>`), the optimizer's
    moments and count (`mu <name>`, `nu <name>`, `count`), the rollout obs
    and every env-state leaf (`env <path>`, the mixture's weights and stage
    among them), the episode accounting and the step counter.

    Off-policy (`OffPolicyState`): each field by name through
    `named_carried`: the actor, critic and target parameters
    (`learner.actor <name>`, …), both Adam states (and SAC's `log_alpha`
    and its Adam), every ring leaf, `insert_pos`, `size` and every
    quant-stat leaf (`learner.replay storage.obs`, `learner.replay
    quant.obs.mean`, …), `update_count`, the rollout, `env_steps`, the
    episode accounting and the step counter.

    Any other dataclass (a host trainer's `host_loop.HostCheckpoint`):
    its fields through `named_carried` likewise."""
    if not isinstance(state, TrainState):
        return named_carried(state, "")
    out: dict[str, torch.Tensor] = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, nn.Module):
            prefix = "param" if f.name == "net" else f.name
            out.update({f"{prefix} {k}": p.detach() for k, p in v.named_parameters()})
    for f in dataclasses.fields(state.opt_state):
        v = getattr(state.opt_state, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name} {k}": t for k, t in v.items()})
        else:
            out[f.name] = v
    out["rollout obs"] = state.rollout.obs
    out.update({f"env {k}": v for k, v in named_leaves(state.rollout.env_state).items()})
    out.update(ep_return=state.ep_return, ep_length=state.ep_length,
               avg_return=state.avg_return, step_counter=state.step_counter)
    return out


def compute_dtype(bf16_compute: bool) -> torch.dtype:
    """The networks' compute dtype of a config's `bf16_compute` (the JAX
    trainers' `dtype = jnp.bfloat16 if cfg.bf16_compute else jnp.float32`)."""
    return torch.bfloat16 if bf16_compute else torch.float32


def make_actor_critic(
    spec: EnvSpec, hidden: Sequence[int], bf16_compute: bool,
    generator: Optional[torch.Generator] = None,
) -> Union[ActorCriticDiscrete, ActorCriticGaussian]:
    """The trainers' network, as the JAX trainers' `make_network` picks it:
    a shared-torso categorical net for discrete actions (the Nature CNN
    torso on pixel obs), separate actor and critic torsos with a Gaussian
    head for continuous ones; computing in bf16 with `bf16_compute`."""
    dtype = compute_dtype(bf16_compute)
    if spec.discrete:
        return ActorCriticDiscrete(spec.obs_shape, spec.action_dim, hidden, generator,
                                   pixel_obs=spec.pixel_obs, compute_dtype=dtype)
    return ActorCriticGaussian(spec.obs_shape[-1], spec.action_dim, hidden, generator,
                               compute_dtype=dtype)


def init_rollout(env: TorchEnv, generator: torch.Generator, num_envs: int) -> RolloutState:
    """A fresh env batch. Every leaf of the (possibly nested) env state
    gets dense storage of its own (a reset may return one tensor for two
    fields, views of one buffer, or a constant table broadcast over the
    batch), since the rollout writes each leaf in place."""
    env_state, obs = env.reset(num_envs, generator)
    own = lambda x: x.clone(memory_format=torch.contiguous_format)
    return RolloutState(env_state=tree_map(own, env_state), obs=own(obs))


def init_train_state(
    env: TorchEnv,
    net: nn.Module,
    opt: ClippedAdam,
    num_envs: int,
    seed: int,
    device: torch.device,
    schedule: ScheduleTable,
) -> TrainState:
    """A capturable trainer's fresh state on `device`: `net` (already there),
    Adam moments at zero, a reset env batch and a step counter at 0. Actions,
    resets and minibatch draws come from a generator on `device` seeded
    with `seed`."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(
        net=net,
        opt_state=opt.init(dict(net.named_parameters())),
        rollout=init_rollout(env, generator, num_envs),
        generator=generator,
        ep_return=torch.zeros(num_envs, device=device),
        ep_length=torch.zeros(num_envs, device=device),
        avg_return=torch.zeros((), device=device),
        step_counter=torch.zeros(1, dtype=torch.int64, device=device),
        schedule=schedule,
    )


@torch.no_grad()
def rollout_loop(
    env: TorchEnv,
    net: nn.Module,
    rstate: RolloutState,
    generator: torch.Generator,
    num_steps: int,
) -> Transition:
    """Collect `num_steps` of experience from the env batch (the
    counterpart of `rollout_scan`). `net(obs) -> (dist, value)`; actions
    are sampled from `generator`. Returns time-major [T, E, ...] arrays and
    advances `rstate` in place: its obs and every leaf of its env state
    take the values after the last step. A bf16 net's forwards share one
    set of bf16 weight copies (`shared_casts`)."""
    env_state, obs = rstate.env_state, rstate.obs
    steps = []
    with shared_casts(net):
        for _ in range(num_steps):
            dist, value = net(obs)
            action = dist.sample(generator)
            log_prob = dist.log_prob(action)
            out = env.step(env_state, action, generator)
            steps.append(Transition(
                obs=obs,
                action=action,
                log_prob=log_prob,
                value=value,
                reward=out.reward,
                done=out.done,
                terminated=out.info["terminated"],
                final_obs=out.info["final_obs"],
            ))
            env_state, obs = out.state, out.obs
    # Stacked before the copy: the first step's obs is `rstate.obs` itself.
    traj = Transition(*(torch.stack(field) for field in zip(*steps)))
    for buf, new in zip(tree_leaves(rstate), tree_leaves(RolloutState(env_state, obs)),
                        strict=True):
        buf.copy_(new)
    return traj


# The env-step count saturates here, so a long run's count can never wrap
# and turn the warm-up gate back on.
ENV_STEPS_SATURATE = 1 << 30


@torch.no_grad()
def offpolicy_rollout(
    env: TorchEnv,
    act_fn: Callable[[nn.Module, torch.Tensor, torch.Generator, torch.Tensor], torch.Tensor],
    actor: nn.Module,
    rstate: RolloutState,
    generator: torch.Generator,
    num_steps: int,
    env_steps: torch.Tensor,
) -> OffPolicyTransition:
    """Collect `num_steps` exploration steps from the env batch (the
    counterpart of JAX's `offpolicy_rollout`). `act_fn(actor, obs,
    generator, env_steps) -> action` owns the exploration policy (noise,
    the warm-up's uniform actions), given the env-step count before the
    step. Returns time-major [K, E, ...] transitions and advances `rstate`
    and `env_steps` (0-dim, saturating at `ENV_STEPS_SATURATE`) in place.
    A bf16 actor's forwards share one set of bf16 weight copies."""
    env_state, obs = rstate.env_state, rstate.obs
    steps_now = env_steps
    steps = []
    with shared_casts(actor):
        for _ in range(num_steps):
            action = act_fn(actor, obs, generator, steps_now)
            out = env.step(env_state, action, generator)
            steps.append(OffPolicyTransition(
                obs=obs,
                action=action,
                reward=out.reward,
                next_obs=out.info["final_obs"],
                terminated=out.info["terminated"],
                done=out.done,
            ))
            steps_now = torch.clamp(steps_now + obs.shape[0], max=ENV_STEPS_SATURATE)
            env_state, obs = out.state, out.obs
    # Stacked before the copies: the first step's obs is `rstate.obs` itself.
    traj = OffPolicyTransition(*(torch.stack(field) for field in zip(*steps)))
    for buf, new in zip(tree_leaves(rstate), tree_leaves(RolloutState(env_state, obs)),
                        strict=True):
        buf.copy_(new)
    env_steps.copy_(steps_now)
    return traj


def gae_targets(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    lam: float,
    time_group: Group = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """THE on-policy advantage seam: (advantages, returns) through the GAE
    kernel on CUDA tensors, through its plain version on CPU tensors. With
    `time_group` the [T, E] inputs are this rank's time segment and the
    scan runs sequence-parallel over the group (`parallel.seqpar.seqpar_gae`,
    whose local scan is the same kernel)."""
    if time_group is not None:
        from actor_critic_tpu_torch.parallel.seqpar import seqpar_gae

        return seqpar_gae(rewards, values, dones, bootstrap_value, gamma, lam, group=time_group)
    return gae_cuda.gae(rewards, values, dones, bootstrap_value, gamma, lam)


def corrected_advantages(
    target_log_probs: torch.Tensor,
    behavior_log_probs: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    lam: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    correction: str = "vtrace",
    time_group: Group = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The staleness correction of the decoupled actor-learner trainer:
    (pg_advantages, value_targets, mean_clipped_rho).

    `"vtrace"`: V-trace through the V-trace kernel (`ops/vtrace_cuda.py`),
    the behaviour log-probs recorded at rollout time correcting the actors'
    lag. `"none"`: plain λ-return GAE under the learner's critic through
    `gae_targets`, with no importance weighting (the A3C rule), and a mean
    ρ of 1. Inputs are gradient constants. With `time_group` the inputs are
    this rank's time segment and the recurrence runs sequence-parallel
    (`parallel.seqpar`: `seqpar_vtrace` or `seqpar_gae`); the mean ρ is then
    the segment's."""
    if correction == "vtrace":
        if time_group is not None:
            from actor_critic_tpu_torch.parallel.seqpar import seqpar_vtrace

            vt = seqpar_vtrace(
                target_log_probs, behavior_log_probs, rewards, values, dones,
                bootstrap_value, gamma, rho_bar=rho_bar, c_bar=c_bar, lam=lam,
                group=time_group,
            )
        else:
            vt = vtrace_cuda.vtrace(
                target_log_probs, behavior_log_probs, rewards, values, dones,
                bootstrap_value, gamma, rho_bar=rho_bar, c_bar=c_bar, lam=lam,
            )
        return vt.pg_advantages, vt.vs, torch.mean(vt.clipped_rhos)
    if correction == "none":
        pg_advantages, value_targets = gae_targets(
            rewards, values, dones, bootstrap_value, gamma, lam, time_group
        )
        return pg_advantages, value_targets, torch.ones((), device=rewards.device)
    raise ValueError(f"unknown correction: {correction!r}")


def anneal_fraction(update_step: int, anneal_iters: int) -> Optional[float]:
    """update_step → clipped [0, 1] anneal fraction (float32 arithmetic, as
    in JAX); None when annealing is off (anneal_iters <= 0)."""
    if anneal_iters <= 0:
        return None
    frac = np.float32(update_step) / np.float32(anneal_iters)
    return float(np.clip(frac, np.float32(0.0), np.float32(1.0)))


def linear_anneal(initial: float, final: Optional[float], progress: Optional[float]) -> float:
    """initial + (final − initial)·progress in float32; the constant
    `initial` when the schedule is disabled."""
    if final is None or progress is None:
        return initial
    return float(np.float32(initial) + np.float32(final - initial) * np.float32(progress))


def truncation_bootstrap_rewards(
    traj: Transition, final_values: torch.Tensor, gamma: float
) -> torch.Tensor:
    """r_t ← r_t + γ·V(final_obs_t) where the episode was truncated (not
    terminated) at t, so `gae` can treat `done` as a hard cut."""
    truncated = traj.done * (1.0 - traj.terminated)
    return traj.reward + gamma * final_values * truncated


def rollout_targets(
    env: TorchEnv,
    net: nn.Module,
    traj: Transition,
    next_obs: torch.Tensor,
    gamma: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(advantages, returns) of a rollout `traj` under `net`: the bootstrap
    value at `next_obs`, the truncation bootstrap at `final_obs` (where the
    env can truncate), then GAE through `gae_targets`."""
    with torch.no_grad():
        _, bootstrap_value = net(next_obs)
        if env.spec.can_truncate:
            T, E = traj.reward.shape
            _, final_values = net(traj.final_obs.reshape(T * E, *traj.final_obs.shape[2:]))
            rewards = truncation_bootstrap_rewards(traj, final_values.reshape(T, E), gamma)
        else:
            rewards = traj.reward
    return gae_targets(rewards, traj.value, traj.done, bootstrap_value, gamma, lam)


# Steps between the eval loop's checks for a running first episode.
EVAL_CHECK_EVERY = 16


def _first_episode_mean(ret: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    finished = 1.0 - alive
    n_finished = torch.sum(finished)
    finished_mean = torch.sum(ret * finished) / torch.clamp(n_finished, min=1.0)
    return torch.where(n_finished > 0, finished_mean, torch.mean(ret))


@torch.no_grad()
def evaluate(
    env: TorchEnv,
    act_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    num_envs: int = 32,
    num_steps: int = 256,
    reset_fn: Optional[Callable[[int, torch.Generator], tuple[Any, torch.Tensor]]] = None,
) -> torch.Tensor:
    """Greedy eval: mean return of each env's FIRST episode. Envs whose
    episode outlives `num_steps` are excluded; if none finishes, the mean
    of the partial returns is reported (a lower bound). `reset_fn`
    replaces `env.reset` (the mixture's type-pinned fleets for the
    per-type eval). Every `EVAL_CHECK_EVERY` steps the host looks whether
    any first episode is still running and stops when none is: the steps
    left could change no return. The plain loop, run eagerly: the
    reference `BlockedEval`, the same loop in blocks that the card replays
    as CUDA graphs, is held against."""
    env_state, obs = (reset_fn or env.reset)(num_envs, generator)
    ret = torch.zeros(num_envs, device=obs.device)
    alive = torch.ones(num_envs, device=obs.device)
    for i in range(num_steps):
        if i % EVAL_CHECK_EVERY == 0 and i > 0 and not bool(alive.any()):
            break
        out = env.step(env_state, act_fn(obs), generator)
        ret = ret + out.reward * alive
        alive = alive * (1.0 - out.done)
        env_state, obs = out.state, out.obs
    return _first_episode_mean(ret, alive)


class BlockedEval:
    """`evaluate`'s loop as blocks of `EVAL_CHECK_EVERY` env steps (and one
    shorter tail block when `num_steps` is not a multiple of it) over
    static buffers: the env state, obs, return and alive mask. Each call
    resets the fleet eagerly into the buffers, runs the blocks with the
    host's check for a running first episode between them, and returns
    what `evaluate` returns, with the same random draws.

    On the CPU the blocks run eagerly. On the card each block length is
    captured into a CUDA graph at its first use (after one eager run of the
    block on copies of the buffers and of the generator, on a side stream)
    and replayed from then on; the generator a call passes is registered
    with each graph, so a replay draws what the eager block would, and the
    graphs serve that generator only. The act function, the env and the
    buffers are frozen into the graphs: a later call evaluates the
    parameters the act function reads, as they are then. `capture_s` holds
    the seconds each capture took, warm-up included. `warm` captures every
    block length ahead of the first call (the warm-up registry's capture
    part of the evals, `utils/compile_cache.py`)."""

    def __init__(self, env: TorchEnv, act_fn: Callable[[torch.Tensor], torch.Tensor],
                 num_envs: int, num_steps: int):
        self.env, self.act_fn, self.num_envs = env, act_fn, num_envs
        full, tail = divmod(num_steps, EVAL_CHECK_EVERY)
        self.blocks = [EVAL_CHECK_EVERY] * full + ([tail] if tail else [])
        self.buffers: Optional[tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]] = None
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.generator: Optional[torch.Generator] = None
        self.capture_s: dict[int, float] = {}

    def _run_block(self, buffers, generator: torch.Generator, n: int) -> None:
        env_state, obs, ret, alive = buffers
        for _ in range(n):
            out = self.env.step(env_state, self.act_fn(obs), generator)
            ret = ret + out.reward * alive
            alive = alive * (1.0 - out.done)
            env_state, obs = out.state, out.obs
        for buf, new in zip(tree_leaves(buffers), tree_leaves((env_state, obs, ret, alive)),
                            strict=True):
            buf.copy_(new)

    def _capture(self, generator: torch.Generator, n: int) -> torch.cuda.CUDAGraph:
        t0 = time.perf_counter()
        device = generator.device
        scratch = tree_map(torch.clone, self.buffers)
        twin = torch.Generator(device=device)
        twin.set_state(generator.get_state())
        side, current = torch.cuda.Stream(device), torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._run_block(scratch, twin, n)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        from actor_critic_tpu_torch.algos import loop
        from actor_critic_tpu_torch.telemetry import profiler

        signature = profiler.signature_of(named_leaves(self.buffers))
        with profiler.record_compile(f"eval_block[x{n}]", signature):
            with loop.capture(graph):
                self._run_block(self.buffers, generator, n)
        torch.cuda.synchronize(device)
        self.capture_s[n] = time.perf_counter() - t0
        return graph

    def _reset(self, generator: torch.Generator, reset_fn) -> None:
        """A fresh fleet (`reset_fn`, eager) and zeroed returns, alive
        everywhere, into the buffers (allocated at the first call)."""
        env_state, obs = reset_fn(self.num_envs, generator)
        ret = torch.zeros(self.num_envs, device=obs.device)
        alive = torch.ones(self.num_envs, device=obs.device)
        fresh = (env_state, obs, ret, alive)
        if self.buffers is None:
            own = lambda x: x.clone(memory_format=torch.contiguous_format)
            self.buffers = tree_map(own, fresh)
        else:
            for buf, new in zip(tree_leaves(self.buffers), tree_leaves(fresh), strict=True):
                buf.copy_(new)
        if generator.device.type == "cuda":
            if self.generator is None:
                self.generator = generator
            elif generator is not self.generator:
                raise ValueError("a captured eval replays the generator it was captured with")

    @torch.no_grad()
    def warm(self, generator: torch.Generator,
             reset_fn: Callable[[int, torch.Generator], tuple[Any, torch.Tensor]]) -> None:
        """Capture every block length ahead of the first call, from one reset
        into the buffers, the generator's state put back after (on the card;
        on the CPU there is nothing to capture)."""
        if generator.device.type != "cuda":
            return
        saved = generator.get_state()
        try:
            self._reset(generator, reset_fn)
            for n in dict.fromkeys(self.blocks):
                if n not in self.graphs:
                    self.graphs[n] = self._capture(generator, n)
        finally:
            generator.set_state(saved)

    @torch.no_grad()
    def __call__(self, generator: torch.Generator,
                 reset_fn: Callable[[int, torch.Generator], tuple[Any, torch.Tensor]]) -> torch.Tensor:
        self._reset(generator, reset_fn)
        capture = generator.device.type == "cuda"
        alive = self.buffers[3]
        for i, n in enumerate(self.blocks):
            # torchlint: disable=transfer-discipline (one read a block of steps,
            # by design: the eval stops at the first block boundary where every
            # env is done)
            if i > 0 and not bool(alive.any()):
                break
            if not capture:
                self._run_block(self.buffers, generator, n)
                continue
            if n not in self.graphs:
                self.graphs[n] = self._capture(generator, n)
            self.graphs[n].replay()
        return _first_episode_mean(self.buffers[2], alive)


def _mode_action(net: nn.Module, obs: torch.Tensor) -> torch.Tensor:
    return net(obs)[0].mode()


def make_net_eval(
    env: TorchEnv, act: Callable[[nn.Module, torch.Tensor], torch.Tensor] = _mode_action
):
    """`run(net, generator, num_envs, num_steps, reset_fn=None)`: the greedy
    eval of `net` on `env`, its action `act(net, obs)` (by default the mode
    of an actor-critic net's distribution), through a `BlockedEval` (graph
    replays on the card), one per (net, num_envs, num_steps), kept for the
    later calls. A `reset_fn` (the mixture's type-pinned reset) is run
    eagerly at each call, so one set of graphs serves every reset of that
    shape. `run.warm(...)`, with the same arguments, captures that eval's
    blocks ahead of its first call (`BlockedEval.warm`)."""
    evals: dict[tuple, BlockedEval] = {}

    def blocked(net: nn.Module, num_envs: int, num_steps: int) -> BlockedEval:
        key = (net, num_envs, num_steps)
        if key not in evals:
            evals[key] = BlockedEval(env, lambda obs: act(net, obs), num_envs, num_steps)
        return evals[key]

    def run(net: nn.Module, generator: torch.Generator, num_envs: int, num_steps: int,
            reset_fn=None) -> torch.Tensor:
        return blocked(net, num_envs, num_steps)(generator, reset_fn or env.reset)

    def warm(net: nn.Module, generator: torch.Generator, num_envs: int, num_steps: int,
             reset_fn=None) -> None:
        blocked(net, num_envs, num_steps).warm(generator, reset_fn or env.reset)

    run.evals = evals
    run.warm = warm
    return run


def default_eval_steps(env: TorchEnv) -> int:
    """The env's time limit plus slack, or 512 when it declares none."""
    h = env.spec.episode_horizon
    return h + 8 if h > 0 else 512


def make_mode_eval(env: TorchEnv):
    """Greedy (mode-action) eval for actor-critic nets whose
    `net(obs) → (dist, value)`; returns
    `eval_fn(state, generator, num_envs=32, num_steps=default_eval_steps(env))`,
    replayed as CUDA graphs on the card (`make_net_eval`); `eval_fn.warm`
    takes the same arguments and captures its blocks ahead of the first
    call."""
    default_steps = default_eval_steps(env)
    run = make_net_eval(env)

    def eval_fn(state: TrainState, generator: torch.Generator,
                num_envs: int = 32, num_steps: int = default_steps) -> torch.Tensor:
        return run(state.net, generator, num_envs, num_steps)

    def warm(state: TrainState, generator: torch.Generator,
             num_envs: int = 32, num_steps: int = default_steps) -> None:
        run.warm(state.net, generator, num_envs, num_steps)

    eval_fn.evals = run.evals
    eval_fn.warm = warm
    return eval_fn


def make_greedy_eval(
    env: TorchEnv,
    act: Callable[[nn.Module, torch.Tensor], torch.Tensor],
    module_of: Callable[[Any], nn.Module],
):
    """The off-policy trainers' eval (JAX's `make_greedy_eval`): `act(actor,
    obs)` is the greedy action (the noiseless actor, the tanh-mean) and
    `module_of(state)` the acting module. Returns `eval_fn(state,
    generator, num_envs=32, num_steps=default_eval_steps(env))`, replayed
    as CUDA graphs on the card (`make_net_eval`)."""
    default_steps = default_eval_steps(env)
    run = make_net_eval(env, act)

    def eval_fn(state, generator: torch.Generator, num_envs: int = 32,
                num_steps: int = default_steps) -> torch.Tensor:
        return run(module_of(state), generator, num_envs, num_steps)

    def warm(state, generator: torch.Generator, num_envs: int = 32,
             num_steps: int = default_steps) -> None:
        run.warm(module_of(state), generator, num_envs, num_steps)

    eval_fn.evals = run.evals
    eval_fn.warm = warm
    return eval_fn


def episode_metrics_update(
    ep_return: torch.Tensor,
    ep_length: torch.Tensor,
    avg_return: torch.Tensor,
    traj: Transition,
    decay: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Fold a [T, E] trajectory into running per-env episode accounting;
    returns updated (ep_return, ep_length, avg_return EMA, metrics). No
    host sync: the per-step branch is a `torch.where`."""
    zero = torch.zeros((), device=ep_return.device)
    n_done, sum_done, len_done = zero, zero, zero
    for reward, done in zip(traj.reward, traj.done):
        ep_return = ep_return + reward
        ep_length = ep_length + 1.0
        batch_done = torch.sum(done)
        batch_sum = torch.sum(ep_return * done)
        n_done = n_done + batch_done
        sum_done = sum_done + batch_sum
        len_done = len_done + torch.sum(ep_length * done)
        any_done = batch_done > 0
        batch_mean = torch.where(any_done, batch_sum / torch.clamp(batch_done, min=1.0), avg_return)
        avg_return = torch.where(any_done, decay * avg_return + (1 - decay) * batch_mean, avg_return)
        ep_return = ep_return * (1.0 - done)
        ep_length = ep_length * (1.0 - done)
    metrics = {
        "episodes_finished": n_done,
        "finished_return_sum": sum_done,
        "finished_length_sum": len_done,
        "avg_return_ema": avg_return,
    }
    return ep_return, ep_length, avg_return, metrics


def fold_episodes(
    state: Union[TrainState, OffPolicyState], traj: Union[Transition, OffPolicyTransition],
    group: Group = None,
) -> dict[str, torch.Tensor]:
    """`episode_metrics_update` on `state`'s accounting, written back in
    place; returns the episode metrics. With a data-parallel `group` the
    return EMA, replicated state, is pmean'd over its ranks first (each
    rank folds its own envs' episodes)."""
    ep_return, ep_length, avg_return, metrics = episode_metrics_update(
        state.ep_return, state.ep_length, state.avg_return, traj
    )
    avg_return = pmean(avg_return, group)
    metrics["avg_return_ema"] = avg_return
    state.ep_return.copy_(ep_return)
    state.ep_length.copy_(ep_length)
    state.avg_return.copy_(avg_return)
    return metrics


def advance(state: Union[TrainState, OffPolicyState]) -> None:
    """Count one train step, on the device, in place."""
    state.step_counter.add_(1)
