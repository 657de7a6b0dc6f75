"""Shared trainer plumbing (counterpart of `actor_critic_tpu/algos/common.py`).

The JAX package scans T steps of (policy forward → vmapped env step)
inside one jitted program. Here the rollout is a Python loop over T of
batched tensor ops on the card; the advantage seams go through the
hand-written kernels: `gae_targets` through the GAE kernel
(`ops/gae_cuda.py`), `corrected_advantages` through the V-trace kernel
(`ops/vtrace_cuda.py`) or GAE.

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
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from actor_critic_tpu_torch.envs.env import TorchEnv
from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda
from actor_critic_tpu_torch.optim import AdamState, ClippedAdam, RMSPropState


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


def init_rollout(env: TorchEnv, generator: torch.Generator, num_envs: int) -> RolloutState:
    """A fresh env batch. Every field gets storage of its own (a reset may
    return one tensor for two fields, or views of one buffer), since the
    rollout writes each field in place."""
    env_state, obs = env.reset(num_envs, generator)
    return RolloutState(env_state=type(env_state)(*(x.clone() for x in env_state)),
                        obs=obs.clone())


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
    advances `rstate` in place: its obs and every env-state field take the
    values after the last step."""
    env_state, obs = rstate.env_state, rstate.obs
    steps = []
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
    for buf, new in zip((*rstate.env_state, rstate.obs), (*env_state, obs)):
        buf.copy_(new)
    return traj


def gae_targets(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """THE on-policy advantage seam: (advantages, returns) through the GAE
    kernel on CUDA tensors, through its plain version on CPU tensors."""
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The staleness correction of the decoupled actor-learner trainer:
    (pg_advantages, value_targets, mean_clipped_rho).

    `"vtrace"`: V-trace through the V-trace kernel (`ops/vtrace_cuda.py`),
    the behaviour log-probs recorded at rollout time correcting the actors'
    lag. `"none"`: plain λ-return GAE under the learner's critic through
    `gae_targets`, with no importance weighting (the A3C rule), and a mean
    ρ of 1. Inputs are gradient constants."""
    if correction == "vtrace":
        vt = vtrace_cuda.vtrace(
            target_log_probs, behavior_log_probs, rewards, values, dones,
            bootstrap_value, gamma, rho_bar=rho_bar, c_bar=c_bar, lam=lam,
        )
        return vt.pg_advantages, vt.vs, torch.mean(vt.clipped_rhos)
    if correction == "none":
        pg_advantages, value_targets = gae_targets(
            rewards, values, dones, bootstrap_value, gamma, lam
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


@torch.no_grad()
def evaluate(
    env: TorchEnv,
    act_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: torch.Generator,
    num_envs: int = 32,
    num_steps: int = 256,
) -> torch.Tensor:
    """Greedy eval: mean return of each env's FIRST episode. Envs whose
    episode outlives `num_steps` are excluded; if none finishes, the mean
    of the partial returns is reported (a lower bound)."""
    env_state, obs = env.reset(num_envs, generator)
    ret = torch.zeros(num_envs, device=obs.device)
    alive = torch.ones(num_envs, device=obs.device)
    for _ in range(num_steps):
        out = env.step(env_state, act_fn(obs), generator)
        ret = ret + out.reward * alive
        alive = alive * (1.0 - out.done)
        env_state, obs = out.state, out.obs
    finished = 1.0 - alive
    n_finished = torch.sum(finished)
    finished_mean = torch.sum(ret * finished) / torch.clamp(n_finished, min=1.0)
    return torch.where(n_finished > 0, finished_mean, torch.mean(ret))


def default_eval_steps(env: TorchEnv) -> int:
    """The env's time limit plus slack, or 512 when it declares none."""
    h = env.spec.episode_horizon
    return h + 8 if h > 0 else 512


def make_mode_eval(env: TorchEnv):
    """Greedy (mode-action) eval for actor-critic nets whose
    `net(obs) → (dist, value)`; returns
    `eval_fn(state, generator, num_envs=32, num_steps=default_eval_steps(env))`."""
    default_steps = default_eval_steps(env)

    def eval_fn(state: TrainState, generator: torch.Generator,
                num_envs: int = 32, num_steps: int = default_steps) -> torch.Tensor:
        act = lambda obs: state.net(obs)[0].mode()
        return evaluate(env, act, generator, num_envs, num_steps)

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


def fold_episodes(state: TrainState, traj: Transition) -> dict[str, torch.Tensor]:
    """`episode_metrics_update` on `state`'s accounting, written back in
    place; returns the episode metrics."""
    ep_return, ep_length, avg_return, metrics = episode_metrics_update(
        state.ep_return, state.ep_length, state.avg_return, traj
    )
    state.ep_return.copy_(ep_return)
    state.ep_length.copy_(ep_length)
    state.avg_return.copy_(avg_return)
    return metrics


def advance(state: TrainState) -> None:
    """Count one train step, on the device, in place."""
    state.step_counter.add_(1)
