"""Shared trainer plumbing (counterpart of `actor_critic_tpu/algos/common.py`).

The JAX package scans T steps of (policy forward → vmapped env step)
inside one jitted program. Here the rollout is a Python loop over T of
batched tensor ops on the card; the advantage seam `gae_targets` goes
through the hand-written GAE kernel (`ops/gae_cuda.py`).

Unlike JAX's immutable pytrees, `TrainState` is a mutable dataclass: the
network's parameters and the optimizer moments are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from actor_critic_tpu_torch.envs.env import TorchEnv
from actor_critic_tpu_torch.ops import gae_cuda
from actor_critic_tpu_torch.optim import AdamState


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


@dataclasses.dataclass
class TrainState:
    """On-policy trainer state. Total env steps = update_step · T · E."""

    net: nn.Module
    opt_state: AdamState
    rollout: RolloutState
    generator: torch.Generator  # on the trainer's device: actions and resets
    update_step: int  # number of train_step calls
    # Running episode-return accounting (per env).
    ep_return: torch.Tensor
    ep_length: torch.Tensor
    # Exponential-moving average of completed-episode returns (0-dim).
    avg_return: torch.Tensor


def init_rollout(env: TorchEnv, generator: torch.Generator, num_envs: int) -> RolloutState:
    env_state, obs = env.reset(num_envs, generator)
    return RolloutState(env_state=env_state, obs=obs)


@torch.no_grad()
def rollout_loop(
    env: TorchEnv,
    net: nn.Module,
    rstate: RolloutState,
    generator: torch.Generator,
    num_steps: int,
) -> tuple[RolloutState, Transition]:
    """Collect `num_steps` of experience from the env batch (the
    counterpart of `rollout_scan`). `net(obs) -> (dist, value)`; actions
    are sampled from `generator`. Returns time-major [T, E, ...] arrays."""
    steps = []
    for _ in range(num_steps):
        dist, value = net(rstate.obs)
        action = dist.sample(generator)
        log_prob = dist.log_prob(action)
        out = env.step(rstate.env_state, action, generator)
        steps.append(Transition(
            obs=rstate.obs,
            action=action,
            log_prob=log_prob,
            value=value,
            reward=out.reward,
            done=out.done,
            terminated=out.info["terminated"],
            final_obs=out.info["final_obs"],
        ))
        rstate = RolloutState(env_state=out.state, obs=out.obs)
    return rstate, Transition(*(torch.stack(field) for field in zip(*steps)))


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
