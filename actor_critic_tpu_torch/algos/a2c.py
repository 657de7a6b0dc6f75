"""A2C — synchronous advantage actor-critic (counterpart of
`actor_critic_tpu/algos/a2c.py`).

One train step is

    rollout: T × [policy forward → categorical sample → batched env step]
    update:  truncation bootstrap → GAE (CUDA kernel) → policy-gradient +
             value-MSE + entropy loss → clip-by-global-norm + Adam

with `rollout` and `update` split, so a test can drive the update half
with another rollout's output. Everything but GAE is plain PyTorch on the
card, as the JAX package leaves it to XLA.

The step is capturable (`CAPTURABLE`): it keeps no host float and makes
no host sync, writes all it carries in place, and reads the annealed lr
and Adam's bias corrections from the state's schedule table at Adam's
count, the entropy coefficient at `state.step_counter`, both on the
device; on the card `algos/loop.py` runs it as one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from actor_critic_tpu_torch import resolve_device
from actor_critic_tpu_torch.algos.common import (
    ScheduleTable,
    TrainState,
    Transition,
    advance,
    anneal_fraction,
    fold_episodes,
    init_train_state,
    linear_anneal,
    make_actor_critic,
    make_mode_eval,
    rollout_loop,
    rollout_targets,
    schedule_table,
)
from actor_critic_tpu_torch.algos.metrics import aggregate_metrics
from actor_critic_tpu_torch.envs.env import TorchEnv
from actor_critic_tpu_torch.models.networks import ActorCriticDiscrete, ActorCriticGaussian
from actor_critic_tpu_torch.ops.returns import normalize_advantages
from actor_critic_tpu_torch.optim import ClippedAdam, linear_schedule

# `algos/loop.py` runs this trainer's step as one CUDA graph on the card.
CAPTURABLE = True

@dataclasses.dataclass(frozen=True)
class A2CConfig:
    """Same fields and defaults as the JAX `A2CConfig` (a test holds them
    equal); see that class for the reasoning behind each."""

    num_envs: int = 64
    rollout_steps: int = 16  # T
    gamma: float = 0.99
    gae_lambda: float = 0.95
    lr: float = 3e-4
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    max_grad_norm: float = 0.5
    hidden: tuple[int, ...] = (64, 64)
    normalize_adv: bool = False
    # Huber value loss with this delta (<=0 keeps plain MSE).
    value_huber_delta: float = 0.0
    # bfloat16 activations and matmuls (--update-dtype bf16); parameters,
    # optimizer state and every loss reduction stay float32.
    bf16_compute: bool = False
    # Linear annealing of lr → lr_final and entropy_coef →
    # entropy_coef_final over the first `anneal_iters` train steps (0 = off).
    anneal_iters: int = 0
    lr_final: Optional[float] = None
    entropy_coef_final: Optional[float] = None


def make_network(
    env: TorchEnv, cfg: A2CConfig, generator: Optional[torch.Generator] = None
) -> Union[ActorCriticDiscrete, ActorCriticGaussian]:
    """A categorical net (MLP or Nature-CNN torso) for discrete actions, a
    Gaussian one for continuous actions (`common.make_actor_critic`)."""
    return make_actor_critic(env.spec, cfg.hidden, cfg.bf16_compute, generator)


def make_eval_fn(env: TorchEnv, cfg: A2CConfig):
    """Greedy (mode-action) eval: `eval_fn(state, generator, num_envs, num_steps)`."""
    return make_mode_eval(env)


def make_optimizer(cfg: A2CConfig) -> ClippedAdam:
    lr = cfg.lr
    if cfg.anneal_iters > 0 and cfg.lr_final is not None:
        # One optimizer step per train iteration: the schedule's count IS
        # the iteration count.
        lr = linear_schedule(cfg.lr, cfg.lr_final, cfg.anneal_iters)
    return ClippedAdam(lr, cfg.max_grad_norm)


def entropy_coef_at(cfg: A2CConfig, update_step: int) -> float:
    """Current entropy coefficient under the linear anneal."""
    return linear_anneal(
        cfg.entropy_coef,
        cfg.entropy_coef_final,
        anneal_fraction(update_step, cfg.anneal_iters),
    )


def make_schedule(cfg: A2CConfig, device="cpu") -> ScheduleTable:
    """The optimizer's scalars by optimizer step (one per iteration) and
    the entropy coefficient by iteration."""
    return schedule_table(make_optimizer(cfg), [lambda i: entropy_coef_at(cfg, i)],
                          cfg.anneal_iters, torch.device(device))


def init_state(env: TorchEnv, cfg: A2CConfig, seed: int = 0, device="cuda") -> TrainState:
    """Fresh train state on `device`. The weights are drawn on the CPU from
    a generator seeded with `seed` (so they do not depend on the device);
    actions and resets come from a generator on `device`, seeded likewise."""
    device = resolve_device(device)
    net = make_network(env, cfg, torch.Generator().manual_seed(seed)).to(device)
    return init_train_state(env, net, make_optimizer(cfg), cfg.num_envs, seed, device,
                            make_schedule(cfg, device))


def _huber(pred: torch.Tensor, target: torch.Tensor, delta: float) -> torch.Tensor:
    """optax.losses.huber_loss."""
    abs_err = torch.abs(pred - target)
    quadratic = torch.clamp(abs_err, max=delta)
    linear = abs_err - quadratic
    return 0.5 * quadratic**2 + delta * linear


def a2c_loss(
    net: torch.nn.Module,
    traj: Transition,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    cfg: A2CConfig,
    entropy_coef: Union[float, torch.Tensor, None] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Policy-gradient + value-MSE (or Huber) + entropy-bonus loss on a
    [T, E] batch, float32 reductions; advantages and returns are
    gradient constants. `entropy_coef` (a float or a 0-dim tensor)
    overrides the config's."""
    if entropy_coef is None:
        entropy_coef = cfg.entropy_coef
    obs = traj.obs.reshape(-1, *traj.obs.shape[2:])
    actions = traj.action.reshape(-1, *traj.action.shape[2:])
    adv = advantages.detach().reshape(-1)
    ret = returns.detach().reshape(-1)
    if cfg.normalize_adv:
        adv = normalize_advantages(adv)

    dist, value = net(obs)
    log_prob = dist.log_prob(actions)
    entropy = torch.mean(dist.entropy(), dtype=torch.float32)
    pg_loss = -torch.mean(adv * log_prob, dtype=torch.float32)
    if cfg.value_huber_delta > 0:
        v_loss = torch.mean(_huber(value, ret, cfg.value_huber_delta), dtype=torch.float32)
    else:
        v_loss = 0.5 * torch.mean((value - ret) ** 2, dtype=torch.float32)
    loss = pg_loss + cfg.value_coef * v_loss - entropy_coef * entropy
    aux = {"loss": loss, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy}
    return loss, {k: v.detach() for k, v in aux.items()}


def rollout(env: TorchEnv, cfg: A2CConfig, state: TrainState) -> Transition:
    """Collect T steps with the current policy; advances `state.rollout` in place."""
    return rollout_loop(env, state.net, state.rollout, state.generator, cfg.rollout_steps)


def update(
    env: TorchEnv,
    cfg: A2CConfig,
    opt: ClippedAdam,
    state: TrainState,
    traj: Transition,
) -> dict[str, torch.Tensor]:
    """Targets, one clipped-Adam step on `a2c_loss`, and episode accounting
    for a rollout `traj` whose next obs is `state.rollout.obs`. Updates
    `state` in place; returns the metrics as device tensors."""
    net = state.net
    advantages, returns = rollout_targets(
        env, net, traj, state.rollout.obs, cfg.gamma, cfg.gae_lambda
    )
    params = dict(net.named_parameters())
    entropy_coef = state.schedule.coefficients_at(state.step_counter)[0]
    loss, metrics = a2c_loss(net, traj, advantages, returns, cfg, entropy_coef)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    opt.step(params, grads, state.opt_state, state.schedule.optimizer)

    ep_metrics = fold_episodes(state, traj)
    advance(state)
    return aggregate_metrics(metrics, ep_metrics)


def make_train_step(
    env: TorchEnv, cfg: A2CConfig
) -> Callable[[TrainState], tuple[TrainState, dict[str, torch.Tensor]]]:
    """`train_step(state) -> (state, metrics)`: rollout then update."""
    opt = make_optimizer(cfg)

    def train_step(state: TrainState) -> tuple[TrainState, dict[str, torch.Tensor]]:
        traj = rollout(env, cfg, state)
        return state, update(env, cfg, opt, state, traj)

    return train_step


def train(
    env: TorchEnv,
    cfg: A2CConfig,
    num_iterations: int,
    seed: int = 0,
    device="cuda",
    state: Optional[TrainState] = None,
    log_every: int = 0,
    log_fn: Optional[Callable[[int, dict], None]] = None,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """The host loop around the train step (single device)."""
    from actor_critic_tpu_torch.algos.loop import fused_train_loop

    return fused_train_loop(
        make_train_step, init_state, env, cfg, num_iterations,
        seed=seed, device=device, state=state, log_every=log_every, log_fn=log_fn,
        capturable=CAPTURABLE,
    )
