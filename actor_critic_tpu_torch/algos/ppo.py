"""PPO-clip, fused (counterpart of the fused trainer in
`actor_critic_tpu/algos/ppo.py`; its host-env, async and device-data-plane
trainers come with the host and async slices).

One train step is

    rollout: T × [policy forward → sample → batched env step]
    update:  truncation bootstrap → GAE (CUDA kernel) → E epochs × M
             shuffled minibatches of [clipped surrogate + clipped value
             loss + entropy bonus → clip-by-global-norm + Adam(eps 1e-5)]

`ppo_update` takes the epochs' permutations as an [epochs, B] index tensor;
the train step draws them from the trainer's generator
(`draw_permutations`), so a test can hand in `jax.random.permutation`'s.
The learning rate anneals per optimizer step (over anneal_iters · epochs ·
minibatches steps), clip-ε and the entropy coefficient per iteration; the
step reads all of them, and Adam's bias corrections, from the state's
schedule table on the device (at Adam's count and at `step_counter`), so
it is capturable (`CAPTURABLE`) and runs as one CUDA graph on the card
(`algos/loop.py`).

`should_unroll_update` has no counterpart: it unrolls the epoch/minibatch
`lax.scan`s where XLA:CPU cannot use its fast convolution inside a scan
body. Here the nest is a Python loop, unrolled by nature.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

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
from actor_critic_tpu_torch.envs.env import EnvSpec, TorchEnv
from actor_critic_tpu_torch.models.networks import ActorCriticDiscrete, ActorCriticGaussian
from actor_critic_tpu_torch.ops.returns import LOG_RATIO_CAP, normalize_advantages
from actor_critic_tpu_torch.optim import AdamState, ClippedAdam, linear_schedule

# `algos/loop.py` runs this trainer's step as one CUDA graph on the card.
CAPTURABLE = True
Scalar = Union[float, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Same fields and defaults as the JAX `PPOConfig` (a test holds them
    equal); see that class for the reasoning behind each."""

    num_envs: int = 64
    rollout_steps: int = 128  # T
    epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_clip: float = 0.2  # <=0 disables value clipping
    lr: float = 3e-4
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: tuple[int, ...] = (64, 64)
    normalize_adv: bool = True
    # bfloat16 activations: not ported yet (make_network raises).
    bf16_compute: bool = False
    # Linear annealing over the first `anneal_iters` iterations (0 = off):
    # lr → lr_final (per optimizer step, scaled by epochs×minibatches),
    # clip_eps → clip_eps_final and entropy_coef → entropy_coef_final.
    anneal_iters: int = 0
    lr_final: Optional[float] = None
    clip_eps_final: Optional[float] = None
    entropy_coef_final: Optional[float] = None


class PPOBatch(NamedTuple):
    """Flattened experience batch for the update loop ([B, ...])."""

    obs: torch.Tensor
    action: torch.Tensor
    log_prob_old: torch.Tensor
    value_old: torch.Tensor
    advantage: torch.Tensor
    ret: torch.Tensor


def make_network(
    env_spec: EnvSpec, cfg: PPOConfig, generator: Optional[torch.Generator] = None
) -> Union[ActorCriticDiscrete, ActorCriticGaussian]:
    """A shared-torso categorical net for discrete actions, separate actor
    and critic torsos with a Gaussian head for continuous ones
    (`common.make_actor_critic`)."""
    return make_actor_critic(env_spec, cfg.hidden, cfg.bf16_compute, generator)


def make_eval_fn(env: TorchEnv, cfg: PPOConfig):
    """Greedy (mode-action) eval: `eval_fn(state, generator, num_envs, num_steps)`."""
    return make_mode_eval(env)


def make_optimizer(cfg: PPOConfig) -> ClippedAdam:
    lr = cfg.lr
    if cfg.anneal_iters > 0 and cfg.lr_final is not None:
        # The optimizer steps epochs×minibatches times per iteration, so
        # the schedule horizon is in optimizer steps, not iterations.
        lr = linear_schedule(
            cfg.lr, cfg.lr_final, cfg.anneal_iters * cfg.epochs * cfg.num_minibatches
        )
    return ClippedAdam(lr, cfg.max_grad_norm, eps=1e-5)


def clip_eps_at(cfg: PPOConfig, progress: Optional[float]) -> float:
    """Current clip-ε under the linear anneal; `progress` per the
    `common.anneal_fraction` contract."""
    return linear_anneal(cfg.clip_eps, cfg.clip_eps_final, progress)


def entropy_coef_at(cfg: PPOConfig, progress: Optional[float]) -> float:
    """Current entropy coefficient under the linear anneal."""
    return linear_anneal(cfg.entropy_coef, cfg.entropy_coef_final, progress)


def anneal_progress(cfg: PPOConfig, update_step: int) -> Optional[float]:
    """update_step → clipped [0, 1] anneal fraction (None when off)."""
    return anneal_fraction(update_step, cfg.anneal_iters)


def make_schedule(cfg: PPOConfig, device="cpu") -> ScheduleTable:
    """The optimizer's scalars by optimizer step, and (clip-ε, entropy
    coefficient) by iteration."""
    return schedule_table(
        make_optimizer(cfg),
        [lambda i: clip_eps_at(cfg, anneal_progress(cfg, i)),
         lambda i: entropy_coef_at(cfg, anneal_progress(cfg, i))],
        cfg.anneal_iters, torch.device(device),
    )


def init_state(env: TorchEnv, cfg: PPOConfig, seed: int = 0, device="cuda") -> TrainState:
    """Fresh train state on `device`. The weights are drawn on the CPU from
    a generator seeded with `seed` (so they do not depend on the device);
    actions, resets and minibatch permutations come from a generator on
    `device`, seeded likewise."""
    device = resolve_device(device)
    net = make_network(env.spec, cfg, torch.Generator().manual_seed(seed)).to(device)
    return init_train_state(env, net, make_optimizer(cfg), cfg.num_envs, seed, device,
                            make_schedule(cfg, device))


def ppo_loss(
    net: Callable,
    batch: PPOBatch,
    cfg: PPOConfig,
    clip_eps: Optional[Scalar] = None,
    entropy_coef: Optional[Scalar] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Clipped-surrogate + clipped-value + entropy loss on a minibatch, with
    float32 means. `clip_eps` / `entropy_coef` (floats or 0-dim tensors)
    override the config's constants."""
    if clip_eps is None:
        clip_eps = cfg.clip_eps
    if entropy_coef is None:
        entropy_coef = cfg.entropy_coef
    dist, value = net(batch.obs)
    log_prob = dist.log_prob(batch.action)
    entropy = torch.mean(dist.entropy(), dtype=torch.float32)

    adv = batch.advantage
    if cfg.normalize_adv:
        adv = normalize_advantages(adv)

    log_ratio = log_prob - batch.log_prob_old
    # The cap keeps exp from overflowing to inf under policy drift (and
    # inf · 0 from turning into nan); it changes no in-range ratio.
    ratio = torch.exp(torch.clamp(log_ratio, max=LOG_RATIO_CAP))
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    pg_loss = -torch.mean(torch.minimum(surr1, surr2), dtype=torch.float32)

    if cfg.vf_clip > 0:
        v_clipped = batch.value_old + torch.clamp(
            value - batch.value_old, -cfg.vf_clip, cfg.vf_clip
        )
        v_loss = 0.5 * torch.mean(
            torch.maximum((value - batch.ret) ** 2, (v_clipped - batch.ret) ** 2),
            dtype=torch.float32,
        )
    else:
        v_loss = 0.5 * torch.mean((value - batch.ret) ** 2, dtype=torch.float32)

    loss = pg_loss + cfg.value_coef * v_loss - entropy_coef * entropy
    # Schulman's low-variance KL estimator: E[(r-1) - log r].
    approx_kl = torch.mean((ratio - 1.0) - log_ratio, dtype=torch.float32)
    clip_frac = torch.mean((torch.abs(ratio - 1.0) > clip_eps).to(torch.float32))
    aux = {
        "loss": loss,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": entropy,
        "approx_kl": approx_kl,
        "clip_frac": clip_frac,
    }
    return loss, {k: v.detach() for k, v in aux.items()}


def draw_permutations(generator: torch.Generator, epochs: int, batch_size: int) -> torch.Tensor:
    """[epochs, B] int64, a uniform permutation of range(B) per epoch drawn
    from `generator` on its device: the argsort of uniform keys (one draw
    and one sort, both capturable in a CUDA graph)."""
    keys = torch.rand((epochs, batch_size), generator=generator, device=generator.device)
    return torch.argsort(keys, dim=-1, stable=True)


def ppo_update(
    net: torch.nn.Module,
    opt: ClippedAdam,
    opt_state: AdamState,
    batch: PPOBatch,
    perms: torch.Tensor,
    cfg: PPOConfig,
    opt_table: torch.Tensor,
    clip_eps: Optional[Scalar] = None,
    entropy_coef: Optional[Scalar] = None,
) -> dict[str, torch.Tensor]:
    """E epochs × M shuffled minibatches of PPO updates, applied in place to
    `net`'s parameters and `opt_state`; returns the metrics' mean over the
    [E, M] nest.

    The batch size B must be divisible by num_minibatches. Epoch e's
    minibatch j is `perms[e, j·mb:(j+1)·mb]` (JAX reshapes its permutation
    to [M, mb] the same way). `opt_table` is `opt.scalar_table()` on the
    parameters' device, which each step reads at `opt_state.count`."""
    B = batch.obs.shape[0]
    M = cfg.num_minibatches
    if B % M != 0:
        raise ValueError(f"batch {B} % minibatches {M} != 0")
    mb = B // M
    params = dict(net.named_parameters())
    history = []
    for e in range(cfg.epochs):
        for j in range(M):
            idx = perms[e, j * mb:(j + 1) * mb]
            loss, metrics = ppo_loss(
                net, PPOBatch(*(x[idx] for x in batch)), cfg, clip_eps, entropy_coef
            )
            grads = torch.autograd.grad(loss, list(params.values()))
            opt.step(params, dict(zip(params, grads)), opt_state, opt_table)
            history.append(metrics)
    return {k: torch.mean(torch.stack([m[k] for m in history])) for k in history[0]}


def rollout(env: TorchEnv, cfg: PPOConfig, state: TrainState) -> Transition:
    """Collect T steps with the current policy; advances `state.rollout` in place."""
    return rollout_loop(env, state.net, state.rollout, state.generator, cfg.rollout_steps)


def update(
    env: TorchEnv,
    cfg: PPOConfig,
    opt: ClippedAdam,
    state: TrainState,
    traj: Transition,
    perms: Optional[torch.Tensor] = None,
) -> dict[str, torch.Tensor]:
    """Targets, `ppo_update` and episode accounting for a rollout `traj`
    whose next obs is `state.rollout.obs`, with the schedule's values at
    `state.step_counter`. Draws the permutations from `state.generator`
    unless `perms` is given. Updates `state` in place; returns the
    metrics as device tensors."""
    net = state.net
    advantages, returns = rollout_targets(
        env, net, traj, state.rollout.obs, cfg.gamma, cfg.gae_lambda
    )
    T, E = traj.reward.shape
    batch = PPOBatch(
        obs=traj.obs.reshape(T * E, *traj.obs.shape[2:]),
        action=traj.action.reshape(T * E, *traj.action.shape[2:]),
        log_prob_old=traj.log_prob.reshape(T * E),
        value_old=traj.value.reshape(T * E),
        advantage=advantages.reshape(T * E),
        ret=returns.reshape(T * E),
    )
    if perms is None:
        perms = draw_permutations(state.generator, cfg.epochs, T * E)
    clip_eps, entropy_coef = state.schedule.coefficients_at(state.step_counter).unbind()
    metrics = ppo_update(net, opt, state.opt_state, batch, perms, cfg, state.schedule.optimizer,
                         clip_eps, entropy_coef)
    ep_metrics = fold_episodes(state, traj)
    advance(state)
    return aggregate_metrics(metrics, ep_metrics)


def make_train_step(
    env: TorchEnv, cfg: PPOConfig
) -> Callable[[TrainState], tuple[TrainState, dict[str, torch.Tensor]]]:
    """`train_step(state) -> (state, metrics)`: rollout then update."""
    opt = make_optimizer(cfg)

    def train_step(state: TrainState) -> tuple[TrainState, dict[str, torch.Tensor]]:
        traj = rollout(env, cfg, state)
        return state, update(env, cfg, opt, state, traj)

    return train_step


def train(
    env: TorchEnv,
    cfg: PPOConfig,
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
