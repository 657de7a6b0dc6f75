"""IMPALA / A3C — the decoupled actor-learner trainer (counterpart of
`actor_critic_tpu/algos/impala.py`).

As in the JAX package, the N parallel actors are the env batch of one
rollout, and the actors' policy lag is explicit and deterministic: they run
a STALE copy of the learner's network (`actor_net`, a second module),
refreshed from the learner when `update_step % actor_refresh_every == 0`.
Behaviour log-probs are recorded at rollout time, and the learner
re-evaluates π and V at the stored observations, so one train step is

    rollout: T × [stale-actor forward → categorical sample → env step]
    update:  learner forward at obs (with grad), at the next obs and at
             final_obs (without) → truncation bootstrap → V-trace (CUDA
             kernel) or GAE → pg + value-MSE + entropy loss →
             clip-by-global-norm + RMSProp → actor refresh

`correction="vtrace"` is IMPALA; `"none"` is the A3C rule, λ-return GAE
under the learner's critic with no importance weighting. The
sequence-parallel learner (`make_sp_update`, `make_sp_train_step`) comes
with the multi-GPU slice.

The step is capturable (`CAPTURABLE`): the actor refresh is a select on
the device at the state's step counter, not a host branch, and writes the
actors' parameters in place; RMSProp reads only its constant lr and
writes `nu` in place; Pong's step reads no host value. On the card
`algos/loop.py` runs it as one CUDA graph, held equal to the eager step
there by `chip_smoke.py`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Union

import torch
from torch import nn

from actor_critic_tpu_torch import resolve_device
from actor_critic_tpu_torch.algos.common import (
    TrainState,
    Transition,
    advance,
    corrected_advantages,
    fold_episodes,
    init_rollout,
    make_actor_critic,
    make_mode_eval,
    rollout_loop,
    truncation_bootstrap_rewards,
)
from actor_critic_tpu_torch.algos.metrics import aggregate_metrics
from actor_critic_tpu_torch.envs.env import TorchEnv
from actor_critic_tpu_torch.models.networks import ActorCriticDiscrete, ActorCriticGaussian
from actor_critic_tpu_torch.optim import ClippedRMSProp

# `algos/loop.py` runs this trainer's step as one CUDA graph on the card.
CAPTURABLE = True

@dataclasses.dataclass(frozen=True)
class ImpalaConfig:
    """Same fields and defaults as the JAX `ImpalaConfig` (a test holds them
    equal); see that class for the reasoning behind each."""

    num_envs: int = 32          # the "N parallel actors"
    rollout_steps: int = 20     # IMPALA's unroll length
    gamma: float = 0.99
    lr: float = 6e-4
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    rho_bar: float = 1.0        # V-trace ρ̄ clip
    c_bar: float = 1.0          # V-trace c̄ clip
    lam: float = 1.0            # V-trace λ (1.0 = canonical IMPALA)
    actor_refresh_every: int = 1  # k-step policy lag (1 = on-policy)
    correction: str = "vtrace"  # "vtrace" (IMPALA) | "none" (A3C)
    max_grad_norm: float = 40.0
    hidden: tuple[int, ...] = (64, 64)
    # RMSProp decay/epsilon: the IMPALA paper's published settings.
    rms_decay: float = 0.99
    rms_eps: float = 0.1
    # bfloat16 activations and matmuls (--update-dtype bf16); parameters,
    # optimizer state and every loss reduction stay float32.
    bf16_compute: bool = False

    def __post_init__(self):
        if self.correction not in ("vtrace", "none"):
            raise ValueError(f"unknown correction: {self.correction!r}")
        if self.actor_refresh_every < 1:
            raise ValueError("actor_refresh_every must be >= 1")


@dataclasses.dataclass
class ImpalaTrainState(TrainState):
    """`TrainState` (whose `net` is the learner) plus the actors' stale copy."""

    actor_net: nn.Module


def make_network(
    env: TorchEnv, cfg: ImpalaConfig, generator: Optional[torch.Generator] = None
) -> Union[ActorCriticDiscrete, ActorCriticGaussian]:
    """A categorical net (MLP or Nature-CNN torso) for discrete actions, a
    Gaussian one for continuous actions (`common.make_actor_critic`)."""
    return make_actor_critic(env.spec, cfg.hidden, cfg.bf16_compute, generator)


def make_eval_fn(env: TorchEnv, cfg: ImpalaConfig):
    """Greedy (mode-action) eval of the learner:
    `eval_fn(state, generator, num_envs, num_steps)`."""
    return make_mode_eval(env)


def make_optimizer(cfg: ImpalaConfig) -> ClippedRMSProp:
    return ClippedRMSProp(cfg.lr, cfg.max_grad_norm, cfg.rms_decay, cfg.rms_eps)


def init_state(env: TorchEnv, cfg: ImpalaConfig, seed: int = 0, device="cuda") -> ImpalaTrainState:
    """Fresh train state on `device`. The weights are drawn on the CPU from
    a generator seeded with `seed`; actions, resets and serves come from a
    generator on `device`, seeded likewise. The actors start in sync."""
    device = resolve_device(device)
    net = make_network(env, cfg, torch.Generator().manual_seed(seed)).to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    E = cfg.num_envs
    return ImpalaTrainState(
        net=net,
        opt_state=make_optimizer(cfg).init(dict(net.named_parameters())),
        rollout=init_rollout(env, generator, E),
        generator=generator,
        ep_return=torch.zeros(E, device=device),
        ep_length=torch.zeros(E, device=device),
        avg_return=torch.zeros((), device=device),
        step_counter=torch.zeros(1, dtype=torch.int64, device=device),
        actor_net=copy.deepcopy(net).requires_grad_(False),
    )


def impala_loss(
    net: nn.Module,
    traj: Transition,
    bootstrap_obs: torch.Tensor,
    cfg: ImpalaConfig,
    can_truncate: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """V-trace (or A3C λ-return) actor-critic loss on a [T, E] trajectory.

    The learner re-evaluates π/V at `traj.obs`; `traj.log_prob` holds the
    BEHAVIOUR policy's log-probs from rollout time, so the ratios π/μ are
    exact under any staleness. V-trace takes the learner's (detached)
    values, the bootstrap from the learner at `bootstrap_obs`, and the
    truncation bootstrap from the learner's critic at `final_obs`; those
    two forwards need no gradient (their values only reach the loss as
    gradient constants) and run without one."""
    T, E = traj.reward.shape
    obs = traj.obs.reshape(T * E, *traj.obs.shape[2:])
    actions = traj.action.reshape(T * E, *traj.action.shape[2:])

    dist, values = net(obs)
    target_log_probs = dist.log_prob(actions).reshape(T, E)
    values = values.reshape(T, E)
    entropy = torch.mean(dist.entropy(), dtype=torch.float32)
    with torch.no_grad():
        _, bootstrap_value = net(bootstrap_obs)
        if can_truncate:
            flat_final = traj.final_obs.reshape(T * E, *traj.final_obs.shape[2:])
            _, final_values = net(flat_final)
            rewards = truncation_bootstrap_rewards(traj, final_values.reshape(T, E), cfg.gamma)
        else:
            rewards = traj.reward

    pg_advantages, value_targets, mean_rho = corrected_advantages(
        target_log_probs.detach(), traj.log_prob, rewards, values.detach(), traj.done,
        bootstrap_value, cfg.gamma, cfg.lam,
        rho_bar=cfg.rho_bar, c_bar=cfg.c_bar, correction=cfg.correction,
    )

    pg_loss = -torch.mean(pg_advantages * target_log_probs, dtype=torch.float32)
    v_loss = 0.5 * torch.mean((values - value_targets) ** 2, dtype=torch.float32)
    loss = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    aux = {"loss": loss, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy,
           "mean_rho": mean_rho}
    return loss, {k: v.detach() for k, v in aux.items()}


def rollout(env: TorchEnv, cfg: ImpalaConfig, state: ImpalaTrainState) -> Transition:
    """Collect T steps with the actors' stale network; advances
    `state.rollout` in place. `traj.log_prob` is the behaviour policy's."""
    return rollout_loop(env, state.actor_net, state.rollout, state.generator, cfg.rollout_steps)


def update(
    env: TorchEnv,
    cfg: ImpalaConfig,
    opt: ClippedRMSProp,
    state: ImpalaTrainState,
    traj: Transition,
) -> dict[str, torch.Tensor]:
    """One clipped-RMSProp step on `impala_loss` for a rollout `traj` whose
    next obs is `state.rollout.obs`, the actor refresh at its boundary, and
    episode accounting. Updates `state` in place; returns the metrics as
    device tensors."""
    net = state.net
    params = dict(net.named_parameters())
    loss, metrics = impala_loss(net, traj, state.rollout.obs, cfg, env.spec.can_truncate)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    opt.step(params, grads, state.opt_state)

    # k-step policy lag: the actors pick up the learner's parameters only at
    # refresh boundaries (k=1 is on-policy: every ρ is exactly 1), selected
    # on the device.
    advance(state)
    refresh = state.step_counter % cfg.actor_refresh_every == 0
    with torch.no_grad():
        for a, p in zip(state.actor_net.parameters(), net.parameters()):
            a.copy_(torch.where(refresh, p, a))

    return aggregate_metrics(metrics, fold_episodes(state, traj))


def make_train_step(
    env: TorchEnv, cfg: ImpalaConfig
) -> Callable[[ImpalaTrainState], tuple[ImpalaTrainState, dict[str, torch.Tensor]]]:
    """`train_step(state) -> (state, metrics)`: stale-actor rollout, then
    the learner's update."""
    opt = make_optimizer(cfg)

    def train_step(state: ImpalaTrainState) -> tuple[ImpalaTrainState, dict[str, torch.Tensor]]:
        traj = rollout(env, cfg, state)
        return state, update(env, cfg, opt, state, traj)

    return train_step


def train(
    env: TorchEnv,
    cfg: ImpalaConfig,
    num_iterations: int,
    seed: int = 0,
    device="cuda",
    state: Optional[ImpalaTrainState] = None,
    log_every: int = 0,
    log_fn: Optional[Callable[[int, dict], None]] = None,
) -> tuple[ImpalaTrainState, dict[str, torch.Tensor]]:
    """The host loop around the train step (single device)."""
    from actor_critic_tpu_torch.algos.loop import fused_train_loop

    return fused_train_loop(
        make_train_step, init_state, env, cfg, num_iterations,
        seed=seed, device=device, state=state, log_every=log_every, log_fn=log_fn,
        capturable=CAPTURABLE,
    )


# -- the warm-up registry (utils/compile_cache.py) ---------------------------
# V-trace for IMPALA, GAE for A3C (`correction="none"`).
from actor_critic_tpu_torch.utils import compile_cache as _compile_cache  # noqa: E402

_compile_cache.register_fused_warmups(
    "impala", ("impala", "a3c"),
    lambda cfg: ("vtrace",) if cfg.correction == "vtrace" else ("gae",))
