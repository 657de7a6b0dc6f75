"""SAC — soft actor-critic with twin critics and an automatic entropy
temperature (counterpart of `actor_critic_tpu/algos/sac.py`). Same shape as
`algos/ddpg.py`: the ring lives on the device, and one train step is
collect → insert → J soft policy-iteration updates, each

    critic:  y = r + γ(1−term)·[min(Q̄₁,Q̄₂)(s′, a′) − α·log π(a′|s′)],
             a′ ~ π(·|s′), a fresh sample from the pre-update actor
    actor:   min E[α·log π(a|s) − min(Q₁,Q₂)(s, a)], reparameterised,
             through the updated critic
    alpha:   log α by Adam on the analytic gradient −α·E[log π + H_target]
             (H_target = −action_dim by default), with the actor loss's
             log π and the pre-update α; skipped with `fixed_alpha`
    targets: Polyak on the twin critic, last (SAC has no target actor)

The warm-up gate `do_update` is a 0-dim bool on the device and every
parameter, moment, count, target and `log_alpha` takes its new value
through a `torch.where` on it, in place. The step is capturable
(`CAPTURABLE`); the draws of one update (ring slots and the two
standard-normal noises) come from the trainer's generator through
`draw_update`, or from a test through `apply_update`. The host env path
(`train_host`) runs the same update loop on each uploaded block, as
`ddpg.train_host` does, and `train_host_async` with actor threads, as
`ddpg.train_host_async` does.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from actor_critic_tpu_torch import replay, resolve_device
from actor_critic_tpu_torch.algos.common import OffPolicyState, compute_dtype, make_greedy_eval
from actor_critic_tpu_torch.algos.ddpg import (
    collect_and_insert,
    example_transition,
    finish_step,
    grad_syncs,
    grads_of,
    ingest_update_of,
    init_offpolicy_state,
    params_of,
    update_gate,
)
from actor_critic_tpu_torch.envs.env import DeviceTable, TorchEnv
from actor_critic_tpu_torch.models.networks import SquashedGaussianActor, TwinQ
from actor_critic_tpu_torch.ops.polyak import polyak_update
from actor_critic_tpu_torch.optim import Adam, AdamState
from actor_critic_tpu_torch.parallel.mesh import Group, pmean

# `algos/loop.py` runs this trainer's step as one CUDA graph on the card.
CAPTURABLE = True

# The fused trainer's state: the same fields as DDPG/TD3's.
SACState = OffPolicyState


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """Same fields and defaults as the JAX `SACConfig` (a test holds them
    equal), with its checks; see that class for the reasoning behind each."""

    num_envs: int = 8
    steps_per_iter: int = 8
    updates_per_iter: int = 8
    buffer_capacity: int = 1_000_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    hidden: tuple[int, ...] = (256, 256)
    warmup_steps: int = 1_000
    init_alpha: float = 1.0
    # None → auto-tune toward target_entropy (default −action_dim); a float
    # freezes α at that value (no temperature step).
    fixed_alpha: Optional[float] = None
    target_entropy: Optional[float] = None
    # bfloat16 activations and matmuls (--update-dtype bf16); parameters,
    # targets and Adam state stay float32.
    bf16_compute: bool = False
    # Replay storage codecs: "fp32" | "mixed" | "int8" (replay/quantize.py).
    replay_dtype: str = "fp32"

    def __post_init__(self):
        if self.init_alpha <= 0.0:
            raise ValueError("init_alpha must be > 0 (α is parameterized in log)")
        if self.fixed_alpha is not None and self.fixed_alpha <= 0.0:
            raise ValueError("fixed_alpha must be > 0 (α is parameterized in log)")


@dataclasses.dataclass
class SACLearnerState:
    """The SAC learner on the device (actor, twin critic and its target,
    both Adam states, log α and its Adam state, the ring, the update
    count). Written in place."""

    actor: SquashedGaussianActor
    critic: TwinQ
    target_critic: TwinQ
    actor_opt: AdamState
    critic_opt: AdamState
    log_alpha: torch.Tensor  # 0-dim float32
    alpha_opt: AdamState
    replay: replay.ReplayState
    update_count: torch.Tensor  # 0-dim int64


class SACDraws(NamedTuple):
    """What one update draws: the ring slots of its batch, and the standard
    normals [B, A] of the target's next-action sample and of the actor
    loss's sample."""

    idx: torch.Tensor
    target_eps: torch.Tensor
    actor_eps: torch.Tensor


def _target_entropy(action_dim: int, cfg: SACConfig) -> float:
    return cfg.target_entropy if cfg.target_entropy is not None else -float(action_dim)


def make_networks(
    obs_dim: int, action_dim: int, cfg: SACConfig, generator: Optional[torch.Generator] = None
) -> tuple[SquashedGaussianActor, TwinQ]:
    """The tanh-Gaussian actor and the twin critic, weights drawn from
    `generator` in that order, both computing in bf16 with `bf16_compute`."""
    dtype = compute_dtype(cfg.bf16_compute)
    return (SquashedGaussianActor(obs_dim, action_dim, cfg.hidden, generator, dtype),
            TwinQ(obs_dim, action_dim, cfg.hidden, generator, dtype))


def init_learner(
    obs_shape: tuple[int, ...], action_dim: int, cfg: SACConfig,
    generator: Optional[torch.Generator] = None, device="cuda",
) -> SACLearnerState:
    """A fresh learner on `device`, weights drawn on the CPU from
    `generator`; log α starts at log(init_alpha), or log(fixed_alpha)."""
    device = resolve_device(device)
    actor, critic = (m.to(device) for m in make_networks(obs_shape[-1], action_dim, cfg, generator))
    alpha = cfg.init_alpha if cfg.fixed_alpha is None else cfg.fixed_alpha
    log_alpha = torch.log(torch.tensor(alpha, dtype=torch.float32)).to(device)
    return SACLearnerState(
        actor=actor,
        critic=critic,
        target_critic=copy.deepcopy(critic),
        actor_opt=Adam(cfg.actor_lr).init(dict(actor.named_parameters())),
        critic_opt=Adam(cfg.critic_lr).init(dict(critic.named_parameters())),
        log_alpha=log_alpha,
        alpha_opt=Adam(cfg.alpha_lr).init({"log_alpha": log_alpha}),
        replay=replay.init(example_transition(obs_shape, action_dim, device),
                           cfg.buffer_capacity, replay.offpolicy_codecs(cfg.replay_dtype)),
        update_count=torch.zeros((), dtype=torch.int64, device=device),
    )


def init_state(env: TorchEnv, cfg: SACConfig, seed: int = 0, device="cuda") -> SACState:
    """Fresh train state on `device` (weights from a CPU generator seeded
    with `seed`, everything drawn during training from a generator on
    `device`, seeded likewise)."""
    device = resolve_device(device)
    learner = init_learner(env.spec.obs_shape, env.spec.action_dim, cfg,
                           torch.Generator().manual_seed(seed), device)
    return init_offpolicy_state(env, learner, cfg.num_envs, seed, device)


def make_eval_fn(env: TorchEnv, cfg: SACConfig):
    """Greedy (tanh-mean) eval: `eval_fn(state, generator, num_envs,
    num_steps)`, replayed as CUDA graphs on the card."""
    return make_greedy_eval(env, lambda actor, obs: actor(obs).mode(), lambda s: s.learner.actor)


def make_explore_fn(cfg: SACConfig):
    """The behaviour policy `act(actor, obs, generator, env_steps)`: a
    sample of the tanh-Gaussian; uniform actions in [−1, 1) while
    `env_steps < warmup_steps` (a select on the device)."""

    def act(actor: nn.Module, obs: torch.Tensor, generator: torch.Generator,
            env_steps: torch.Tensor) -> torch.Tensor:
        a = actor(obs).sample(generator)
        u = torch.rand(a.shape, generator=generator, device=a.device)
        return torch.where(env_steps < cfg.warmup_steps, u * 2.0 - 1.0, a)

    return act


def make_update_loop(action_dim: int, cfg: SACConfig, group: Group = None):
    """`update_loop(learner, do_update, generator) -> metrics`:
    `cfg.updates_per_iter` soft policy-iteration steps, the learner written
    in place, the metrics the last update's; `update_loop.draw_update` and
    `update_loop.apply_update` are one update's halves (see
    `ddpg.make_update_loop`). With a data-parallel `group` the critic's
    and the actor's gradients and α's are pmean'd over it."""
    h_target = _target_entropy(action_dim, cfg)
    codecs = replay.offpolicy_codecs(cfg.replay_dtype)
    opts = {"actor": Adam(cfg.actor_lr), "critic": Adam(cfg.critic_lr), "alpha": Adam(cfg.alpha_lr)}
    tables = {k: DeviceTable(o.scalar_table()) for k, o in opts.items()}
    syncs = grad_syncs(group, "critic", "actor")

    def draw_update(ls: SACLearnerState, generator: torch.Generator) -> SACDraws:
        idx = replay.draw_indices(generator, cfg.batch_size, ls.replay.size)
        normal = lambda: torch.randn((cfg.batch_size, action_dim), generator=generator,
                                     device=generator.device)
        return SACDraws(idx, normal(), normal())

    def apply_update(ls: SACLearnerState, do_update: torch.Tensor,
                     draws: SACDraws) -> dict[str, torch.Tensor]:
        batch = replay.sample_at(ls.replay, draws.idx, codecs)
        device = batch.reward.device
        alpha = torch.exp(ls.log_alpha)

        # Soft TD target: a fresh sample from the pre-update actor.
        with torch.no_grad():
            next_a, next_logp = ls.actor(batch.next_obs).sample_and_log_prob(eps=draws.target_eps)
            tq1, tq2 = ls.target_critic(batch.next_obs, next_a)
            next_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = batch.reward + cfg.gamma * (1.0 - batch.terminated) * next_v

        # Critic step.
        q1, q2 = ls.critic(batch.obs, batch.action)
        closs = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
        opts["critic"].step(params_of(ls.critic), grads_of(closs, ls.critic, syncs["critic"]),
                            ls.critic_opt, tables["critic"].on(device), mask=do_update)

        # Actor step: a reparameterised sample through the updated critic.
        a, logp = ls.actor(batch.obs).sample_and_log_prob(eps=draws.actor_eps)
        aq1, aq2 = ls.critic(batch.obs, a)
        aloss = torch.mean(alpha * logp - torch.minimum(aq1, aq2))
        opts["actor"].step(params_of(ls.actor), grads_of(aloss, ls.actor, syncs["actor"]),
                           ls.actor_opt, tables["actor"].on(device), mask=do_update)

        # Temperature step on log α: the analytic gradient at the
        # pre-update α, with the actor loss's log π.
        logp = logp.detach()
        if cfg.fixed_alpha is None:
            alpha_grad = pmean(torch.mean(-(logp + h_target)) * torch.exp(ls.log_alpha), group)
            opts["alpha"].step({"log_alpha": ls.log_alpha}, {"log_alpha": alpha_grad},
                               ls.alpha_opt, tables["alpha"].on(device), mask=do_update)

        polyak_update(params_of(ls.critic), params_of(ls.target_critic), cfg.tau, mask=do_update)
        ls.update_count.add_(do_update)
        return {
            "critic_loss": closs.detach(),
            "actor_loss": aloss.detach(),
            "q_mean": torch.mean(q1.detach()),
            "alpha": torch.exp(ls.log_alpha),
            "entropy_est": -torch.mean(logp),
        }

    def update_loop(ls: SACLearnerState, do_update: torch.Tensor,
                    generator: torch.Generator) -> dict[str, torch.Tensor]:
        for _ in range(cfg.updates_per_iter):
            metrics = apply_update(ls, do_update, draw_update(ls, generator))
        return metrics

    update_loop.draw_update = draw_update
    update_loop.apply_update = apply_update
    return update_loop


def make_train_step(
    env: TorchEnv, cfg: SACConfig, group: Group = None
) -> Callable[[SACState], tuple[SACState, dict[str, torch.Tensor]]]:
    """The fused collect → insert → update step; `train_step(state) ->
    (state, metrics)` writes `state` in place. `group`: the data-parallel
    ranks' process group, as `ddpg.make_train_step`'s."""
    explore = make_explore_fn(cfg)
    update_loop = make_update_loop(env.spec.action_dim, cfg, group)
    codecs = replay.offpolicy_codecs(cfg.replay_dtype)

    def train_step(state: SACState) -> tuple[SACState, dict[str, torch.Tensor]]:
        traj = collect_and_insert(env, explore, state, cfg.steps_per_iter, codecs, group)
        do_update = update_gate(state.env_steps, state.learner.replay, cfg.batch_size,
                                cfg.warmup_steps)
        metrics = update_loop(state.learner, do_update, state.generator)
        return state, finish_step(state, traj, metrics, group)

    train_step.group = group
    return train_step


def train(
    env: TorchEnv,
    cfg: SACConfig,
    num_iterations: int,
    seed: int = 0,
    device="cuda",
    state: Optional[SACState] = None,
    log_every: int = 0,
    log_fn: Optional[Callable[[int, dict], None]] = None,
) -> tuple[SACState, dict[str, torch.Tensor]]:
    """The host loop around the fused step (single device)."""
    from actor_critic_tpu_torch.algos.loop import fused_train_loop

    return fused_train_loop(
        make_train_step, init_state, env, cfg, num_iterations,
        seed=seed, device=device, state=state, log_every=log_every, log_fn=log_fn,
        capturable=CAPTURABLE,
    )


# --------------------------------------------------------------------------
# The host env path (MuJoCo Humanoid etc.)
# --------------------------------------------------------------------------


def make_host_act_fn(action_dim: int, cfg: SACConfig):
    """`act(actor, obs, generator, env_steps)`: the behaviour policy on the
    device (the host loop's acting path without a mirror)."""
    return make_explore_fn(cfg)


def make_host_ingest_update(action_dim: int, cfg: SACConfig):
    """`ingest_update(learner, traj, env_steps, generator) -> metrics`: a
    host-collected [K, E] block into the ring, the gate (env_steps ≥
    warmup_steps and a batch in the ring; SAC has no n-step window) and the
    update loop, as `ddpg.make_host_ingest_update`."""
    return ingest_update_of(make_update_loop(action_dim, cfg), cfg, min_size=cfg.batch_size)


def make_greedy_act(action_dim: int, cfg: SACConfig):
    """`act(actor, obs)`: tanh(mean), for the host eval."""
    return lambda actor, obs: actor(obs).mode()


def train_host(
    pool,
    cfg: SACConfig,
    num_iterations: int,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    eval_every: int = 0,
    eval_envs: int = 4,
    eval_steps: int = 1000,
    ckpt=None,
    save_every: int = 0,
    resume: bool = False,
    overlap: bool = True,
    save_replay: bool = True,
    device="cuda",
    iteration_hook=None,
):
    """SAC on a `HostEnvPool` (a host rollout, the learner on the device:
    `host_loop.off_policy_train_host`). Use a pool with neither obs nor
    reward normalization: drifting obs stats scale replayed transitions
    inconsistently, and the critic then bootstraps across mixed frames (a
    Q/α runaway on Humanoid-v5 in the JAX package's runs). Returns
    (learner, history)."""
    from actor_critic_tpu_torch.algos.host_loop import off_policy_train_host
    from actor_critic_tpu_torch.models.host_actor import (
        make_sac_host_explore,
        make_sac_host_greedy,
    )

    return off_policy_train_host(
        pool, cfg, num_iterations,
        init_learner=init_learner,
        make_act_fn=make_host_act_fn,
        make_ingest_update=make_host_ingest_update,
        seed=seed, log_every=log_every, log_fn=log_fn,
        eval_every=eval_every, make_greedy_act=make_greedy_act,
        eval_envs=eval_envs, eval_steps=eval_steps,
        ckpt=ckpt, save_every=save_every, resume=resume,
        overlap=overlap, make_host_explore=make_sac_host_explore,
        make_host_greedy=make_sac_host_greedy,
        save_replay=save_replay, device=device, iteration_hook=iteration_hook,
    )


def train_host_async(
    pools,
    cfg: SACConfig,
    num_iterations: int,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    eval_every: int = 0,
    eval_envs: int = 4,
    eval_steps: int = 1000,
    queue_depth: int = 4,
    max_staleness: Optional[int] = None,
    data_plane: str = "host",
    plane_codec: str = "fp32",
    transfer_pad_s: float = 0.0,
    device="cuda",
    iteration_hook=None,
    publish_hook=None,
    gate=None,
):
    """SAC with decoupled actor threads (`host_loop.off_policy_train_host_async`):
    one exploration thread per pool pushes [K, E_a] transition blocks
    through the bounded queue, and the learner ingests each into the replay
    ring and updates; replay absorbs the behaviour staleness, so there is
    no correction knob. `data_plane="device"` stages the blocks encoded in
    a ring on the card. Returns (learner, history)."""
    from actor_critic_tpu_torch.algos.host_loop import off_policy_train_host_async
    from actor_critic_tpu_torch.models.host_actor import (
        make_sac_host_explore,
        make_sac_host_greedy,
    )

    return off_policy_train_host_async(
        pools, cfg, num_iterations,
        init_learner=init_learner,
        make_ingest_update=make_host_ingest_update,
        make_host_explore=make_sac_host_explore,
        make_host_greedy=make_sac_host_greedy,
        seed=seed, log_every=log_every, log_fn=log_fn,
        eval_every=eval_every, eval_envs=eval_envs, eval_steps=eval_steps,
        queue_depth=queue_depth, max_staleness=max_staleness,
        data_plane=data_plane, plane_codec=plane_codec, transfer_pad_s=transfer_pad_s,
        device=device, iteration_hook=iteration_hook, publish_hook=publish_hook, gate=gate,
    )


# -- the warm-up registry (utils/compile_cache.py) ---------------------------
from actor_critic_tpu_torch.utils import compile_cache as _compile_cache  # noqa: E402

_compile_cache.register_offpolicy_warmups("sac", ("sac",))
