"""DDPG / TD3 — off-policy deterministic actor-critic with a replay ring on
the device (counterpart of `actor_critic_tpu/algos/ddpg.py`). TD3 is DDPG
with three flags (`twin_q`, `policy_delay`, `target_noise`, `td3_config`).

One train step is, as the JAX package fuses it into one program,

    collect: K × [actor forward + Gaussian noise (uniform actions during
             the warm-up) → batched env step]
    insert:  the [K·E] transitions into the ring (codecs' stats, encode,
             index_copy_)
    update:  J × [sample → TD target from the target nets (TD3: smoothed)
             → critic Adam step → (every policy_delay-th) actor Adam step
             and Polyak targets]

The step is capturable (`CAPTURABLE`): the warm-up gate `do_update` (env
steps past `warmup_steps` and a batch's worth in the ring) and the delay
gate `do_actor` are 0-dim bool tensors on the device, and every parameter,
moment, count and target takes its new value through a `torch.where` on
them, in place (`optim.Adam.step(mask=)`, `ops.polyak.polyak_update(mask=)`),
as JAX's `select`s; the gradients are computed whatever the gates say. The
replay draws and the target noise come from the trainer's generator, and
one update is split into `draw_update` and `apply_update` so that a test
can give it the JAX package's draws. On the card `algos/loop.py` runs the
step as one CUDA graph.

The host env path (`train_host`, below) collects on a `HostEnvPool` and
runs the same insert, gate and update loop on each uploaded block
(`make_host_ingest_update`), also as one CUDA graph
(`algos/host_loop.py`). `train_host_async` decouples collection into
actor threads (`host_loop.off_policy_train_host_async`), on the host or
the device data plane (`data_plane/device_replay.py`).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from actor_critic_tpu_torch import replay, resolve_device
from actor_critic_tpu_torch.algos.common import (
    OffPolicyState,
    OffPolicyTransition,
    advance,
    compute_dtype,
    fold_episodes,
    init_rollout,
    make_greedy_eval,
    offpolicy_rollout,
)
from actor_critic_tpu_torch.algos.metrics import aggregate_metrics
from actor_critic_tpu_torch.envs.env import DeviceTable, TorchEnv
from actor_critic_tpu_torch.models.networks import DeterministicActor, QFunction, TwinQ
from actor_critic_tpu_torch.ops.polyak import polyak_update
from actor_critic_tpu_torch.optim import Adam, AdamState
from actor_critic_tpu_torch.parallel.mesh import FlatGradients, Group

# `algos/loop.py` runs this trainer's step as one CUDA graph on the card.
CAPTURABLE = True


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """Same fields and defaults as the JAX `DDPGConfig` (a test holds them
    equal); see that class for the reasoning behind each."""

    num_envs: int = 8
    steps_per_iter: int = 8      # K env steps per train_step call
    updates_per_iter: int = 8    # J gradient updates per train_step call
    buffer_capacity: int = 1_000_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    hidden: tuple[int, ...] = (256, 256)
    exploration_noise: float = 0.1  # behaviour-policy Gaussian noise std
    warmup_steps: int = 1_000       # uniform-random action steps
    # TD3's three flags.
    twin_q: bool = False
    policy_delay: int = 1
    target_noise: float = 0.0       # target-policy smoothing std
    target_noise_clip: float = 0.5
    # bfloat16 activations and matmuls (--update-dtype bf16); parameters,
    # targets and Adam state stay float32.
    bf16_compute: bool = False
    # n-step TD targets over windows of consecutive inserts (needs E == 1).
    nstep: int = 1
    # Replay storage codecs: "fp32" | "mixed" | "int8" (replay/quantize.py).
    replay_dtype: str = "fp32"


def td3_config(**overrides) -> DDPGConfig:
    """TD3 = DDPG + twin critics, a delayed policy, target smoothing."""
    base = dict(twin_q=True, policy_delay=2, target_noise=0.2)
    base.update(overrides)
    return DDPGConfig(**base)


@dataclasses.dataclass
class LearnerState:
    """The learner on the device: nets, targets (modules of their own),
    both Adam states, the ring, and the count of updates taken (which
    drives the policy delay). Written in place."""

    actor: DeterministicActor
    critic: Union[QFunction, TwinQ]
    target_actor: DeterministicActor
    target_critic: Union[QFunction, TwinQ]
    actor_opt: AdamState
    critic_opt: AdamState
    replay: replay.ReplayState
    update_count: torch.Tensor  # 0-dim int64


class UpdateDraws(NamedTuple):
    """What one update draws: the ring slots of its batch (window starts,
    counted from the oldest entry, when nstep > 1) and TD3's standard
    normal target-smoothing noise [B, A] (None without smoothing)."""

    idx: torch.Tensor
    target_eps: Optional[torch.Tensor]


def make_networks(
    obs_dim: int, action_dim: int, cfg: DDPGConfig, generator: Optional[torch.Generator] = None
) -> tuple[DeterministicActor, Union[QFunction, TwinQ]]:
    """The actor and the critic (twin with `twin_q`), weights drawn from
    `generator` in that order, both computing in bf16 with `bf16_compute`."""
    dtype = compute_dtype(cfg.bf16_compute)
    actor = DeterministicActor(obs_dim, action_dim, cfg.hidden, generator, dtype)
    critic_cls = TwinQ if cfg.twin_q else QFunction
    return actor, critic_cls(obs_dim, action_dim, cfg.hidden, generator, dtype)


def example_transition(obs_shape: tuple[int, ...], action_dim: int,
                       device: torch.device) -> OffPolicyTransition:
    """One zero transition, the ring's template."""
    zero = lambda *shape: torch.zeros(shape, device=device)
    return OffPolicyTransition(obs=zero(*obs_shape), action=zero(action_dim), reward=zero(),
                               next_obs=zero(*obs_shape), terminated=zero(), done=zero())


def init_learner(
    obs_shape: tuple[int, ...], action_dim: int, cfg: DDPGConfig,
    generator: Optional[torch.Generator] = None, device="cuda",
) -> LearnerState:
    """A fresh learner on `device`, weights drawn on the CPU from
    `generator`; the targets start as copies with storage of their own."""
    device = resolve_device(device)
    actor, critic = (m.to(device) for m in make_networks(obs_shape[-1], action_dim, cfg, generator))
    return LearnerState(
        actor=actor,
        critic=critic,
        target_actor=copy.deepcopy(actor),
        target_critic=copy.deepcopy(critic),
        actor_opt=Adam(cfg.actor_lr).init(dict(actor.named_parameters())),
        critic_opt=Adam(cfg.critic_lr).init(dict(critic.named_parameters())),
        replay=replay.init(example_transition(obs_shape, action_dim, device),
                           cfg.buffer_capacity, replay.offpolicy_codecs(cfg.replay_dtype)),
        update_count=torch.zeros((), dtype=torch.int64, device=device),
    )


def init_offpolicy_state(env: TorchEnv, learner, num_envs: int, seed: int,
                         device: torch.device) -> OffPolicyState:
    """The fused trainer's state around `learner`: a reset env batch, zero
    counts and accounting, and the trainer's generator on `device` seeded
    with `seed`."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return OffPolicyState(
        learner=learner,
        rollout=init_rollout(env, generator, num_envs),
        generator=generator,
        env_steps=torch.zeros((), dtype=torch.int64, device=device),
        ep_return=torch.zeros(num_envs, device=device),
        ep_length=torch.zeros(num_envs, device=device),
        avg_return=torch.zeros((), device=device),
        step_counter=torch.zeros(1, dtype=torch.int64, device=device),
    )


def init_state(env: TorchEnv, cfg: DDPGConfig, seed: int = 0, device="cuda") -> OffPolicyState:
    """Fresh train state on `device`. The weights are drawn on the CPU from
    a generator seeded with `seed` (so they do not depend on the device);
    exploration, resets, replay draws and target noise come from a
    generator on `device`, seeded likewise."""
    device = resolve_device(device)
    learner = init_learner(env.spec.obs_shape, env.spec.action_dim, cfg,
                           torch.Generator().manual_seed(seed), device)
    return init_offpolicy_state(env, learner, cfg.num_envs, seed, device)


def make_eval_fn(env: TorchEnv, cfg: DDPGConfig):
    """Greedy (noiseless actor) eval: `eval_fn(state, generator, num_envs,
    num_steps)`, replayed as CUDA graphs on the card."""
    return make_greedy_eval(env, lambda actor, obs: actor(obs), lambda s: s.learner.actor)


def make_explore_fn(cfg: DDPGConfig):
    """The behaviour policy `act(actor, obs, generator, env_steps)`: the
    actor plus Gaussian noise, clipped to [−1, 1]; uniform actions in
    [−1, 1) while `env_steps < warmup_steps` (a select on the device, the
    actor's forward and both draws taken either way)."""

    def act(actor: nn.Module, obs: torch.Tensor, generator: torch.Generator,
            env_steps: torch.Tensor) -> torch.Tensor:
        a = actor(obs)
        noise = torch.randn(a.shape, generator=generator, device=a.device)
        a = torch.clamp(a + cfg.exploration_noise * noise, -1.0, 1.0)
        u = torch.rand(a.shape, generator=generator, device=a.device)
        return torch.where(env_steps < cfg.warmup_steps, u * 2.0 - 1.0, a)

    return act


@functools.cache
def discount_table(gamma: float, n: int) -> DeviceTable:
    """[γ^0, …, γ^n] in float32, each `np.float32(γ) ** np.float32(k)`:
    XLA's float32 power gives these values, and `torch.pow` does not on
    every k. Looked up on the device (copied there at its first, eager,
    use)."""
    g = np.float32(gamma)
    return DeviceTable([g ** np.float32(k) for k in range(n + 1)])


def nstep_batch(seq: OffPolicyTransition, gamma: float) -> tuple[OffPolicyTransition, torch.Tensor]:
    """[B, n] windows → (a 1-step-shaped batch, the bootstrap discount).

    The batch's `reward` is the n-step return prefix G = Σ_{k<m} γ^k r_k
    (m = steps up to and including the first done: the done step's own
    reward is the terminal reward), its `next_obs` and `terminated` the
    window end's (the first done step, else the last); the discount is
    γ^m, so target = G + γ^m (1 − terminated_end) Q̄(next_obs_end, ·) has
    the 1-step shape: truncations bootstrap through, terminations mask,
    episodes never splice. `argmax` takes the first done, as JAX's does."""
    n = seq.reward.shape[1]
    d = seq.done.to(torch.float32)
    alive_before = torch.cumprod(
        torch.cat([torch.ones_like(d[:, :1]), 1.0 - d[:, :-1]], dim=1), dim=1)
    powers = discount_table(gamma, n).on(d.device)
    g = torch.sum(seq.reward * alive_before * powers[:n], dim=1)
    any_done = torch.amax(d, dim=1) > 0
    end_idx = torch.where(any_done, torch.argmax(d, dim=1), torch.full_like(any_done, n - 1,
                                                                           dtype=torch.int64))

    def at_end(x: torch.Tensor) -> torch.Tensor:
        idx = end_idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(-1, 1, *x.shape[2:])
        return torch.gather(x, 1, idx)[:, 0]

    batch = OffPolicyTransition(
        obs=seq.obs[:, 0],
        action=seq.action[:, 0],
        reward=g,
        next_obs=at_end(seq.next_obs),
        terminated=at_end(seq.terminated),
        done=seq.done[:, 0],
    )
    return batch, powers[end_idx + 1]


def _critic_q(critic: nn.Module, obs: torch.Tensor, action: torch.Tensor,
              cfg: DDPGConfig) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(q1, q2) from either critic; q2 is None without twin-Q."""
    if cfg.twin_q:
        return critic(obs, action)
    return critic(obs, action), None


def params_of(module: nn.Module) -> dict[str, torch.Tensor]:
    return dict(module.named_parameters())


def grads_of(loss: torch.Tensor, module: nn.Module,
             sync: Optional[FlatGradients] = None) -> dict[str, torch.Tensor]:
    """d loss / d (each parameter of `module`), by name: the gradient of
    one net's loss over that net's own parameters only; pmean'd over a
    data-parallel group through `sync` (its `FlatGradients`) when given."""
    params = params_of(module)
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads if sync is None else sync(grads)))


def grad_syncs(group: Group, *names: str) -> dict[str, Optional[FlatGradients]]:
    """One `FlatGradients` per net under a data-parallel `group` (each
    holds a buffer shaped after its net's gradients), None without one."""
    return {n: None if group is None else FlatGradients(group) for n in names}


def make_update_loop(action_dim: int, cfg: DDPGConfig, group: Group = None):
    """The learner's half of a step: returns `update_loop(learner,
    do_update, generator) -> metrics`, `cfg.updates_per_iter` sample → TD →
    (delayed) actor steps, each `draw_update` then `apply_update`, the
    learner written in place; the metrics are the last update's. With a
    data-parallel `group` each rank samples its own sub-ring and the
    critic's and the actor's gradients are pmean'd over the group (one
    all-reduce each, every update, whatever the gates say, so that every
    rank issues the same collectives).
    `update_loop.draw_update(learner, generator)` and
    `update_loop.apply_update(learner, do_update, draws)` are one update's
    halves."""
    if cfg.nstep < 1:
        raise ValueError(f"nstep must be >= 1, got {cfg.nstep}")
    if cfg.nstep > 1 and cfg.num_envs != 1:
        raise ValueError(
            "nstep > 1 requires num_envs == 1: the replay ring stores "
            "flattened [K, E] rollouts, so consecutive inserts interleave "
            "envs unless E == 1 (see DDPGConfig.nstep)"
        )
    codecs = replay.offpolicy_codecs(cfg.replay_dtype)
    actor_opt, critic_opt = Adam(cfg.actor_lr), Adam(cfg.critic_lr)
    actor_table, critic_table = (DeviceTable(o.scalar_table()) for o in (actor_opt, critic_opt))
    syncs = grad_syncs(group, "critic", "actor")

    def draw_update(ls: LearnerState, generator: torch.Generator) -> UpdateDraws:
        if cfg.nstep > 1:
            bound = replay.buffer.window_bound(ls.replay, cfg.nstep)
        else:
            bound = ls.replay.size
        idx = replay.draw_indices(generator, cfg.batch_size, bound)
        eps = None
        if cfg.target_noise > 0.0:
            eps = torch.randn((cfg.batch_size, action_dim), generator=generator,
                              device=generator.device)
        return UpdateDraws(idx, eps)

    def apply_update(ls: LearnerState, do_update: torch.Tensor,
                     draws: UpdateDraws) -> dict[str, torch.Tensor]:
        if cfg.nstep > 1:
            seq = replay.sequences_at(ls.replay, draws.idx, cfg.nstep, codecs)
            batch, boot_discount = nstep_batch(seq, cfg.gamma)
        else:
            batch = replay.sample_at(ls.replay, draws.idx, codecs)
            boot_discount = cfg.gamma

        # TD target from the target nets (TD3: clipped smoothing noise,
        # then the action clipped).
        with torch.no_grad():
            next_a = ls.target_actor(batch.next_obs)
            if cfg.target_noise > 0.0:
                noise = torch.clamp(cfg.target_noise * draws.target_eps,
                                    -cfg.target_noise_clip, cfg.target_noise_clip)
                next_a = torch.clamp(next_a + noise, -1.0, 1.0)
            tq1, tq2 = _critic_q(ls.target_critic, batch.next_obs, next_a, cfg)
            next_q = tq1 if tq2 is None else torch.minimum(tq1, tq2)
            target_q = batch.reward + boot_discount * (1.0 - batch.terminated) * next_q

        # Critic step (every update the gate lets through).
        q1, q2 = _critic_q(ls.critic, batch.obs, batch.action, cfg)
        closs = torch.mean((q1 - target_q) ** 2)
        if q2 is not None:
            closs = closs + torch.mean((q2 - target_q) ** 2)
        device = q1.device
        critic_opt.step(params_of(ls.critic), grads_of(closs, ls.critic, syncs["critic"]),
                        ls.critic_opt, critic_table.on(device), mask=do_update)

        # Actor step and Polyak targets, every policy_delay-th update; the
        # actor's loss reads the critic after its step.
        do_actor = torch.logical_and(do_update, ls.update_count % cfg.policy_delay == 0)
        a = ls.actor(batch.obs)
        aq1, _ = _critic_q(ls.critic, batch.obs, a, cfg)
        aloss = -torch.mean(aq1)
        actor_opt.step(params_of(ls.actor), grads_of(aloss, ls.actor, syncs["actor"]),
                       ls.actor_opt, actor_table.on(device), mask=do_actor)
        polyak_update(params_of(ls.actor), params_of(ls.target_actor), cfg.tau, mask=do_actor)
        polyak_update(params_of(ls.critic), params_of(ls.target_critic), cfg.tau, mask=do_actor)
        ls.update_count.add_(do_update)
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
                "q_mean": torch.mean(q1.detach())}

    def update_loop(ls: LearnerState, do_update: torch.Tensor,
                    generator: torch.Generator) -> dict[str, torch.Tensor]:
        for _ in range(cfg.updates_per_iter):
            metrics = apply_update(ls, do_update, draw_update(ls, generator))
        return metrics

    update_loop.draw_update = draw_update
    update_loop.apply_update = apply_update
    return update_loop


def update_gate(env_steps: torch.Tensor, ring: replay.ReplayState, min_size: int,
                warmup_steps: int) -> torch.Tensor:
    """`do_update`, a 0-dim bool on the device: the warm-up is over
    (`env_steps`, 0-dim) and the ring holds `min_size` transitions."""
    return torch.logical_and(env_steps >= warmup_steps, ring.size >= min_size)


def collect_and_insert(env: TorchEnv, explore, state: OffPolicyState, steps: int,
                       codecs, group: Group = None) -> OffPolicyTransition:
    """The step's first half: `steps` exploration steps of the env batch,
    then their [K·E] transitions into the ring (its codecs' stats synced
    over a data-parallel `group`); returns the [K, E] ones."""
    traj = offpolicy_rollout(env, explore, state.learner.actor, state.rollout,
                             state.generator, steps, state.env_steps)
    flat = OffPolicyTransition(*(x.reshape(-1, *x.shape[2:]) for x in traj))
    replay.add_batch(state.learner.replay, flat, codecs, group)
    return traj


def finish_step(state: OffPolicyState, traj: OffPolicyTransition,
                metrics: dict[str, torch.Tensor], group: Group = None) -> dict[str, torch.Tensor]:
    """The step's accounting: the episode fold (the return EMA pmean'd
    over a data-parallel `group`), the step count, the metrics aggregated
    over the group."""
    ep_metrics = fold_episodes(state, traj, group)
    advance(state)
    return aggregate_metrics(metrics, ep_metrics, group)


def make_train_step(
    env: TorchEnv, cfg: DDPGConfig, group: Group = None
) -> Callable[[OffPolicyState], tuple[OffPolicyState, dict[str, torch.Tensor]]]:
    """The fused collect → insert → update step; `train_step(state) ->
    (state, metrics)` writes `state` in place. `group` is the data-parallel
    ranks' process group (JAX's `axis_name`; the state distributed by
    `parallel.dp.distribute_state(..., offpolicy_state_specs())`), None
    for one device; the step carries it as `train_step.group`."""
    explore = make_explore_fn(cfg)
    update_loop = make_update_loop(env.spec.action_dim, cfg, group)
    codecs = replay.offpolicy_codecs(cfg.replay_dtype)
    # The floor is max(batch_size, nstep): a ring holding fewer than n
    # inserts would clamp windows into zero-initialised slots.
    min_size = max(cfg.batch_size, cfg.nstep)

    def train_step(state: OffPolicyState) -> tuple[OffPolicyState, dict[str, torch.Tensor]]:
        traj = collect_and_insert(env, explore, state, cfg.steps_per_iter, codecs, group)
        do_update = update_gate(state.env_steps, state.learner.replay, min_size, cfg.warmup_steps)
        metrics = update_loop(state.learner, do_update, state.generator)
        return state, finish_step(state, traj, metrics, group)

    train_step.group = group
    return train_step


def train(
    env: TorchEnv,
    cfg: DDPGConfig,
    num_iterations: int,
    seed: int = 0,
    device="cuda",
    state: Optional[OffPolicyState] = None,
    log_every: int = 0,
    log_fn: Optional[Callable[[int, dict], None]] = None,
) -> tuple[OffPolicyState, dict[str, torch.Tensor]]:
    """The host loop around the fused step (single device)."""
    from actor_critic_tpu_torch.algos.loop import fused_train_loop

    return fused_train_loop(
        make_train_step, init_state, env, cfg, num_iterations,
        seed=seed, device=device, state=state, log_every=log_every, log_fn=log_fn,
        capturable=CAPTURABLE,
    )


# --------------------------------------------------------------------------
# The host env path (MuJoCo Walker2d etc.)
# --------------------------------------------------------------------------


def make_host_act_fn(action_dim: int, cfg: DDPGConfig):
    """`act(actor, obs, generator, env_steps)`: the behaviour policy on the
    device (the host loop's acting path without a mirror)."""
    return make_explore_fn(cfg)


def make_host_ingest_update(action_dim: int, cfg: DDPGConfig):
    """`ingest_update(learner, traj, env_steps, generator) -> metrics`: a
    host-collected [K, E] block into the ring, the gate, and the update
    loop, the learner written in place; one CUDA graph on the card
    (`host_loop.HostUpdate`). `env_steps` (0-dim int64 on the device) is
    the count after the block. The gate is the fused path's:
    env_steps ≥ warmup_steps and a ring of max(batch_size, nstep)
    transitions. `ingest_update.ingest(learner, traj, env_steps) ->
    do_update` and `ingest_update.update_loop` are its two halves."""
    return ingest_update_of(make_update_loop(action_dim, cfg), cfg,
                            min_size=max(cfg.batch_size, cfg.nstep))


def ingest_update_of(update_loop, cfg, min_size: int):
    """The host ingest+update around `update_loop` (DDPG/TD3's or SAC's),
    gated at `min_size` ring transitions and `cfg.warmup_steps`."""
    codecs = replay.offpolicy_codecs(cfg.replay_dtype)

    def ingest(ls, traj: OffPolicyTransition, env_steps: torch.Tensor) -> torch.Tensor:
        flat = OffPolicyTransition(*(x.reshape(-1, *x.shape[2:]) for x in traj))
        replay.add_batch(ls.replay, flat, codecs)
        return update_gate(env_steps, ls.replay, min_size, cfg.warmup_steps)

    def ingest_update(ls, traj: OffPolicyTransition, env_steps: torch.Tensor,
                      generator: torch.Generator) -> dict[str, torch.Tensor]:
        return update_loop(ls, ingest(ls, traj, env_steps), generator)

    ingest_update.ingest = ingest
    ingest_update.update_loop = update_loop
    return ingest_update


def make_greedy_act(action_dim: int, cfg: DDPGConfig):
    """`act(actor, obs)`: the noiseless actor, for the host eval."""
    return lambda actor, obs: actor(obs)


def train_host(
    pool,
    cfg: DDPGConfig,
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
    """DDPG/TD3 on a `HostEnvPool` (a host rollout, the learner on the
    device: `host_loop.off_policy_train_host`). Off-policy MuJoCo wants a
    pool with neither obs nor reward normalization: running-stat
    normalization scales replayed transitions differently as the stats
    drift, and TD targets want the raw reward scale. With `overlap` the
    host acts through the numpy mirror with parameters one update stale.
    Returns (learner, history)."""
    from actor_critic_tpu_torch.algos.host_loop import off_policy_train_host
    from actor_critic_tpu_torch.models.host_actor import (
        make_ddpg_host_explore,
        make_ddpg_host_greedy,
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
        overlap=overlap, make_host_explore=make_ddpg_host_explore,
        make_host_greedy=make_ddpg_host_greedy,
        save_replay=save_replay, device=device, iteration_hook=iteration_hook,
    )


def train_host_async(
    pools,
    cfg: DDPGConfig,
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
    """DDPG/TD3 with decoupled actor threads (`host_loop.off_policy_train_host_async`):
    one exploration thread per pool pushes [K, E_a] transition blocks
    through the bounded queue, and the learner ingests each into the replay
    ring and updates; replay absorbs the behaviour staleness, so there is
    no correction knob. `data_plane="device"` stages the blocks encoded in
    a ring on the card. Returns (learner, history)."""
    from actor_critic_tpu_torch.algos.host_loop import off_policy_train_host_async
    from actor_critic_tpu_torch.models.host_actor import (
        make_ddpg_host_explore,
        make_ddpg_host_greedy,
    )

    return off_policy_train_host_async(
        pools, cfg, num_iterations,
        init_learner=init_learner,
        make_ingest_update=make_host_ingest_update,
        make_host_explore=make_ddpg_host_explore,
        make_host_greedy=make_ddpg_host_greedy,
        seed=seed, log_every=log_every, log_fn=log_fn,
        eval_every=eval_every, eval_envs=eval_envs, eval_steps=eval_steps,
        queue_depth=queue_depth, max_staleness=max_staleness,
        data_plane=data_plane, plane_codec=plane_codec, transfer_pad_s=transfer_pad_s,
        device=device, iteration_hook=iteration_hook, publish_hook=publish_hook, gate=gate,
    )


# -- the warm-up registry (utils/compile_cache.py) ---------------------------
from actor_critic_tpu_torch.utils import compile_cache as _compile_cache  # noqa: E402

_compile_cache.register_offpolicy_warmups("ddpg", ("ddpg", "td3"))
