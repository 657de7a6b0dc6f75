"""PPO-clip (counterpart of `actor_critic_tpu/algos/ppo.py`): the fused
trainer, the host env path's (`train_host`, below), and the async
actor-learner's (`train_host_async`, with V-trace's staleness correction,
on the host or the device data plane).

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
import time
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from actor_critic_tpu_torch import resolve_device, telemetry
from actor_critic_tpu_torch.algos.common import (
    ScheduleTable,
    TrainState,
    Transition,
    advance,
    anneal_fraction,
    corrected_advantages,
    fold_episodes,
    gae_targets,
    init_train_state,
    linear_anneal,
    make_actor_critic,
    make_mode_eval,
    named_carried,
    rollout_loop,
    rollout_targets,
    schedule_table,
)
from actor_critic_tpu_torch.algos.metrics import aggregate_metrics
from actor_critic_tpu_torch.envs.env import EnvSpec, TorchEnv
from actor_critic_tpu_torch.models.networks import ActorCriticDiscrete, ActorCriticGaussian
from actor_critic_tpu_torch.ops.returns import LOG_RATIO_CAP, normalize_advantages
from actor_critic_tpu_torch.optim import AdamState, ClippedAdam, linear_schedule
from actor_critic_tpu_torch.parallel.mesh import FlatGradients, Group, pmean_tree

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
    # bfloat16 activations and matmuls (--update-dtype bf16); parameters,
    # optimizer state and every loss reduction stay float32.
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
    group: Group = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Clipped-surrogate + clipped-value + entropy loss on a minibatch, with
    float32 means. `clip_eps` / `entropy_coef` (floats or 0-dim tensors)
    override the config's constants. With a process `group` the advantage
    normalization uses the global batch's statistics (JAX's `axis_name`)."""
    if clip_eps is None:
        clip_eps = cfg.clip_eps
    if entropy_coef is None:
        entropy_coef = cfg.entropy_coef
    dist, value = net(batch.obs)
    log_prob = dist.log_prob(batch.action)
    entropy = torch.mean(dist.entropy(), dtype=torch.float32)

    adv = batch.advantage
    if cfg.normalize_adv:
        adv = normalize_advantages(adv, group)

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
    grad_sync: Optional[FlatGradients] = None,
) -> dict[str, torch.Tensor]:
    """E epochs × M shuffled minibatches of PPO updates, applied in place to
    `net`'s parameters and `opt_state`; returns the metrics' mean over the
    [E, M] nest (this rank's: the caller pmeans them).

    With `grad_sync`, a `parallel.mesh.FlatGradients` of a process group
    (a data-parallel update: every rank holds its own shard of the batch
    and the same parameters), each minibatch's advantages are normalized
    with the group's global statistics and its gradients are pmean'd
    through `grad_sync`'s one flat all-reduce before the global-norm clip
    and Adam, optax's order.

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
    group = None if grad_sync is None else grad_sync.group
    history = []
    for e in range(cfg.epochs):
        for j in range(M):
            idx = perms[e, j * mb:(j + 1) * mb]
            loss, metrics = ppo_loss(
                net, PPOBatch(*(x[idx] for x in batch)), cfg, clip_eps, entropy_coef, group
            )
            grads = torch.autograd.grad(loss, list(params.values()))
            if grad_sync is not None:
                grads = grad_sync(grads)
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
    grad_sync: Optional[FlatGradients] = None,
) -> dict[str, torch.Tensor]:
    """Targets, `ppo_update` and episode accounting for a rollout `traj`
    whose next obs is `state.rollout.obs`, with the schedule's values at
    `state.step_counter`. Draws the permutations from `state.generator`
    unless `perms` is given (each rank its own, over its own shard, under
    dp). Updates `state` in place; returns the metrics as device tensors.
    With `grad_sync` (a data-parallel group's `FlatGradients`) each
    minibatch's advantage statistics and gradients are the group's, and
    the return EMA and the metrics are pmean'd / aggregated over it."""
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
                         clip_eps, entropy_coef, grad_sync)
    group = None if grad_sync is None else grad_sync.group
    ep_metrics = fold_episodes(state, traj, group)
    advance(state)
    return aggregate_metrics(metrics, ep_metrics, group)


def make_train_step(
    env: TorchEnv, cfg: PPOConfig, group: Group = None
) -> Callable[[TrainState], tuple[TrainState, dict[str, torch.Tensor]]]:
    """`train_step(state) -> (state, metrics)`: rollout then update. `group`
    is the data-parallel ranks' process group (JAX's `axis_name`), None for
    one device; the step carries it as `train_step.group`."""
    opt = make_optimizer(cfg)
    grad_sync = None if group is None else FlatGradients(group)

    def train_step(state: TrainState) -> tuple[TrainState, dict[str, torch.Tensor]]:
        traj = rollout(env, cfg, state)
        return state, update(env, cfg, opt, state, traj, grad_sync=grad_sync)

    train_step.group = group
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


# --------------------------------------------------------------------------
# The host env path (MuJoCo HalfCheetah etc.): a host rollout, one device
# update a block
# --------------------------------------------------------------------------


def make_policy_step(env_spec: EnvSpec, cfg: PPOConfig):
    """`policy_step(net, obs, generator) -> (action, log_prob, value)`: the
    device acting path of the host loop (no mirror, or no overlap)."""

    @torch.no_grad()
    def policy_step(net: torch.nn.Module, obs: torch.Tensor, generator: torch.Generator):
        dist, value = net(obs)
        action = dist.sample(generator)
        return action, dist.log_prob(action), value

    return policy_step


def make_host_update_fn(env_spec: EnvSpec, cfg: PPOConfig, can_truncate: bool = True):
    """The per-block update of the host path: `update(net, opt_state,
    schedule, obs, action, log_prob, value, reward, done, terminated,
    final_obs, last_obs, perms, final_values=None, bootstrap_value=None,
    iteration=None) -> metrics`, on time-major [T, E] tensors, the net and
    `opt_state` written in place.

    Truncation bootstrap, then GAE through `common.gae_targets` (the CUDA
    kernel on the card), then `ppo_update` with the epochs' permutations
    `perms`. `final_values` and `bootstrap_value` come from the mirror
    with overlap (every baseline of the GAE from the same stale behaviour
    parameters as the recorded values); None recomputes them here with the
    current parameters (the synchronous path, where behaviour is current).
    The clip-ε and entropy coefficients are the schedule's at `iteration`
    (a [1] int64 tensor: JAX's `progress` is min(iteration / anneal_iters,
    1)), its first row when None; the learning rate and Adam's scalars at
    Adam's count."""
    opt = make_optimizer(cfg)

    def update(net, opt_state, schedule, obs, action, log_prob, value, reward, done,
               terminated, final_obs, last_obs, perms, final_values=None,
               bootstrap_value=None, iteration=None) -> dict[str, torch.Tensor]:
        T, E = reward.shape
        with torch.no_grad():
            if bootstrap_value is None:
                _, bootstrap_value = net(last_obs)
            if can_truncate:
                if final_values is None:
                    _, fv = net(final_obs.reshape(T * E, *final_obs.shape[2:]))
                    final_values = fv.reshape(T, E)
                truncated = done * (1.0 - terminated)
                rewards = reward + cfg.gamma * final_values * truncated
            else:
                rewards = reward
        advantages, returns = gae_targets(rewards, value, done, bootstrap_value, cfg.gamma,
                                          cfg.gae_lambda)
        batch = PPOBatch(
            obs=obs.reshape(T * E, *obs.shape[2:]),
            action=action.reshape(T * E, *action.shape[2:]),
            log_prob_old=log_prob.reshape(T * E),
            value_old=value.reshape(T * E),
            advantage=advantages.reshape(T * E),
            ret=returns.reshape(T * E),
        )
        coefficients = (schedule.coefficients[0] if iteration is None
                        else schedule.coefficients_at(iteration))
        clip_eps, entropy_coef = coefficients.unbind()
        return ppo_update(net, opt, opt_state, batch, perms, cfg, schedule.optimizer,
                          clip_eps, entropy_coef)

    return update


def make_host_update_step(env_spec: EnvSpec, cfg: PPOConfig, can_truncate: bool = True):
    """`step(net, opt_state, schedule, generator, block, iteration) ->
    metrics`: `make_host_update_fn`'s update on an uploaded block (a dict of
    [T, E] tensors by field, `final_values` / `bootstrap_value` where the
    mirror gave them, `last_obs` where not), its permutations drawn from
    `generator`. The host loop replays it as one CUDA graph on the card."""
    update = make_host_update_fn(env_spec, cfg, can_truncate)

    def step(net, opt_state, schedule, generator, block, iteration) -> dict[str, torch.Tensor]:
        T, E = block["reward"].shape
        perms = draw_permutations(generator, cfg.epochs, T * E)
        return update(
            net, opt_state, schedule, block["obs"], block["action"], block["log_prob"],
            block["value"], block["reward"], block["done"], block["terminated"],
            block["final_obs"], block.get("last_obs"), perms,
            final_values=block.get("final_values"),
            bootstrap_value=block.get("bootstrap_value"), iteration=iteration)

    return step


def init_host_params(env_spec: EnvSpec, cfg: PPOConfig, seed: int = 0, device="cuda"):
    """(net, Adam state) on `device`, the weights drawn on the CPU from a
    generator seeded with `seed`."""
    device = resolve_device(device)
    net = make_network(env_spec, cfg, torch.Generator().manual_seed(seed)).to(device)
    return net, make_optimizer(cfg).init(dict(net.named_parameters()))


def make_greedy_act(env_spec: EnvSpec, cfg: PPOConfig):
    """`act(net, obs)`: the mode action, for the host eval."""
    return lambda net, obs: net(obs)[0].mode()


def train_host(
    pool,
    cfg: PPOConfig,
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
    device="cuda",
    iteration_hook=None,
):
    """PPO on a `HostEnvPool` (MuJoCo etc.): a host rollout of T steps of
    the E envs, one upload, one device update (`make_host_update_step`,
    replayed as one CUDA graph on the card: `host_loop.HostUpdate`).

    With `eval_every > 0` a frozen-stats eval pool runs a greedy (mode
    action) sweep on that cadence; with `ckpt` the run resumes exactly on
    the device side (the net, Adam, the generator, the normalizer stats;
    the host envs restart fresh episodes: `host_loop.host_resume`).

    With `overlap` the host acts through the numpy mirror with parameters
    one update stale, so the update of block N runs on the device while
    block N+1 is collected; the recorded log-probs and values, the
    truncation bootstraps and the rollout bootstrap all come from those
    behaviour parameters, and the clipped ratio corrects the staleness.
    The clip-ε and entropy anneal follow the iteration (JAX's `progress`),
    the learning rate Adam's count. `iteration_hook(it, run)` is called
    after each iteration's dispatch with the loop's `host_loop.HostRun`.
    Returns (net, opt_state, history)."""
    from actor_critic_tpu_torch.algos import host_loop
    from actor_critic_tpu_torch.models import host_actor

    device = resolve_device(device)
    spec = pool.spec
    net, opt_state = init_host_params(spec, cfg, seed, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    schedule = make_schedule(cfg, device)
    iteration = torch.zeros(1, dtype=torch.int64, device=device)
    policy_step = make_policy_step(spec, cfg)
    update_step = make_host_update_step(spec, cfg, can_truncate=True)
    mirrored = host_actor.supports_mirror(host_actor.mirror_params(net))

    eval_pool = eval_act = None
    if eval_every > 0:
        eval_pool = pool.eval_pool(eval_envs)
        eval_act = host_loop.greedy_eval_act(
            net, make_greedy_act(spec, cfg),
            host_actor.make_ppo_host_greedy(spec, cfg) if mirrored else None, device)

    start_it = 0
    if ckpt is not None and resume:
        template = host_loop.host_ckpt_state(pool, generator, params=net, opt_state=opt_state)
        _, start_it = host_loop.host_resume(ckpt, template, pool)

    obs = pool.reset()
    tracker = host_loop.EpisodeTracker(pool.num_envs)
    history: list = []
    metrics: dict = {}
    buffers = host_loop.BlockBuffers(cfg.rollout_steps, device)
    clock = host_loop.IterationClock(device)

    snapshot = None
    if overlap and mirrored:
        host_policy = host_actor.make_ppo_host_policy(spec, cfg)
        host_value = host_actor.make_ppo_host_value(spec, cfg)
        snapshot = host_actor.MirrorSnapshot(net, pin=device.type == "cuda")
        snapshot.enqueue()
        rng = np.random.default_rng(seed + 0x5EED)
    else:
        device_policy = host_loop.device_act(lambda o: policy_step(net, o, generator), device)

    def body() -> dict[str, torch.Tensor]:
        return update_step(net, opt_state, schedule, generator, buffers.static, iteration)

    update = host_loop.HostUpdate(body, generator, name="ppo.host_update",
                                  carried=lambda: named_carried(
                                      {"params": net, "opt_state": opt_state,
                                       "block": buffers.static}, ""))
    run = host_loop.HostRun(buffers, snapshot, update,
                            {"params": net, "opt_state": opt_state}, clock)
    if start_it < num_iterations:
        host_loop.warm_update("ppo.make_host_update_step", update, buffers,
                              host_block_spec(spec, cfg, snapshot is not None))
    steps_per_iter = cfg.rollout_steps * pool.num_envs
    for it in range(start_it, num_iterations):
        telemetry.profiler_tick()
        with telemetry.span("iteration", it=it + 1):
            clock.start()
            if snapshot is not None:
                t0 = time.perf_counter()
                host_params = snapshot.params()
                clock.add("wait_s", time.perf_counter() - t0)

                def policy_act(o):
                    action, logp, value = host_policy(host_params, o, rng)
                    return action, {"log_prob": logp, "value": value}
            else:

                def policy_act(o):
                    action, logp, value = device_policy(o)
                    return action, {"log_prob": logp, "value": value}

            t0 = time.perf_counter()
            wait0 = buffers.wait_s
            obs, block = host_loop.host_collect(pool, obs, cfg.rollout_steps, policy_act,
                                                tracker, buffers=buffers)
            if snapshot is not None:
                # Every GAE baseline from the behaviour parameters that gave
                # the recorded values.
                T, E = block["reward"].shape
                final_obs = block["final_obs"]
                fv = host_value(host_params, final_obs.reshape(T * E, *final_obs.shape[2:]))
                buffers.put("final_values", fv.reshape(T, E))
                buffers.put("bootstrap_value", host_value(host_params, obs))
            else:
                buffers.put("last_obs", obs)
            t1 = time.perf_counter()
            clock.add("wait_s", buffers.wait_s - wait0)
            clock.add("collect_s", t1 - t0 - (buffers.wait_s - wait0))
            clock.mark()
            with telemetry.span("host_to_device"):
                buffers.upload()
                iteration.fill_(it)
            clock.mark()
            if snapshot is not None:
                # The next block's acting parameters: this update's input,
                # copied in stream order before its replay.
                snapshot.enqueue()
            # The replay returns once it is queued: the span is the host's
            # launch time, not the update's device time.
            with telemetry.span("update", dispatch="async"):
                metrics = update()
            clock.mark()
            clock.add("dispatch_s", time.perf_counter() - t1)
            extra = {"env_steps": (it + 1) * steps_per_iter}
            if eval_pool is not None and (it + 1) % eval_every == 0:
                extra.update(host_loop.timed_eval(eval_pool, eval_act(), eval_steps))
            host_loop.maybe_log(it, log_every, metrics, tracker, history, log_fn, extra=extra,
                                num_iterations=num_iterations,
                                force="eval_return" in extra or it == start_it, clock=clock)
            host_loop.host_maybe_save(ckpt, it + 1, save_every, num_iterations, pool, metrics,
                                      generator, params=net, opt_state=opt_state)
            if iteration_hook is not None:
                iteration_hook(it + 1, run)
    return net, opt_state, history


# --------------------------------------------------------------------------
# The async actor-learner: actor threads on host pools, a queue, and a
# learner correcting the blocks' staleness with V-trace
# --------------------------------------------------------------------------

CORRECTIONS = ("vtrace", "none")


def async_block_spec(spec: EnvSpec, cfg: PPOConfig, actors: int,
                     correction: str = "vtrace") -> dict:
    """name → `data_plane.ring.ArraySpec` of the [T, E_a] block an async
    `ActorService` pushes (E_a = num_envs // actors; discrete actions are
    int64, the numpy mirror's argmax): the device ring's storage spec.
    `correction="none"` blocks also carry the mirror's `final_values` and
    `bootstrap_value` (the `block_extras` contract)."""
    from actor_critic_tpu_torch.data_plane.ring import array_spec as s

    actors = max(int(actors), 1)
    T = cfg.rollout_steps
    E = cfg.num_envs // actors

    def obs_s(lead):
        # Host pools emit float32 observations (pixel pools are not ported).
        return s((*lead, *spec.obs_shape), "float32")

    action = s((T, E), "int64") if spec.discrete else s((T, E, spec.action_dim), "float32")
    out = {
        "obs": obs_s((T, E)),
        "action": action,
        "log_prob": s((T, E), "float32"),
        "value": s((T, E), "float32"),
        "reward": s((T, E), "float32"),
        "done": s((T, E), "float32"),
        "terminated": s((T, E), "float32"),
        "final_obs": obs_s((T, E)),
        "last_obs": obs_s((E,)),
    }
    if correction == "none":
        out["final_values"] = s((T, E), "float32")
        out["bootstrap_value"] = s((E,), "float32")
    return out


def host_block_spec(spec: EnvSpec, cfg: PPOConfig, mirror: bool) -> dict:
    """name → `ArraySpec` of the [T, E] block the lockstep `train_host`
    uploads: `async_block_spec`'s one-actor block with the mirror's
    baselines (`final_values`, `bootstrap_value`) where the mirror acts,
    `last_obs` where the device acts."""
    drop = ("last_obs",) if mirror else ("final_values", "bootstrap_value")
    return {k: v for k, v in async_block_spec(spec, cfg, 1, "none").items() if k not in drop}


def make_async_update_fn(env_spec: EnvSpec, cfg: PPOConfig, can_truncate: bool = True,
                         correction: str = "vtrace", rho_bar: float = 1.0, c_bar: float = 1.0,
                         group: Group = None):
    """The staleness-corrected update of the async learner:
    `update(net, opt_state, schedule, obs, action, log_prob, value, reward,
    done, terminated, final_obs, last_obs, perms, iteration=None) ->
    metrics`, on [T, E_a] tensors, the net and `opt_state` written in place.

    The trajectory was acted under older parameters, so the targets come
    from the LEARNER's: the policy's log-probs of the stored actions, the
    values at the stored observations, the rollout bootstrap and the
    truncation bootstrap, all re-evaluated here; then V-trace
    (`common.corrected_advantages`, the CUDA kernel on the card) from the
    recorded BEHAVIOUR log-probs gives the value targets and the
    policy-gradient advantages, and `ppo_update` runs the epochs on the
    corrected batch (IMPACT-style reuse; the recorded behaviour value stays
    the value-clip anchor). The metrics add `mean_rho`, the mean clipped
    ratio. Coefficients as `make_host_update_fn`'s.

    With a process `group` this is the multi-process sync learner's update
    (`parallel/multihost.py`, JAX's `axis_name=DP_AXIS`): each rank passes
    its own [T, E_a] block, V-trace stays local (its columns are
    independent), the advantage statistics and every minibatch's gradients
    are pmean'd (one flat all-reduce, its buffer allocated at the first
    call) and so are the returned metrics; every rank must draw the same
    permutations. On the card the all-reduces are NCCL's, captured in the
    update's CUDA graph."""
    if correction != "vtrace":
        raise ValueError(f"unknown correction: {correction!r}")
    opt = make_optimizer(cfg)
    grad_sync = None if group is None else FlatGradients(group)

    def async_update(net, opt_state, schedule, obs, action, log_prob, value, reward, done,
                     terminated, final_obs, last_obs, perms, iteration=None):
        T, E = reward.shape
        flat_obs = obs.reshape(T * E, *obs.shape[2:])
        flat_act = action.reshape(T * E, *action.shape[2:])
        with torch.no_grad():
            dist, values_cur = net(flat_obs)
            target_lp = dist.log_prob(flat_act).reshape(T, E)
            values_cur = values_cur.reshape(T, E)
            _, bootstrap = net(last_obs)
            if can_truncate:
                _, fv = net(final_obs.reshape(T * E, *final_obs.shape[2:]))
                truncated = done * (1.0 - terminated)
                rewards = reward + cfg.gamma * fv.reshape(T, E) * truncated
            else:
                rewards = reward
        pg_adv, vs, mean_rho = corrected_advantages(
            target_lp, log_prob, rewards, values_cur, done, bootstrap, cfg.gamma,
            cfg.gae_lambda, rho_bar=rho_bar, c_bar=c_bar, correction="vtrace")
        batch = PPOBatch(
            obs=flat_obs,
            action=flat_act,
            log_prob_old=log_prob.reshape(T * E),
            value_old=value.reshape(T * E),
            advantage=pg_adv.reshape(T * E),
            ret=vs.reshape(T * E),
        )
        coefficients = (schedule.coefficients[0] if iteration is None
                        else schedule.coefficients_at(iteration))
        clip_eps, entropy_coef = coefficients.unbind()
        metrics = ppo_update(net, opt, opt_state, batch, perms, cfg, schedule.optimizer,
                             clip_eps, entropy_coef, grad_sync)
        # Each rank saw its own minibatches: the fleet's metrics are the mean.
        return pmean_tree(dict(metrics, mean_rho=mean_rho), group)

    return async_update


def make_async_update_step(env_spec: EnvSpec, cfg: PPOConfig, can_truncate: bool = True,
                           correction: str = "vtrace", rho_bar: float = 1.0,
                           c_bar: float = 1.0, group: Group = None):
    """`step(net, opt_state, schedule, generator, block, iteration) ->
    metrics` of the async learner, on a [T, E_a] block by field, its
    permutations drawn from `generator` (`make_host_update_step`'s
    signature). `correction="vtrace"`: `make_async_update_fn`'s update.
    `correction="none"` returns `make_host_update_step` itself, the
    synchronous host path's update (the lockstep-equivalence tests rely on
    it), which takes no `group`: only V-trace has a data-parallel update
    (the sync learner refuses "none")."""
    if correction == "none":
        if group is not None:
            raise ValueError("the data-parallel update is V-trace's: correction='none' has "
                             "no group variant")
        return make_host_update_step(env_spec, cfg, can_truncate)
    update = make_async_update_fn(env_spec, cfg, can_truncate, correction, rho_bar, c_bar,
                                  group)

    def step(net, opt_state, schedule, generator, block, iteration) -> dict[str, torch.Tensor]:
        T, E = block["reward"].shape
        perms = draw_permutations(generator, cfg.epochs, T * E)
        return update(net, opt_state, schedule, block["obs"], block["action"], block["log_prob"],
                      block["value"], block["reward"], block["done"], block["terminated"],
                      block["final_obs"], block["last_obs"], perms, iteration=iteration)

    return step


def make_device_update_step(env_spec: EnvSpec, cfg: PPOConfig, ring_codecs: dict,
                            can_truncate: bool = True, correction: str = "vtrace",
                            rho_bar: float = 1.0, c_bar: float = 1.0):
    """The device data plane's update: `step(net, opt_state, schedule,
    generator, ring_state, slot, iteration) -> metrics` gathers the slot
    from the ring and decodes it (`data_plane.ring.gather_block`), then runs
    `make_async_update_step`'s body, all in one CUDA graph on the card; the
    slot index is its only input per block. With the all-raw fp32 codec it
    computes bit for bit what the host plane's update computes."""
    from actor_critic_tpu_torch.data_plane.ring import gather_block

    step = make_async_update_step(env_spec, cfg, can_truncate, correction, rho_bar, c_bar)

    def device_update(net, opt_state, schedule, generator, ring_state, slot,
                      iteration) -> dict[str, torch.Tensor]:
        block = gather_block(ring_state, slot, ring_codecs)
        return step(net, opt_state, schedule, generator, block, iteration)

    return device_update


def train_host_async(
    pools,
    cfg: PPOConfig,
    num_iterations: int,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    eval_every: int = 0,
    eval_envs: int = 4,
    eval_steps: int = 1000,
    updates_per_block: int = 1,
    queue_depth: int = 4,
    max_staleness: Optional[int] = 8,
    correction: str = "vtrace",
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    strict_lockstep: bool = False,
    ckpt=None,
    save_every: int = 0,
    resume: bool = False,
    data_plane: str = "host",
    plane_codec: str = "fp32",
    transfer_pad_s: float = 0.0,
    device="cuda",
    iteration_hook=None,
    publish_hook: Optional[Callable[[int, Any], None]] = None,
    gate=None,
):
    """Async actor-learner PPO on host env pools.

    One `traj_queue.ActorService` thread per pool collects [T, E_a] blocks
    through the numpy mirror (parameters refreshed from the
    `PolicyPublisher` once a block) and pushes them into a bounded queue;
    this (learner) thread takes them as they come (a straggler slows only
    its own contribution), corrects the behaviour lag with V-trace
    (`make_async_update_step`) and reuses each block for `updates_per_block`
    updates. A full queue drops its OLDEST block rather than block an
    actor; `max_staleness` drops blocks that aged past the bound while
    queued. `num_iterations` counts consumed blocks.

    On the card each update is one CUDA graph (`host_loop.HostUpdate`,
    captured in "thread_local" mode while the actors run). Before the
    update's replay the learner enqueues a copy of its parameters
    (`MirrorSnapshot`), and after it publishes that copy, the update's
    INPUT, once its event has completed: the actors' next blocks act with
    parameters one update stale, and the learner waits for the previous
    update only once the next is enqueued.

    `data_plane="device"` swaps the host `TrajQueue` for the
    `data_plane.DeviceTrajRing`: actors enqueue encoded blocks (`plane_codec`
    fp32/f16/int8) on the slot's stream, and the update gathers and decodes
    the slot inside its graph (`make_device_update_step`): the learner
    copies no block to the card. `transfer_pad_s` pads every block copy
    (the learner's staging on the host plane, the actor's enqueue on the
    device plane).

    Needs the numpy mirror (MLP torsos). With `ckpt` the run saves on the
    consumed-block cadence: the net, Adam, the generator and ALL A actor
    pools' normalizer stats (and the ring's quantizer stats on the device
    plane), and `resume` restores them; actors restart fresh episodes, and
    `--async-actors` must not change across a resume. `strict_lockstep`
    is the test hook: with one actor, `queue_depth=1`,
    `updates_per_block=1` and `correction="none"` the run is `train_host`
    bit for bit. `iteration_hook(it, run)` is called after each block's
    updates are enqueued, before its slot is released.
    `publish_hook(it, np_params)` (serve-while-training) is called right
    after block `it`'s publish with the publisher's frozen copy, and once
    after the last block with the final parameters (`it` =
    `num_iterations`). `gate` (a `threading.Event`, a fresh one by default)
    is cleared while an update runs eagerly or is captured: the actors, and
    a serving sidecar's flushes, wait on it. Under a warm-up plan that
    names the update's entry (`utils/compile_cache.py`) that happens once,
    before the actors start (`host_loop.warm_update`), and never during
    training. Returns (net, opt_state, history)."""
    import threading

    from actor_critic_tpu_torch.algos import host_loop
    from actor_critic_tpu_torch.algos.traj_queue import (
        ActorService,
        PolicyPublisher,
        consume_block,
        validate_pools,
    )
    from actor_critic_tpu_torch.models import host_actor

    spec, E_a = validate_pools(pools)
    if updates_per_block < 1:
        raise ValueError("updates_per_block must be >= 1")
    if correction not in CORRECTIONS:
        raise ValueError(f"unknown correction: {correction!r}")
    if data_plane not in host_loop.DATA_PLANES:
        raise ValueError(f"data_plane must be 'host' or 'device', got {data_plane!r}")
    device = resolve_device(device)
    net, opt_state = init_host_params(spec, cfg, seed, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    schedule = make_schedule(cfg, device)
    iteration = torch.zeros(1, dtype=torch.int64, device=device)
    if not host_actor.supports_mirror(host_actor.mirror_params(net)):
        raise ValueError("async actor-learner mode needs the numpy actor mirror (MLP torso; "
                         "models/host_actor.py): pixel pools must run the lockstep train_host")
    host_policy = host_actor.make_ppo_host_policy(spec, cfg)
    host_value = host_actor.make_ppo_host_value(spec, cfg)
    queue = host_loop.make_async_queue(
        data_plane, queue_depth, None if strict_lockstep else max_staleness,
        "block" if strict_lockstep else "drop_oldest",
        block_spec=async_block_spec(spec, cfg, len(pools), correction), codec=plane_codec,
        transfer_pad_s=transfer_pad_s, device=device)
    feed = host_loop.AsyncFeed(queue, cfg.rollout_steps, device, transfer_pad_s)
    if feed.device_plane:
        device_update = make_device_update_step(spec, cfg, queue.codecs, True, correction,
                                                rho_bar, c_bar)

        def body() -> dict[str, torch.Tensor]:
            return device_update(net, opt_state, schedule, generator, queue.state,
                                 queue.slot_index, iteration)
    else:
        update_step = make_async_update_step(spec, cfg, True, correction, rho_bar, c_bar)

        def body() -> dict[str, torch.Tensor]:
            return update_step(net, opt_state, schedule, generator, feed.buffers.static,
                               iteration)

    def make_act_fn(actor_params, rng):
        def act(o):
            action, logp, value = host_policy(actor_params, o, rng)
            return action, {"log_prob": logp, "value": value}

        return act

    block_extras = None
    if correction == "none":
        # The lockstep update takes its truncation and rollout bootstraps
        # from the SAME behaviour parameters as the recorded values; V-trace
        # re-evaluates every value under the learner's instead.
        def block_extras(actor_params, last_obs, block):
            T_, E_ = block["reward"].shape
            fo = block["final_obs"]
            fv = host_value(actor_params, fo.reshape(T_ * E_, *fo.shape[2:])).reshape(T_, E_)
            return {"final_values": fv, "bootstrap_value": host_value(actor_params, last_obs)}

    def device_state() -> dict:
        state = {"params": net, "opt_state": opt_state}
        if feed.device_plane:
            # The ring's stats only: its blocks are transient.
            state["ring_quant"] = host_loop.ring_quant_tensors(queue.quant_host())
        return state

    start_it = 0
    if ckpt is not None and resume:
        template = host_loop.async_host_ckpt_state(pools, generator, **device_state())
        restored, start_it = host_loop.async_host_resume(ckpt, template, pools, data_plane)
        if restored is not None and feed.device_plane:
            queue.install_quant(host_loop.ring_quant_tree(template.device_state["ring_quant"]))

    publisher = PolicyPublisher(host_actor.mirror_params(net), version=start_it)
    stop, gate = threading.Event(), gate if gate is not None else threading.Event()
    gate.set()
    actors = [
        # Actor 0 draws the lockstep trainer's stream; the others offset by a
        # large prime.
        ActorService(i, pool, queue, publisher, cfg.rollout_steps, make_act_fn,
                     rng=np.random.default_rng(seed + 0x5EED + i * 7919), stop=stop,
                     block_extras=block_extras, strict=strict_lockstep, gate=gate)
        for i, pool in enumerate(pools)
    ]
    eval_pool = eval_act = None
    if eval_every > 0:
        # The LAST pool's: in straggler layouts that is the fast actor.
        eval_pool = pools[-1].eval_pool(eval_envs)
        eval_act = host_loop.greedy_eval_act(net, make_greedy_act(spec, cfg),
                                             host_actor.make_ppo_host_greedy(spec, cfg), device)

    snapshot = host_actor.MirrorSnapshot(net, pin=device.type == "cuda")
    update = host_loop.HostUpdate(
        body, generator, capture_error_mode="thread_local", name="ppo.async_update",
        carried=lambda: named_carried({"params": net, "opt_state": opt_state, "block": (
            feed.buffers.static if feed.buffers is not None else queue.state)}, ""))
    clock = host_loop.IterationClock(device)
    run = host_loop.HostRun(feed.buffers, snapshot, update,
                            {"params": net, "opt_state": opt_state}, clock, queue, gate)
    if start_it < num_iterations:
        # Captured before the actors start: the gate is not cleared for it
        # once training runs.
        host_loop.warm_update(
            "ppo.make_device_update_step" if feed.device_plane else "ppo.make_async_update_step",
            update, feed.buffers, async_block_spec(spec, cfg, len(pools), correction), gate)
    history: list = []
    metrics: dict = {}
    trackers = host_loop.MergedEpisodeTracker([a.tracker for a in actors])
    try:
        if start_it < num_iterations:
            # A resume that finds the run complete starts NO actors:
            # collection would only move the restored normalizer stats.
            for a in actors:
                a.start()
        for it in range(start_it, num_iterations):
            telemetry.profiler_tick()
            host_loop.check_actors(actors)
            with telemetry.span("iteration", it=it + 1):
                queue.set_consumer_version(it)
                with telemetry.span("queue_wait", it=it + 1):
                    block = consume_block(queue, actors)
                clock.start(("wait_s", "dispatch_s"))
                t0 = time.perf_counter()
                wait0 = feed.wait_s
                clock.mark()
                host_loop.stage_block(feed, block)
                iteration.fill_(it)
                clock.mark()
                # The actors' next parameters: this update's input, copied in
                # stream order before its replay.
                snapshot.enqueue()
                with telemetry.span("update", dispatch="async"):
                    metrics = host_loop.run_updates(update, updates_per_block, gate)
                clock.mark()
                if iteration_hook is not None:
                    iteration_hook(it + 1, run)
                feed.done(block)
                waited = feed.wait_s - wait0
                clock.add("dispatch_s", time.perf_counter() - t0 - waited)
                clock.add("wait_s", waited + host_loop.publish_snapshot(snapshot, publisher, it))
                if publish_hook is not None:
                    publish_hook(it, publisher.get()[1])
                extra = host_loop.async_row(it, block, queue, actors, cfg.rollout_steps * E_a)
                if eval_pool is not None and (it + 1) % eval_every == 0:
                    extra.update(host_loop.timed_eval(eval_pool, eval_act(), eval_steps))
                host_loop.maybe_log(it, log_every, metrics, trackers, history, log_fn,
                                    extra=extra, num_iterations=num_iterations,
                                    force="eval_return" in extra or it == start_it, clock=clock)
                if ckpt is not None:
                    host_loop.async_host_maybe_save(ckpt, it + 1, save_every, num_iterations,
                                                    pools, metrics, generator, data_plane,
                                                    **device_state())
        if publish_hook is not None:
            publish_hook(num_iterations, host_actor.mirror_params(net))
    finally:
        host_loop.stop_actors(stop, actors, queue)
        if eval_pool is not None:
            eval_pool.close()
    return net, opt_state, history


# -- the warm-up registry (utils/compile_cache.py) ---------------------------
from actor_critic_tpu_torch.utils import compile_cache as _compile_cache  # noqa: E402


def _advantage_kernel(correction: str) -> tuple[str, ...]:
    return ("vtrace",) if correction == "vtrace" else ("gae",)


@_compile_cache.register_warmup("ppo.make_policy_step")
def _warmup_policy_step(ctx):
    """The host loop's device act (no mirror, or no overlap) runs eagerly,
    one call an env step: nothing to capture."""
    return None


@_compile_cache.register_warmup("ppo.make_host_update_step")
def _warmup_host_update(ctx):
    """The lockstep host update (`train_host`): GAE built, its graph captured
    on a zero block before the first iteration. Async runs capture the
    update of their plane instead."""
    if ctx.fused or ctx.algo != "ppo" or ctx.async_actors:
        return None
    return _compile_cache.warmup_of(ctx, ("gae",), host=True)


@_compile_cache.register_warmup("ppo.make_async_update_step")
def _warmup_async_update(ctx):
    """The async learner's update on the host plane ([T, E_a] blocks;
    V-trace, or GAE with correction none), captured before the actors
    start."""
    if (ctx.fused or ctx.algo != "ppo" or not ctx.async_actors
            or ctx.data_plane == "device"):
        return None
    return _compile_cache.warmup_of(ctx, _advantage_kernel(ctx.async_correction), host=True)


@_compile_cache.register_warmup("ppo.make_device_update_step")
def _warmup_device_update(ctx):
    """The device data plane's update (the ring's slot gathered, decoded and
    learned from in one graph), captured before the actors start."""
    if (ctx.fused or ctx.algo != "ppo" or not ctx.async_actors
            or ctx.data_plane != "device"):
        return None
    return _compile_cache.warmup_of(ctx, _advantage_kernel(ctx.async_correction), host=True)


@_compile_cache.register_warmup("ppo.make_greedy_act")
def _warmup_greedy_act(ctx):
    """The host eval acts eagerly (through the numpy mirror, or the module on
    the device at each step): nothing to capture."""
    return None


_compile_cache.register_fused_warmups("ppo", ("ppo",), lambda cfg: ("gae",))
