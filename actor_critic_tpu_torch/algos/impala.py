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
sequence-parallel learner (`make_sp_update`, `make_sp_train_step`) splits
a long trajectory's time axis over a process group (`parallel/seqpar.py`),
and `make_train_step(group=...)` is the data-parallel step
(`parallel/dp.py`).

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
from actor_critic_tpu_torch.parallel.mesh import FlatGradients, Group, Mesh, pmean_tree
from actor_critic_tpu_torch.parallel.seqpar import SP_AXIS, time_segment

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
    time_group: Group = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """V-trace (or A3C λ-return) actor-critic loss on a [T, E] trajectory.

    The learner re-evaluates π/V at `traj.obs`; `traj.log_prob` holds the
    BEHAVIOUR policy's log-probs from rollout time, so the ratios π/μ are
    exact under any staleness. V-trace takes the learner's (detached)
    values, the bootstrap from the learner at `bootstrap_obs`, and the
    truncation bootstrap from the learner's critic at `final_obs`; those
    two forwards need no gradient (their values only reach the loss as
    gradient constants) and run without one.

    With `time_group` the trajectory is this rank's TIME segment of a
    longer one (sequence parallelism): V-trace (or GAE) runs through
    `parallel.seqpar` over the group (halo, the kernel on the segment,
    boundary chain), and the loss and metrics are the segment's means,
    whose gradients the caller pmeans over the group (equal segments make
    that the whole trajectory's gradient)."""
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
        time_group=time_group,
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
    grad_sync: Optional[FlatGradients] = None,
) -> dict[str, torch.Tensor]:
    """One clipped-RMSProp step on `impala_loss` for a rollout `traj` whose
    next obs is `state.rollout.obs`, the actor refresh at its boundary, and
    episode accounting. Updates `state` in place; returns the metrics as
    device tensors. With `grad_sync` (a data-parallel group's
    `FlatGradients`) the gradients are pmean'd through one all-reduce
    before the clip and RMSProp, and the return EMA and the metrics are
    pmean'd / aggregated over the group."""
    net = state.net
    group = None if grad_sync is None else grad_sync.group
    params = dict(net.named_parameters())
    loss, metrics = impala_loss(net, traj, state.rollout.obs, cfg, env.spec.can_truncate)
    grads = torch.autograd.grad(loss, list(params.values()))
    if grad_sync is not None:
        grads = grad_sync(grads)
    opt.step(params, dict(zip(params, grads)), state.opt_state)
    _refresh_actors(cfg, state)
    return aggregate_metrics(metrics, fold_episodes(state, traj, group), group)


def _refresh_actors(cfg: ImpalaConfig, state: ImpalaTrainState) -> None:
    """Count the step; then the k-step policy lag: the actors pick up the
    learner's parameters only at refresh boundaries (k=1 is on-policy:
    every ρ is exactly 1), selected on the device."""
    advance(state)
    refresh = state.step_counter % cfg.actor_refresh_every == 0
    with torch.no_grad():
        for a, p in zip(state.actor_net.parameters(), state.net.parameters()):
            a.copy_(torch.where(refresh, p, a))


def make_train_step(
    env: TorchEnv, cfg: ImpalaConfig, group: Group = None
) -> Callable[[ImpalaTrainState], tuple[ImpalaTrainState, dict[str, torch.Tensor]]]:
    """`train_step(state) -> (state, metrics)`: stale-actor rollout, then
    the learner's update. `group` is the data-parallel ranks' process
    group (JAX's `axis_name`), None for one device; the step carries it as
    `train_step.group`."""
    opt = make_optimizer(cfg)
    grad_sync = None if group is None else FlatGradients(group)

    def train_step(state: ImpalaTrainState) -> tuple[ImpalaTrainState, dict[str, torch.Tensor]]:
        traj = rollout(env, cfg, state)
        return state, update(env, cfg, opt, state, traj, grad_sync)

    train_step.group = group
    return train_step


def _sp_layout(mesh: Mesh, axis_name: Optional[str], dp_axis_name: Optional[str]):
    """(time axis, time group, reduce group, dp group) of an sp layout: the
    gradients and metrics reduce over every axis of the layout, which is
    the mesh's whole grid."""
    axis_name = axis_name or SP_AXIS
    axes = (axis_name,) if dp_axis_name is None else (axis_name, dp_axis_name)
    if set(axes) != set(mesh.axis_names):
        raise ValueError(f"an sp layout over {axes} on a mesh of {mesh.axis_names}")
    dp_group = None if dp_axis_name is None else mesh.group(dp_axis_name)
    return axis_name, mesh.group(axis_name), mesh.group(*axes), dp_group


def _sp_local_update(env: TorchEnv, cfg: ImpalaConfig, time_group: Group, reduce_group: Group):
    """`local(net, opt_state, segment, bootstrap_obs) -> metrics`: one
    clipped-RMSProp step on this rank's time segment (and env shard), the
    gradients and metrics pmean'd over `reduce_group`."""
    opt = make_optimizer(cfg)
    grad_sync = FlatGradients(reduce_group)

    def local(net: nn.Module, opt_state, traj: Transition,
              bootstrap_obs: torch.Tensor) -> dict[str, torch.Tensor]:
        params = dict(net.named_parameters())
        loss, metrics = impala_loss(net, traj, bootstrap_obs, cfg, env.spec.can_truncate,
                                    time_group)
        grads = grad_sync(torch.autograd.grad(loss, list(params.values())))
        opt.step(params, dict(zip(params, grads)), opt_state)
        return pmean_tree(metrics, reduce_group)

    return local


def make_sp_update(env: TorchEnv, cfg: ImpalaConfig, mesh: Mesh, axis_name: Optional[str] = None,
                   dp_axis_name: Optional[str] = None):
    """The sequence-parallel learner update for LONG trajectories: the
    [T, E] trajectory's time axis split over the mesh's "sp" axis, so each
    rank forwards π/V on its T/W slice and runs V-trace (or GAE) through
    `parallel.seqpar` (the kernel on its segment, one halo, one boundary
    chain), the gradients pmean'd over the axis. With `dp_axis_name` the
    layout is 2-D, sp × dp: the env axis is split over dp too and the
    gradients and metrics reduce over both axes (the mesh's whole grid).

    Returns `update(net, opt_state, traj, bootstrap_obs) -> metrics` on
    GLOBAL [T, E] arrays (T divisible by the sp size, E by the dp size):
    it cuts this rank's segment and shard, and writes the step into `net`
    and `opt_state` in place. On the card its first
    `loop.WARMUP_ITERATIONS` calls run eagerly on a side stream; the next
    captures it (collectives inside, "thread_local" mode) over static
    copies of the inputs, and every later call copies its inputs there and
    replays; the graph serves the `net` and `opt_state` it captured.
    `update.eager` is the step without the graph."""
    from actor_critic_tpu_torch.algos import loop

    axis_name, time_group, reduce_group, _ = _sp_layout(mesh, axis_name, dp_axis_name)
    local = _sp_local_update(env, cfg, time_group, reduce_group)

    def segment(traj: Transition, bootstrap_obs: torch.Tensor):
        if dp_axis_name is not None:
            n, j = mesh.shape[dp_axis_name], mesh.index(dp_axis_name)
            E = bootstrap_obs.shape[0]
            if E % n:
                raise ValueError(f"env axis {E} not divisible by {dp_axis_name}={n}")
            cols = slice(j * (E // n), (j + 1) * (E // n))
            traj = Transition(*(x[:, cols] for x in traj))
            bootstrap_obs = bootstrap_obs[cols].contiguous()
        return Transition(*(time_segment(x, mesh, axis_name) for x in traj)), bootstrap_obs

    def eager(net, opt_state, traj, bootstrap_obs):
        return local(net, opt_state, *segment(traj, bootstrap_obs))

    graphed: dict = {"calls": 0}

    def update(net, opt_state, traj, bootstrap_obs):
        seg, boot = segment(traj, bootstrap_obs)
        if not boot.is_cuda:
            return local(net, opt_state, seg, boot)
        if "graph" in graphed:
            if graphed["owner"] != (id(net), id(opt_state)):
                raise ValueError("make_sp_update's graph replays the net and optimizer state "
                                 "it captured")
            for buf, x in zip(graphed["static"], (*seg, boot), strict=True):
                buf.copy_(x)
            graphed["graph"].replay()
            return graphed["metrics"]
        if graphed["calls"] < loop.WARMUP_ITERATIONS:
            graphed["calls"] += 1
            return loop.eager_step(lambda _: local(net, opt_state, seg, boot), None,
                                   torch.cuda.Stream(boot.device))
        static = [x.clone() for x in (*seg, boot)]
        graph = torch.cuda.CUDAGraph()
        with loop.capture(graph, capture_error_mode="thread_local"):
            metrics = local(net, opt_state, Transition(*static[:-1]), static[-1])
        graphed.update(graph=graph, static=static, metrics=metrics,
                       owner=(id(net), id(opt_state)))
        return update(net, opt_state, traj, bootstrap_obs)

    update.eager = eager
    return update


def make_sp_train_step(env: TorchEnv, cfg: ImpalaConfig, mesh: Mesh,
                       axis_name: Optional[str] = None, dp_axis_name: Optional[str] = None):
    """ONE step: rollout (stale actors) → this rank's time segment →
    sequence-parallel update → actor refresh, over the mesh's "sp" axis
    (and its "dp" axis with `dp_axis_name`). The rollout is sequential in
    time, so it runs env-parallel: rank (i, j) rolls out env shard j's
    whole [T, E/dp] trajectory, the same on every sp index i (the state
    distributed over dp only, `parallel.dp.distribute_state`, so its
    generator is shard j's), folds its episodes (aggregated over dp) and
    keeps time segment i for the learner: JAX's all-to-all between the two
    layouts is a slice here. The update's metrics are reduced over the
    whole grid. Equal to `make_train_step` (with the dp group) up to the
    sharded scans' rounding.

    Returns `train_step(state) -> (state, metrics)`, writing `state` in
    place. On the card its first `loop.WARMUP_ITERATIONS` calls run
    eagerly on a side stream and the next captures the step ("thread_local"
    mode) for the `state` it is given, replayed from then on;
    `train_step.eager` is the step without the graph."""
    from actor_critic_tpu_torch.algos import loop

    axis_name, time_group, reduce_group, dp_group = _sp_layout(mesh, axis_name, dp_axis_name)
    local = _sp_local_update(env, cfg, time_group, reduce_group)

    def eager(state: ImpalaTrainState) -> tuple[ImpalaTrainState, dict[str, torch.Tensor]]:
        traj = rollout(env, cfg, state)
        ep_metrics = fold_episodes(state, traj, dp_group)
        segment = Transition(*(time_segment(x, mesh, axis_name) for x in traj))
        metrics = local(state.net, state.opt_state, segment, state.rollout.obs)
        _refresh_actors(cfg, state)
        return state, {**metrics, **aggregate_metrics({}, ep_metrics, dp_group)}

    graphed: dict = {"calls": 0}

    def train_step(state: ImpalaTrainState) -> tuple[ImpalaTrainState, dict[str, torch.Tensor]]:
        if not state.ep_return.is_cuda:
            return eager(state)
        if "step" in graphed:
            if graphed["state"] is not state:
                raise ValueError("make_sp_train_step's graph replays the state it captured")
            return state, graphed["step"].replay()
        if graphed["calls"] < loop.WARMUP_ITERATIONS:
            graphed["calls"] += 1
            return loop.eager_step(eager, state, torch.cuda.Stream(state.ep_return.device))
        graphed.update(state=state, step=loop.CapturedStep(eager, state,
                                                           capture_error_mode="thread_local"))
        return train_step(state)

    train_step.eager = eager
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
