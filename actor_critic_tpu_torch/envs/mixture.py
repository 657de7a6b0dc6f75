"""Heterogeneous scenario-mixture fleet (counterpart of
`actor_critic_tpu/envs/mixture.py`): many env TYPES in one batch.

- **Padded obs**: each member's vector obs is zero-padded to the widest
  member's width and multiplied by the type's row of the validity mask
  (`MixtureEnv.obs_masks`, [n_types, obs_max]), so a padded lane is
  exactly 0.0 whatever the member emits.
- **One discrete action space** of width max over members (a discrete
  member's action count, `action_bins` for a continuous one): a discrete
  member takes `a % n_i`; a continuous one takes `levels[a % action_bins]`
  of `linspace(−1, 1, action_bins)`, broadcast to its action dim.
- **A select per type where JAX switches**: every instance carries its
  `type_id` and one state slot per member. JAX's `lax.switch` under
  `vmap` steps every member for every instance and selects; here each
  member steps (and auto-resets) the whole batch, and an instance takes
  member i's outputs and member i's new slot only where `type_id == i`.
  Every other slot stays as it was (a parked slot keeps the state of its
  last episode start).
- **Types across episode ends**: a member's auto-reset redraws its
  scenario and keeps the type. With `redraw_types=True` (the curriculum
  mode) an episode end also redraws the instance's type from the
  `weights` the state carries, and fresh-resets the new member only where
  the type changed; a draw of the same type keeps the member's own reset.

Everything a step does is a tensor op on the batch with no host sync, and
the constant tables (masks, action levels, type ids, initial weights) are
built on the state's device before any capture (`env.DeviceTable`), so a
mixture step replays inside a CUDA graph. Types are drawn by inverse CDF
(a uniform, the cumulative normalized weights, a count of the entries
below): no `multinomial`, no boolean-mask indexing.

Curriculum: `Curriculum` / `CurriculumController` advance a stage when
the eval progress crosses a threshold; `set_fleet_weights` writes the
stage's weights and the stage into the fleet state IN PLACE (a captured
step reads the addresses it saw). Per-type eval: `make_typed_eval`
evaluates the current policy on a fleet pinned to one type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from actor_critic_tpu_torch.envs.env import DeviceTable, EnvSpec, StepOutput, TorchEnv
from actor_critic_tpu_torch.tree import tree_map


def member_makers() -> dict[str, Callable[..., TorchEnv]]:
    """Name → maker for every env type a mixture can include."""
    from actor_critic_tpu_torch.envs.acrobot import make_acrobot
    from actor_critic_tpu_torch.envs.cartpole import make_cartpole
    from actor_critic_tpu_torch.envs.maze import make_maze
    from actor_critic_tpu_torch.envs.pendulum import make_pendulum

    return {
        "cartpole": make_cartpole,
        "pendulum": make_pendulum,
        "acrobot": make_acrobot,
        "maze": make_maze,
    }


# Greedy eval return at or above which a member counts as solved.
SOLVE_BARS: dict[str, float] = {
    "cartpole": 475.0,
    "pendulum": -300.0,
    "acrobot": -100.0,
    "maze": 0.0,
}


def parse_mixture_spec(spec) -> list[tuple[str, float]]:
    """`"cartpole*2,pendulum,acrobot"` → [(name, weight), ...]: weights
    default to 1, the order numbers the types, a member appears once."""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",") if p.strip()]
    else:
        parts = [str(p) for p in spec]
    if not parts:
        raise ValueError("mixture spec names no members")
    valid = member_makers()
    out: list[tuple[str, float]] = []
    for part in parts:
        name, _, w = part.partition("*")
        name = name.strip()
        if name not in valid:
            raise ValueError(f"unknown mixture member {name!r}; valid: {sorted(valid)}")
        if any(name == n for n, _ in out):
            raise ValueError(
                f"duplicate mixture member {name!r} — weight the draw "
                f"('{name}*2') instead of repeating the member"
            )
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            raise ValueError(f"bad weight in mixture member {part!r}")
        if weight < 0 or (w and weight != weight):
            raise ValueError(f"mixture weight must be >= 0, got {part!r}")
        out.append((name, weight))
    if not any(weight > 0 for _, weight in out):
        raise ValueError("mixture weights must not all be zero")
    return out


class MixtureState(NamedTuple):
    """The fleet's state: the active type, one state slot per member type
    (only the active one is live), and the curriculum's draw weights and
    stage, which the step carries and `set_fleet_weights` rewrites."""

    type_id: torch.Tensor  # [E] int64
    members: tuple
    weights: torch.Tensor  # [E, n_types] float32 draw weights
    stage: torch.Tensor    # [E] int32 curriculum stage


@dataclasses.dataclass(frozen=True)
class MixtureEnv(TorchEnv):
    """A TorchEnv whose fleet mixes member types, plus the mixture-only
    surface: member metadata, the obs-validity masks, type-pinned resets
    for the per-type eval, and the initial draw weights."""

    member_names: tuple[str, ...] = ()
    member_specs: tuple[EnvSpec, ...] = ()
    obs_masks: Optional[torch.Tensor] = None  # [n_types, obs_max] float32, on the CPU
    init_weights: tuple[float, ...] = ()
    # (num_envs, generator, type_id) -> (state, obs)
    reset_typed: Optional[Callable] = None
    redraw_types: bool = False

    @property
    def n_types(self) -> int:
        return len(self.member_names)


def _draw_types(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """[E] int64 types drawn from per-instance `weights` [E, n] with the
    uniforms `u` [E], by inverse CDF as `jax.random.choice` draws
    (searchsorted of total·(1 − u) in the cumulative weights). An all-zero
    weight row draws uniformly (no 0/0, and no bias to type 0)."""
    n = weights.shape[-1]
    total = weights.sum(-1, keepdim=True)
    p = torch.where(total > 0, weights / torch.clamp(total, min=1e-6), 1.0 / n)
    cdf = torch.cumsum(p, -1)
    r = cdf[:, -1:] * (1.0 - u[:, None])
    return (cdf < r).sum(-1)


def make_mixture(
    members: Any = "cartpole,pendulum,acrobot,maze",
    randomize: float = 0.0,
    action_bins: int = 5,
    redraw_types: bool = False,
    member_kwargs: Optional[dict] = None,
) -> MixtureEnv:
    """The heterogeneous fleet env. `members` is a spec string
    (`"cartpole*2,pendulum"`) or a name sequence; `randomize` goes to
    every member's scenario draw; `action_bins` discretizes a continuous
    member's action range; `redraw_types` redraws an instance's type from
    the state's weights at each episode end (the curriculum needs it);
    `member_kwargs` maps a member name to extra maker kwargs."""
    if action_bins < 2:
        raise ValueError(f"action_bins must be >= 2, got {action_bins}")
    parsed = parse_mixture_spec(members)
    names = tuple(n for n, _ in parsed)
    init_weights = tuple(w for _, w in parsed)
    makers = member_makers()
    member_kwargs = dict(member_kwargs or {})
    unknown = sorted(set(member_kwargs) - set(names))
    if unknown:
        raise ValueError(f"member_kwargs for non-member(s) {unknown}; members: {names}")
    envs = tuple(makers[n](randomize=randomize, **member_kwargs.get(n, {})) for n in names)
    for name, e in zip(names, envs):
        if len(e.spec.obs_shape) != 1:
            raise ValueError(
                f"mixture members need vector obs; {name!r} has shape {e.spec.obs_shape}")
    n = len(envs)
    widths = tuple(e.spec.obs_shape[0] for e in envs)
    obs_max = max(widths)
    masks = DeviceTable([[1.0] * w + [0.0] * (obs_max - w) for w in widths])
    n_actions = tuple(e.spec.action_dim if e.spec.discrete else action_bins for e in envs)
    levels = DeviceTable(np.linspace(-1.0, 1.0, action_bins, dtype=np.float32))
    type_ids = DeviceTable(range(n), torch.int64)
    init_w = DeviceTable(init_weights)

    def pad(i: int, obs: torch.Tensor) -> torch.Tensor:
        # Zero pad, then the mask's multiply: a padded lane is 0.0 by
        # construction, whatever the member put there.
        if widths[i] < obs_max:
            obs = F.pad(obs, (0, obs_max - widths[i]))
        return obs * masks.on(obs.device)[i]

    def adapt(i: int, action: torch.Tensor) -> torch.Tensor:
        a = action.to(torch.int64)
        if envs[i].spec.discrete:
            return a % n_actions[i]
        # A continuous member takes the level in its normalized convention
        # (pendulum scales [−1, 1] onto its torque range).
        u = levels.on(a.device)[a % action_bins]
        return u[:, None].expand(-1, envs[i].spec.action_dim)

    def by_type(is_type: torch.Tensor, outs: list[torch.Tensor]) -> torch.Tensor:
        """outs[type_id] per instance; `is_type` [E, n] bool."""
        out = outs[0]
        for i in range(1, n):
            c = is_type[:, i]
            out = torch.where(c.reshape(c.shape + (1,) * (out.dim() - 1)), outs[i], out)
        return out

    def select(c: torch.Tensor) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        return lambda a, b: torch.where(c.reshape(c.shape + (1,) * (a.dim() - 1)), a, b)

    def fresh(num_envs: int, generator: torch.Generator, type_id: torch.Tensor,
              weights: torch.Tensor) -> tuple[MixtureState, torch.Tensor]:
        states, obss = [], []
        for i, e in enumerate(envs):
            s, o = e.reset(num_envs, generator)
            states.append(s)
            obss.append(pad(i, o))
        obs = by_type(type_id[:, None] == type_ids.on(type_id.device), obss)
        stage = torch.zeros(num_envs, dtype=torch.int32, device=type_id.device)
        return MixtureState(type_id, tuple(states), weights, stage), obs

    def reset(num_envs: int, generator: torch.Generator) -> tuple[MixtureState, torch.Tensor]:
        # The weights are a view of the constant table: `init_rollout`
        # gives the trainer's copy storage of its own.
        weights = init_w.on(generator.device).expand(num_envs, -1)
        u = torch.rand(num_envs, generator=generator, device=generator.device)
        return fresh(num_envs, generator, _draw_types(weights, u), weights)

    def reset_typed(num_envs: int, generator: torch.Generator, type_id):
        # A fleet pinned to one type (an int or a one-element int64 tensor,
        # read on the device): one-hot weights keep the pin across episode
        # ends in the redraw mode too.
        tid = torch.as_tensor(type_id, dtype=torch.int64, device=generator.device)
        tid = tid.reshape(1).expand(num_envs).clone()
        weights = (tid[:, None] == type_ids.on(tid.device)).to(torch.float32)
        return fresh(num_envs, generator, tid, weights)

    def step(state: MixtureState, action: torch.Tensor, generator: torch.Generator) -> StepOutput:
        is_type = state.type_id[:, None] == type_ids.on(state.type_id.device)
        new_members = []
        outs: dict[str, list[torch.Tensor]] = {k: [] for k in
                                               ("obs", "reward", "done", "term", "final")}
        for i, e in enumerate(envs):
            out = e.step(state.members[i], adapt(i, action), generator)
            new_members.append(tree_map(select(is_type[:, i]), out.state, state.members[i]))
            outs["obs"].append(pad(i, out.obs))
            outs["reward"].append(out.reward.to(torch.float32))
            outs["done"].append(out.done)
            outs["term"].append(out.info["terminated"])
            outs["final"].append(pad(i, out.info["final_obs"]))
        obs, reward, done, terminated, final_obs = (by_type(is_type, v) for v in outs.values())
        info = {"terminated": terminated, "final_obs": final_obs}
        if not redraw_types:
            info["type_id"] = state.type_id
            return StepOutput(state._replace(members=tuple(new_members)), obs, reward, done, info)

        # Curriculum mode: an episode end redraws the type from the state's
        # weights; only a changed type swaps in a fresh reset of the new
        # member, a same-type draw keeps the member's own auto-reset.
        u = torch.rand(state.type_id.shape, generator=generator, device=state.type_id.device)
        new_type = torch.where(done > 0, _draw_types(state.weights, u), state.type_id)
        changed = (done > 0) & (new_type != state.type_id)
        is_new = new_type[:, None] == type_ids.on(new_type.device)
        reset_obs = []
        for i, e in enumerate(envs):
            s, o = e.reset(new_type.shape[0], generator)
            new_members[i] = tree_map(select(changed & is_new[:, i]), s, new_members[i])
            reset_obs.append(pad(i, o))
        obs = torch.where(changed[:, None], by_type(is_new, reset_obs), obs)
        info["type_id"] = new_type
        out_state = MixtureState(new_type, tuple(new_members), state.weights, state.stage)
        return StepOutput(out_state, obs, reward, done, info)

    spec = EnvSpec(
        obs_shape=(obs_max,),
        action_dim=max(n_actions),
        discrete=True,
        can_truncate=any(e.spec.can_truncate for e in envs),
        episode_horizon=max(e.spec.episode_horizon for e in envs),
    )
    return MixtureEnv(
        spec=spec, reset=reset, step=step,
        member_names=names,
        member_specs=tuple(e.spec for e in envs),
        obs_masks=masks.host,
        init_weights=init_weights,
        reset_typed=reset_typed,
        redraw_types=redraw_types,
    )


def set_fleet_weights(env_state: MixtureState, weights, stage: int) -> None:
    """Install curriculum weights (one per member type, broadcast over the
    fleet) and the stage into a fleet state, in place: a captured train
    step reads the addresses it saw, so the next replay sees them. Host
    side, between iterations (it copies `weights` to the device)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    if w.shape != env_state.weights.shape[-1:]:
        raise ValueError(
            f"{tuple(w.shape)} weights for a fleet of {env_state.weights.shape[-1]} types")
    env_state.weights.copy_(w.to(env_state.weights.device).expand_as(env_state.weights))
    env_state.stage.fill_(int(stage))


def fleet_stage(env_state: MixtureState) -> int:
    """The curriculum stage the fleet state carries (read from the device)."""
    return int(env_state.stage.reshape(-1)[0])


def type_shares(env_state: MixtureState, n_types: int) -> list[float]:
    """The fleet's share of each type (read from the device)."""
    counts = torch.bincount(env_state.type_id, minlength=n_types)
    return (counts.double() / env_state.type_id.numel()).tolist()


# ---------------------------------------------------------------------------
# Curriculum schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Curriculum:
    """Stage s advances to s+1 when eval progress crosses `thresholds[s]`;
    entering stage s+1 installs `stage_weights[s]` (stage 0 runs the
    mixture's own weights)."""

    thresholds: tuple[float, ...]
    stage_weights: tuple[tuple[float, ...], ...]

    def __post_init__(self):
        if len(self.thresholds) != len(self.stage_weights):
            raise ValueError("curriculum needs one weight vector per threshold")
        if any(b <= a for a, b in zip(self.thresholds, self.thresholds[1:])):
            raise ValueError(
                f"curriculum thresholds must be strictly increasing, got {self.thresholds}")
        for w in self.stage_weights:
            if not any(x > 0 for x in w):
                raise ValueError("curriculum stage weights all zero")

    @property
    def n_stages(self) -> int:
        return len(self.thresholds) + 1


def parse_curriculum(spec: str, member_names: tuple[str, ...]) -> Curriculum:
    """`--curriculum` grammar: `"THR:w0,w1,..;THR:w0,w1,.."`, one
    `threshold:weights` stage per semicolon-separated entry, weights in
    member order."""
    thresholds: list[float] = []
    weights: list[tuple[float, ...]] = []
    for entry in (e.strip() for e in spec.split(";")):
        if not entry:
            continue
        thr, sep, ws = entry.partition(":")
        if not sep:
            raise ValueError(f"curriculum stage {entry!r} is not 'THRESHOLD:w0,w1,..'")
        try:
            thresholds.append(float(thr))
            w = tuple(float(x) for x in ws.split(","))
        except ValueError:
            raise ValueError(f"bad curriculum stage {entry!r}")
        if len(w) != len(member_names):
            raise ValueError(
                f"curriculum stage {entry!r} has {len(w)} weights; the mixture has "
                f"{len(member_names)} members {member_names}")
        weights.append(w)
    if not thresholds:
        raise ValueError(f"curriculum spec {spec!r} names no stages")
    return Curriculum(tuple(thresholds), tuple(weights))


class CurriculumController:
    """Host-side schedule state: feed it each eval's progress metric and
    install what it returns."""

    def __init__(self, curriculum: Curriculum):
        self.curriculum = curriculum
        self.stage = 0

    def sync(self, stage: int) -> None:
        """Re-align from a fleet state's stage (clamped to the schedule)."""
        self.stage = max(self.stage, min(int(stage), self.curriculum.n_stages - 1))

    def update(self, progress: float) -> Optional[tuple[int, tuple[float, ...]]]:
        """Advance through every threshold `progress` has crossed; returns
        (new stage, weights to install) when the stage moved, else None.
        Stages only move forward."""
        advanced = None
        cur = self.curriculum
        while self.stage < len(cur.thresholds) and progress >= cur.thresholds[self.stage]:
            self.stage += 1
            advanced = (self.stage, cur.stage_weights[self.stage - 1])
        return advanced


# ---------------------------------------------------------------------------
# Per-type eval matrix
# ---------------------------------------------------------------------------

def make_typed_eval(env: MixtureEnv):
    """Greedy per-type eval: `eval_fn(state, generator, type_id,
    num_envs=16, num_steps=...)` evaluates the current policy
    (`state.net`, as `common.make_mode_eval`) on a fleet pinned to
    `type_id`, an int or an int64 tensor on the device. The type enters
    only through the eager reset, so on the card one set of captured eval
    blocks serves every member type (`common.make_net_eval`), as JAX
    traces one program for a traced type id. `eval_fn.warm(state,
    generator)` captures those blocks ahead of the first call."""
    from actor_critic_tpu_torch.algos.common import default_eval_steps, make_net_eval

    default_steps = default_eval_steps(env)
    run = make_net_eval(env)

    def eval_fn(state, generator: torch.Generator, type_id, num_envs: int = 16,
                num_steps: int = default_steps) -> torch.Tensor:
        return run(state.net, generator, num_envs, num_steps,
                   reset_fn=lambda k, g: env.reset_typed(k, g, type_id))

    def warm(state, generator: torch.Generator, type_id=0, num_envs: int = 16,
             num_steps: int = default_steps) -> None:
        run.warm(state.net, generator, num_envs, num_steps,
                 reset_fn=lambda k, g: env.reset_typed(k, g, type_id))

    eval_fn.evals = run.evals
    eval_fn.warm = warm
    return eval_fn


def eval_matrix_row(name: str, ret: float) -> dict[str, float]:
    """Flat fields for one member's eval result: its return, rounded, and
    whether it reached the member's solve bar."""
    bar = SOLVE_BARS.get(name)
    row = {f"{name}_return": round(float(ret), 3)}
    if bar is not None:
        row[f"{name}_solved"] = float(ret >= bar)
    return row


# -- the warm-up registry (utils/compile_cache.py) ---------------------------
from actor_critic_tpu_torch.utils import compile_cache as _compile_cache  # noqa: E402


@_compile_cache.register_warmup("mixture.make_typed_eval")
def _typed_eval_planner(ctx):
    """The per-type eval's block graphs, for fused mixture runs with eval on
    (one set serves every member type; the train step and the greedy eval
    are the per-algo `<algo>.make_train_step` / `make_eval_fn` entries)."""
    if not ctx.fused or ctx.eval_every <= 0 or not isinstance(ctx.env, MixtureEnv):
        return None
    if ctx.algo not in ("a2c", "ppo", "impala", "a3c"):
        return None
    return _compile_cache.warmup_of(ctx)
