"""Batched-tensor environment protocol (counterpart of `actor_critic_tpu/envs/jax_env.py`).

The JAX package vmaps a per-instance pure env over the batch; here the
env's state is a NamedTuple of `[E]` tensors and `reset` / `step` act on
the whole batch at once. The contract is the JAX one:

- `reset(num_envs, generator) -> (state, obs)`, the draws taken from
  `generator` (on the device the state should live on);
- `step(state, action, generator) -> StepOutput(state, obs, reward, done,
  info)`;
- `done` is 1.0 at a step that ends the episode (termination OR
  truncation); `info["terminated"]` marks true terminations so GAE can
  bootstrap through time-limit truncations;
- `step` auto-resets: where an episode ended, the returned state/obs are
  from a fresh episode, and the pre-reset obs is in `info["final_obs"]`;
- everything is float32 apart from integer step counters and pixel
  observations, which are uint8 `[E, H, W, C]` as in the JAX package.

A state may nest: a NamedTuple whose fields are tensors, NamedTuples or
tuples of them (a mixture fleet's member states, `envs/mixture.py`);
`auto_reset` and the trainers treat it through `tree.py`.

Scenario fleet (JAX `jax_env.py:98-180`): an env whose physics can be
randomized per instance carries them in its state as one `[E, P]` float32
tensor, `scenario`, its columns the env's `SCENARIO_DEFAULTS` in order,
drawn at every reset by `draw_scenario` from the ranges `scenario_ranges`
resolves. One tensor rather than JAX's NamedTuple of P scalars: the draw,
auto-reset's select and the rollout's write-back each take one launch for
all P parameters, and `scenario.unbind(-1)` names them without a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from actor_critic_tpu_torch.tree import tree_map


class StepOutput(NamedTuple):
    state: Any  # env state (post auto-reset)
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor  # 1.0 where the episode ended this step (term or trunc)
    info: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static metadata a trainer needs to build networks."""

    obs_shape: tuple[int, ...]
    action_dim: int  # num discrete actions, or continuous action dims
    discrete: bool
    # False ⇒ episodes only terminate, so the truncation bootstrap is skipped.
    can_truncate: bool = True
    # Upper bound on episode length (the time limit), 0 = unknown.
    episode_horizon: int = 0

    @property
    def pixel_obs(self) -> bool:
        """Image-shaped observations ([H, W, C]): the rule by which a
        trainer picks the Nature CNN over the MLP torso."""
        return len(self.obs_shape) == 3


@dataclasses.dataclass(frozen=True)
class TorchEnv:
    """A batched environment: a spec plus reset/step functions."""

    spec: EnvSpec
    reset: Callable[[int, torch.Generator], tuple[Any, torch.Tensor]]
    step: Callable[[Any, torch.Tensor, torch.Generator], StepOutput]


def auto_reset(
    reset_fn: Callable[[int, torch.Generator], tuple[Any, torch.Tensor]],
    raw_step: Callable[
        [Any, torch.Tensor, torch.Generator],
        tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    ],
) -> Callable[[Any, torch.Tensor, torch.Generator], StepOutput]:
    """Wrap a raw batched step (no reset logic) into the auto-resetting
    protocol. `raw_step(state, action, generator) -> (state, obs, reward,
    terminated, truncated)`; an env whose dynamics draw random numbers
    (Pong re-serves the ball after every point) takes them from
    `generator`, the others ignore it. A fresh reset is drawn for the whole
    batch and selected where `done` with `torch.where`: branchless, no host
    sync."""

    def step(state, action: torch.Tensor, generator: torch.Generator) -> StepOutput:
        nstate, obs, reward, terminated, truncated = raw_step(state, action, generator)
        done = torch.maximum(terminated, truncated)
        rstate, robs = reset_fn(done.shape[0], generator)
        d = done.to(torch.bool)

        def select(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            return torch.where(d.reshape(d.shape + (1,) * (a.dim() - d.dim())), a, b)

        out_state = tree_map(select, rstate, nstate)
        return StepOutput(
            state=out_state,
            obs=select(robs, obs),
            reward=reward,
            done=done,
            info={"terminated": terminated, "final_obs": obs},
        )

    return step


class DeviceTable:
    """A constant table, copied to each device once, at its first use there.

    A step captured into a CUDA graph may not copy from the host, so the
    constants a step reads (scenario bounds, obs masks, action levels) must
    reach the device before any capture: their first use there is in an
    eager reset or step (`init_state`, the loop's warm-up iterations)."""

    def __init__(self, values: Any, dtype: torch.dtype = torch.float32):
        self.host = torch.as_tensor(np.asarray(values), dtype=dtype)
        self._on: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        table = self._on.get(device)
        if table is None:
            table = self._on[device] = self.host.to(device)
        return table


def scenario_ranges(
    defaults: dict[str, float],
    randomize: float = 0.0,
    overrides: Optional[dict[str, Any]] = None,
) -> dict[str, tuple[float, float]]:
    """Per-parameter (lo, hi) draw ranges, as the JAX `scenario_ranges`.

    `randomize=r` widens every default d to [d·(1−r), d·(1+r)]; `overrides`
    then pins single parameters: a (lo, hi) pair or list, a "lo,hi" string
    (the `--env-set masspole=0.05,0.5` spelling) or a bare number (a fixed
    value). With randomize 0 and no overrides every range is [d, d]."""
    if randomize < 0:
        raise ValueError(f"randomize must be >= 0, got {randomize}")
    out = {}
    for name, d in defaults.items():
        r = abs(d) * randomize
        out[name] = (d - r, d + r)
    for name, val in (overrides or {}).items():
        if name not in defaults:
            raise ValueError(
                f"unknown scenario parameter {name!r}; valid: {sorted(defaults)}"
            )
        if val is None:
            continue
        if isinstance(val, str):
            vals = tuple(float(p) for p in val.split(",") if p.strip())
        elif isinstance(val, (tuple, list)):
            vals = tuple(float(v) for v in val)
        else:
            vals = (float(val),)
        if len(vals) == 1:
            out[name] = (vals[0], vals[0])
        elif len(vals) == 2:
            out[name] = (min(vals), max(vals))
        else:
            raise ValueError(
                f"scenario range for {name!r} must be a number or lo,hi pair, got {val!r}"
            )
    return out


def is_randomized(ranges: dict[str, tuple[float, float]]) -> bool:
    """Whether any parameter's range is non-degenerate (lo < hi)."""
    return any(lo != hi for lo, hi in ranges.values())


class ScenarioBounds(NamedTuple):
    """`ranges` as a draw reads them: the [2, P] float32 table (lo; hi − lo),
    columns in the ranges' order, and whether any width is non-zero."""

    table: DeviceTable
    randomized: bool

    @classmethod
    def of(cls, ranges: dict[str, tuple[float, float]]) -> "ScenarioBounds":
        lo = np.float32([lo for lo, _ in ranges.values()])
        hi = np.float32([hi for _, hi in ranges.values()])
        return cls(DeviceTable(np.stack([lo, hi - lo])), is_randomized(ranges))


def draw_scenario(
    generator: torch.Generator, num_envs: int, bounds: ScenarioBounds
) -> torch.Tensor:
    """[E, P] parameters: one uniform draw per parameter and instance from
    `generator`, lo + u·(hi − lo) in float32 (JAX's `uniform(minval,
    maxval)`). A degenerate range gives its exact constant (u·0 + lo is
    lo). With no range randomized nothing is drawn and the generator does
    not advance: every row is the constants (a view, no copy), and an env
    with its default physics draws only its own state."""
    lo, width = bounds.table.on(generator.device)
    if not bounds.randomized:
        return lo.expand(num_envs, -1)
    u = torch.rand((num_envs, lo.shape[0]), generator=generator, device=generator.device)
    return torch.addcmul(lo, u, width)
