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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


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

        out_state = type(nstate)(*(select(r, n) for r, n in zip(rstate, nstate)))
        return StepOutput(
            state=out_state,
            obs=select(robs, obs),
            reward=reward,
            done=done,
            info={"terminated": terminated, "final_obs": obs},
        )

    return step
