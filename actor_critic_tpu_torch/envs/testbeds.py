"""Analytic micro-environments with known optima (counterpart of
`actor_critic_tpu/envs/testbeds.py`); only `make_two_state_mdp`, which the
IMPALA learning checks use, is ported."""

from __future__ import annotations

from typing import NamedTuple

import torch

from actor_critic_tpu_torch.envs.env import EnvSpec, TorchEnv, auto_reset


class TwoStateState(NamedTuple):
    s: torch.Tensor  # int32, 0 or 1
    t: torch.Tensor  # int32 steps this episode


def make_two_state_mdp(horizon: int = 8) -> TorchEnv:
    """Deterministic 2-state MDP, truncated at `horizon` steps.

    Transitions: next state == action (from either state). Rewards:
    r(s, a) = 1.0 if a == 1 else 0.0. Optimal policy: always a=1, with
    V* = 1/(1−γ) under the truncation bootstrap. Obs is one-hot of the
    state."""

    def obs_of(s: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.one_hot(s.to(torch.int64), 2).to(torch.float32)

    def reset(num_envs: int, generator: torch.Generator):
        u = torch.rand(num_envs, generator=generator, device=generator.device)
        s = (u < 0.5).to(torch.int32)
        return TwoStateState(s=s, t=torch.zeros_like(s)), obs_of(s)

    def raw_step(state: TwoStateState, action: torch.Tensor, generator: torch.Generator):
        del generator  # deterministic dynamics
        action = action.to(torch.int32)
        t = state.t + 1
        terminated = torch.zeros(action.shape, device=action.device)
        truncated = (t >= horizon).to(torch.float32)
        return TwoStateState(s=action, t=t), obs_of(action), action.to(torch.float32), terminated, truncated

    spec = EnvSpec(obs_shape=(2,), action_dim=2, discrete=True, episode_horizon=horizon)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
