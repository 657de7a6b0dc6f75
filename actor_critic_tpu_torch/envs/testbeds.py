"""Analytic micro-environments with known optima (counterpart of
`actor_critic_tpu/envs/testbeds.py`): `make_bandit`, `make_two_state_mdp`
and `make_point_mass`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from actor_critic_tpu_torch.envs.env import DeviceTable, EnvSpec, TorchEnv, auto_reset


class BanditState(NamedTuple):
    t: torch.Tensor  # int32, always 0: every episode is one step


def make_bandit(payouts=(0.2, 0.9, 0.4)) -> TorchEnv:
    """One-step episodes: the obs is the constant [1.0] and the reward
    payouts[action]. The optimal policy picks argmax(payouts), whose value
    is max(payouts)."""
    table = DeviceTable(payouts)

    def reset(num_envs: int, generator: torch.Generator):
        device = generator.device
        return (BanditState(t=torch.zeros(num_envs, dtype=torch.int32, device=device)),
                torch.ones((num_envs, 1), device=device))

    def raw_step(state: BanditState, action: torch.Tensor, generator: torch.Generator):
        del generator  # deterministic payouts
        reward = table.on(action.device)[action.to(torch.int64)]
        terminated = torch.ones_like(reward)
        return state, torch.ones_like(reward)[:, None], reward, terminated, torch.zeros_like(reward)

    spec = EnvSpec(obs_shape=(1,), action_dim=len(payouts), discrete=True,
                   can_truncate=False, episode_horizon=1)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))


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


class PointMassState(NamedTuple):
    pos: torch.Tensor  # float32 position
    t: torch.Tensor    # int32 steps this episode


def make_point_mass(horizon: int = 16, pos_clip: float = 2.0) -> TorchEnv:
    """1-d continuous control: obs = [pos]; pos' = clip(pos + clip(a, ±1),
    ±pos_clip); reward = −pos'²; fixed-horizon episodes (truncation only).

    The optimal action is a* = −pos. Positions start uniform in
    [−0.5, 0.5], so a* is always reachable."""

    def reset(num_envs: int, generator: torch.Generator):
        pos = torch.rand(num_envs, generator=generator, device=generator.device) - 0.5
        return PointMassState(pos=pos, t=torch.zeros(num_envs, dtype=torch.int32,
                                                     device=pos.device)), pos[:, None]

    def raw_step(state: PointMassState, action: torch.Tensor, generator: torch.Generator):
        del generator  # deterministic dynamics
        a = torch.clamp(action.reshape(state.pos.shape), -1.0, 1.0)
        pos = torch.clamp(state.pos + a, -pos_clip, pos_clip)
        t = state.t + 1
        terminated = torch.zeros_like(pos)
        truncated = (t >= horizon).to(torch.float32)
        return PointMassState(pos=pos, t=t), pos[:, None], -(pos**2), terminated, truncated

    spec = EnvSpec(obs_shape=(1,), action_dim=1, discrete=False, episode_horizon=horizon)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
