"""Batched Pendulum-v1 (counterpart of `actor_critic_tpu/envs/pendulum.py`).

Gymnasium's dynamics over `[E]` float32 state tensors: the reward comes
from the PRE-step state and the clipped torque, the speed is clipped at
8, episodes never terminate and truncate at 200 steps. Resets draw θ in
U(−π, π) and θ̇ in U(−1, 1).

Actions: by default (`scale_actions=True`) the policy's normalized action
in [−1, 1] is clipped and scaled onto ±max_torque, the JAX env's
convention; `scale_actions=False` takes raw torques, clipped to
±max_torque. The action has shape [E, 1].

Scenario fleet (`envs/env.py`): gravity, mass, length and max_torque,
drawn per instance at every reset into `PendulumState.scenario`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from actor_critic_tpu_torch.envs.env import (
    DeviceTable,
    EnvSpec,
    ScenarioBounds,
    TorchEnv,
    auto_reset,
    draw_scenario,
    scenario_ranges,
)

GRAVITY = 10.0
MASS = 1.0
LENGTH = 1.0
DT = 0.05
MAX_SPEED = 8.0
MAX_TORQUE = 2.0
MAX_STEPS = 200

# The columns of `PendulumState.scenario`, in order.
SCENARIO_DEFAULTS = {
    "gravity": GRAVITY,
    "mass": MASS,
    "length": LENGTH,
    "max_torque": MAX_TORQUE,
}


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # int32 steps this episode
    scenario: torch.Tensor  # [E, 4] float32, SCENARIO_DEFAULTS' parameters


def _obs(s: PendulumState) -> torch.Tensor:
    return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """((x + π) mod 2π) − π with a floor mod, as JAX's `%`: the result of
    the mod takes the divisor's sign (`torch.fmod` would take x's)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def make_pendulum(
    scale_actions: bool = True,
    randomize: float = 0.0,
    gravity=None,
    mass=None,
    length=None,
    max_torque=None,
) -> TorchEnv:
    bounds = ScenarioBounds.of(scenario_ranges(
        SCENARIO_DEFAULTS, randomize,
        {"gravity": gravity, "mass": mass, "length": length, "max_torque": max_torque},
    ))
    # XLA divides 3 by m·l² (torch's `3.0 / x` is a reciprocal times 3) and
    # contracts the θ̇ update into two fused multiply-adds; these constants
    # are tensors so that the port does the same ops.
    three, dt = DeviceTable(3.0), DeviceTable(DT)

    def reset(num_envs: int, generator: torch.Generator) -> tuple[PendulumState, torch.Tensor]:
        vals = torch.rand((num_envs, 2), generator=generator, device=generator.device) * 2.0 - 1.0
        state = PendulumState(
            theta=vals[:, 0] * math.pi,
            theta_dot=vals[:, 1],
            t=torch.zeros(num_envs, dtype=torch.int32, device=vals.device),
            scenario=draw_scenario(generator, num_envs, bounds),
        )
        return state, _obs(state)

    def raw_step(state: PendulumState, action: torch.Tensor, generator: torch.Generator):
        del generator  # deterministic dynamics
        g, m, l, max_torque = state.scenario.unbind(-1)
        a = action.reshape(state.theta.shape)
        if scale_actions:
            u = torch.clamp(a, -1.0, 1.0) * max_torque
        else:
            u = torch.minimum(torch.maximum(a, -max_torque), max_torque)
        th, thdot = state.theta, state.theta_dot
        # The reward comes from the pre-step state and the clipped torque.
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        torque_term = three.on(th.device) / (m * l**2) * u
        accel = torch.addcmul(torque_term, 3.0 * g / (2.0 * l), torch.sin(th))
        newthdot = torch.addcmul(thdot, accel, dt.on(th.device))
        newthdot = torch.clamp(newthdot, -MAX_SPEED, MAX_SPEED)
        newth = th + newthdot * DT
        t = state.t + 1
        nstate = PendulumState(newth, newthdot, t, state.scenario)
        terminated = torch.zeros_like(th)  # never terminates
        truncated = (t >= MAX_STEPS).to(torch.float32)
        return nstate, _obs(nstate), -costs, terminated, truncated

    spec = EnvSpec(obs_shape=(3,), action_dim=1, discrete=False, episode_horizon=MAX_STEPS)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
