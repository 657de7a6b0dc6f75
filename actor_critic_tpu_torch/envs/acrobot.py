"""Batched Acrobot-v1 (counterpart of `actor_critic_tpu/envs/acrobot.py`).

Gymnasium's "book" dynamics over `[E]` float32 state tensors: one RK4 step
of `_dsdt` over dt = 0.2, both angles wrapped to [−π, π], the velocities
clipped at 4π and 9π. Actions 0/1/2 apply −1/0/+1 torque (times the
scenario's torque scale); the reward is −1 a step and 0 on the
terminating one; an episode terminates when −cos θ1 − cos(θ1 + θ2) > 1 and
truncates at 500 steps. The centres of mass sit at half the link lengths
and both moments of inertia are 1.0, as in the JAX env.

Every operation is the JAX env's, in its order, so one step from the same
state gives the same float32 numbers up to the rounding of sin and cos
(the double pendulum is chaotic: trajectories are compared a step at a
time). Scenario fleet (`envs/env.py`): gravity, both masses, both lengths
and the torque scale, drawn per instance at every reset.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from actor_critic_tpu_torch.envs.env import (
    EnvSpec,
    ScenarioBounds,
    TorchEnv,
    auto_reset,
    draw_scenario,
    scenario_ranges,
)
from actor_critic_tpu_torch.envs.pendulum import angle_normalize

GRAVITY = 9.8
LINK_MASS_1 = 1.0
LINK_MASS_2 = 1.0
LINK_LENGTH_1 = 1.0
LINK_LENGTH_2 = 1.0
LINK_MOI = 1.0
TORQUE = 1.0  # |torque| of actions 0 and 2; action 1 is no torque
DT = 0.2
MAX_VEL_1 = 4.0 * math.pi
MAX_VEL_2 = 9.0 * math.pi
MAX_STEPS = 500
# RK4's float32 step coefficients, formed as the JAX env forms them.
_DT = float(np.float32(DT))
_DT2 = float(np.float32(DT / 2.0))
_DT6 = float(np.float32(DT) / np.float32(6.0))

# The columns of `AcrobotState.scenario`, in order.
SCENARIO_DEFAULTS = {
    "gravity": GRAVITY,
    "link_mass_1": LINK_MASS_1,
    "link_mass_2": LINK_MASS_2,
    "link_length_1": LINK_LENGTH_1,
    "link_length_2": LINK_LENGTH_2,
    "torque": TORQUE,
}


class AcrobotState(NamedTuple):
    theta1: torch.Tensor
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor
    t: torch.Tensor  # int32 steps this episode
    scenario: torch.Tensor  # [E, 6] float32, SCENARIO_DEFAULTS' parameters


def _obs(s: AcrobotState) -> torch.Tensor:
    return torch.stack([
        torch.cos(s.theta1), torch.sin(s.theta1),
        torch.cos(s.theta2), torch.sin(s.theta2),
        s.dtheta1, s.dtheta2,
    ], dim=-1)


def _dsdt(y: torch.Tensor, torque: torch.Tensor, physics: tuple) -> torch.Tensor:
    """Time derivative of y = [θ1, θ2, θ̇1, θ̇2] ([E, 4]) under the book
    dynamics; `physics` = (g, m1, m2, l1, lc1, lc2)."""
    g, m1, m2, l1, lc1, lc2 = physics
    i1 = i2 = LINK_MOI
    theta1, theta2, dtheta1, dtheta2 = y.unbind(-1)
    cos2, sin2 = torch.cos(theta2), torch.sin(theta2)
    d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2.0 * l1 * lc2 * cos2) + i1 + i2
    d2 = m2 * (lc2**2 + l1 * lc2 * cos2) + i2
    phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (
        -m2 * l1 * lc2 * dtheta2**2 * sin2
        - 2.0 * m2 * l1 * lc2 * dtheta2 * dtheta1 * sin2
        + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2.0)
        + phi2
    )
    ddtheta2 = (
        torque + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1**2 * sin2 - phi2
    ) / (m2 * lc2**2 + i2 - d2**2 / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], dim=-1)


def _rk4_step(y: torch.Tensor, torque: torch.Tensor, physics: tuple) -> torch.Tensor:
    """One classical RK4 step over [0, DT] (gymnasium's `rk4` on a
    two-point time grid)."""
    k1 = _dsdt(y, torque, physics)
    k2 = _dsdt(y + _DT2 * k1, torque, physics)
    k3 = _dsdt(y + _DT2 * k2, torque, physics)
    k4 = _dsdt(y + _DT * k3, torque, physics)
    return y + _DT6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def raw_step(state: AcrobotState, action: torch.Tensor, generator: torch.Generator):
    del generator  # deterministic dynamics
    g, m1, m2, l1, l2, torque_scale = state.scenario.unbind(-1)
    physics = (g, m1, m2, l1, 0.5 * l1, 0.5 * l2)
    # Torques [−1, 0, +1] by action, scaled per instance.
    torque = (action.to(torch.float32) - 1.0) * torque_scale
    y = torch.stack([state.theta1, state.theta2, state.dtheta1, state.dtheta2], dim=-1)
    ns = _rk4_step(y, torque, physics)
    theta1 = angle_normalize(ns[:, 0])
    theta2 = angle_normalize(ns[:, 1])
    dtheta1 = torch.clamp(ns[:, 2], -MAX_VEL_1, MAX_VEL_1)
    dtheta2 = torch.clamp(ns[:, 3], -MAX_VEL_2, MAX_VEL_2)
    t = state.t + 1
    nstate = AcrobotState(theta1, theta2, dtheta1, dtheta2, t, state.scenario)
    terminated = (-torch.cos(theta1) - torch.cos(theta2 + theta1) > 1.0).to(torch.float32)
    truncated = (t >= MAX_STEPS).to(torch.float32) * (1.0 - terminated)
    # −1 a step until the terminating step, which earns 0.
    reward = -(1.0 - terminated)
    return nstate, _obs(nstate), reward, terminated, truncated


def make_acrobot(
    randomize: float = 0.0,
    gravity=None,
    link_mass_1=None,
    link_mass_2=None,
    link_length_1=None,
    link_length_2=None,
    torque=None,
) -> TorchEnv:
    """Acrobot-v1, optionally as a domain-randomized scenario fleet
    (`randomize`, or a range per parameter, as `make_cartpole`)."""
    bounds = ScenarioBounds.of(scenario_ranges(
        SCENARIO_DEFAULTS, randomize,
        {"gravity": gravity, "link_mass_1": link_mass_1, "link_mass_2": link_mass_2,
         "link_length_1": link_length_1, "link_length_2": link_length_2, "torque": torque},
    ))

    def reset(num_envs: int, generator: torch.Generator) -> tuple[AcrobotState, torch.Tensor]:
        vals = torch.rand((num_envs, 4), generator=generator, device=generator.device) * 0.2 - 0.1
        state = AcrobotState(
            theta1=vals[:, 0], theta2=vals[:, 1], dtheta1=vals[:, 2], dtheta2=vals[:, 3],
            t=torch.zeros(num_envs, dtype=torch.int32, device=vals.device),
            scenario=draw_scenario(generator, num_envs, bounds),
        )
        return state, _obs(state)

    spec = EnvSpec(obs_shape=(6,), action_dim=3, discrete=True, episode_horizon=MAX_STEPS)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
