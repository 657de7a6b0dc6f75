"""Batched CartPole-v1 (counterpart of `actor_critic_tpu/envs/cartpole.py`).

Gymnasium's dynamics (Euler integrator), thresholds, reset distribution
U(−0.05, 0.05), reward (+1 every step, the terminating one included) and
500-step time limit, over `[E]` float32 state tensors.

Scenario fleet: `make_cartpole(randomize=0.3)` (or per-parameter ranges,
`masspole=(0.05, 0.5)`, `--env-set masspole=0.05,0.5`) draws gravity, the
two masses, the pole's half-length and the force per instance at every
reset, into `CartPoleState.scenario` (`envs/env.py`). As in the JAX env,
`masscart + masspole` and `masspole * length` are formed in float32 from
the scenario at every step. The default env draws nothing: its scenario
is gymnasium's constants, exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from actor_critic_tpu_torch.envs.env import (
    EnvSpec,
    ScenarioBounds,
    TorchEnv,
    auto_reset,
    draw_scenario,
    scenario_ranges,
)

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
LENGTH = 0.5  # half the pole's length
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4
MAX_STEPS = 500

# The columns of `CartPoleState.scenario`, in order.
SCENARIO_DEFAULTS = {
    "gravity": GRAVITY,
    "masscart": MASSCART,
    "masspole": MASSPOLE,
    "length": LENGTH,
    "force_mag": FORCE_MAG,
}


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # int32 step count for the time-limit truncation
    scenario: torch.Tensor  # [E, 5] float32, SCENARIO_DEFAULTS' parameters


def _obs(s: CartPoleState) -> torch.Tensor:
    return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)


def raw_step(state: CartPoleState, action: torch.Tensor, generator: torch.Generator):
    del generator  # deterministic dynamics
    gravity, masscart, masspole, length, force_mag = state.scenario.unbind(-1)
    total_mass = masscart + masspole
    polemass_length = masspole * length
    force = torch.where(action == 1, force_mag, -force_mag)
    costheta = torch.cos(state.theta)
    sintheta = torch.sin(state.theta)
    temp = (force + polemass_length * state.theta_dot**2 * sintheta) / total_mass
    thetaacc = (gravity * sintheta - costheta * temp) / (
        length * (4.0 / 3.0 - masspole * costheta**2 / total_mass)
    )
    xacc = temp - polemass_length * thetaacc * costheta / total_mass
    x = state.x + TAU * state.x_dot
    x_dot = state.x_dot + TAU * xacc
    theta = state.theta + TAU * state.theta_dot
    theta_dot = state.theta_dot + TAU * thetaacc
    t = state.t + 1

    nstate = CartPoleState(x, x_dot, theta, theta_dot, t, state.scenario)
    terminated = ((x.abs() > X_THRESHOLD) | (theta.abs() > THETA_THRESHOLD)).to(torch.float32)
    truncated = (t >= MAX_STEPS).to(torch.float32) * (1.0 - terminated)
    reward = torch.ones_like(x)
    return nstate, _obs(nstate), reward, terminated, truncated


def make_cartpole(
    randomize: float = 0.0,
    gravity=None,
    masscart=None,
    masspole=None,
    length=None,
    force_mag=None,
) -> TorchEnv:
    """CartPole-v1, optionally as a domain-randomized scenario fleet:
    `randomize=r` draws each physics parameter per instance and episode in
    [default·(1−r), default·(1+r)]; a parameter's keyword pins its range (a
    (lo, hi) pair, a "lo,hi" string or a number). The defaults are
    gymnasium's physics."""
    bounds = ScenarioBounds.of(scenario_ranges(
        SCENARIO_DEFAULTS, randomize,
        {"gravity": gravity, "masscart": masscart, "masspole": masspole,
         "length": length, "force_mag": force_mag},
    ))

    def reset(num_envs: int, generator: torch.Generator) -> tuple[CartPoleState, torch.Tensor]:
        vals = torch.rand((num_envs, 4), generator=generator, device=generator.device) * 0.1 - 0.05
        state = CartPoleState(
            x=vals[:, 0], x_dot=vals[:, 1], theta=vals[:, 2], theta_dot=vals[:, 3],
            t=torch.zeros(num_envs, dtype=torch.int32, device=vals.device),
            scenario=draw_scenario(generator, num_envs, bounds),
        )
        return state, _obs(state)

    spec = EnvSpec(obs_shape=(4,), action_dim=2, discrete=True, episode_horizon=MAX_STEPS)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
