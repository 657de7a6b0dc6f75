"""Batched CartPole-v1 (counterpart of `actor_critic_tpu/envs/cartpole.py`).

Gymnasium's dynamics (Euler integrator), thresholds, reset distribution
U(−0.05, 0.05), reward (+1 every step, the terminating one included) and
500-step time limit, over `[E]` float32 state tensors. Only the default
physics is ported; the scenario fleet comes later.

The JAX env carries its physics as float32 scalars and forms
`masscart + masspole` and `masspole * length` in float32; the constants
below are those float32 results, not the float64 sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from actor_critic_tpu_torch.envs.env import EnvSpec, TorchEnv, auto_reset

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
LENGTH = 0.5  # half the pole's length
FORCE_MAG = 10.0
TOTAL_MASS = float(np.float32(MASSCART) + np.float32(MASSPOLE))
POLEMASS_LENGTH = float(np.float32(MASSPOLE) * np.float32(LENGTH))
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4
MAX_STEPS = 500


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # int32 step count for the time-limit truncation


def _obs(s: CartPoleState) -> torch.Tensor:
    return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)


def reset(num_envs: int, generator: torch.Generator) -> tuple[CartPoleState, torch.Tensor]:
    vals = torch.rand((num_envs, 4), generator=generator, device=generator.device) * 0.1 - 0.05
    state = CartPoleState(
        x=vals[:, 0], x_dot=vals[:, 1], theta=vals[:, 2], theta_dot=vals[:, 3],
        t=torch.zeros(num_envs, dtype=torch.int32, device=vals.device),
    )
    return state, _obs(state)


def raw_step(state: CartPoleState, action: torch.Tensor):
    force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG).to(torch.float32)
    costheta = torch.cos(state.theta)
    sintheta = torch.sin(state.theta)
    temp = (force + POLEMASS_LENGTH * state.theta_dot**2 * sintheta) / TOTAL_MASS
    thetaacc = (GRAVITY * sintheta - costheta * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * costheta**2 / TOTAL_MASS)
    )
    xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS
    x = state.x + TAU * state.x_dot
    x_dot = state.x_dot + TAU * xacc
    theta = state.theta + TAU * state.theta_dot
    theta_dot = state.theta_dot + TAU * thetaacc
    t = state.t + 1

    nstate = CartPoleState(x, x_dot, theta, theta_dot, t)
    terminated = ((x.abs() > X_THRESHOLD) | (theta.abs() > THETA_THRESHOLD)).to(torch.float32)
    truncated = (t >= MAX_STEPS).to(torch.float32) * (1.0 - terminated)
    reward = torch.ones_like(x)
    return nstate, _obs(nstate), reward, terminated, truncated


def make_cartpole() -> TorchEnv:
    """CartPole-v1 with gymnasium's default physics."""
    spec = EnvSpec(obs_shape=(4,), action_dim=2, discrete=True, episode_horizon=MAX_STEPS)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
