"""The trainers' optimizers, written out by hand to match optax.

`a2c.make_optimizer` in the JAX package builds
`optax.chain(clip_by_global_norm(max_norm), adam(lr or linear_schedule))`,
and `impala.make_optimizer` builds
`optax.chain(clip_by_global_norm(max_norm), rmsprop(lr, decay, eps))`.
This module is those chains, step for step and in float32:

- clip: `t / g_norm * max_norm` only when `g_norm >= max_norm` (optax's
  rule; `torch.nn.utils.clip_grad_norm_` adds 1e-6 and would drift);
- Adam: b1=0.9, b2=0.999, eps=1e-8 outside the square root, bias
  correction `1 - b**count` computed in float32 as optax does;
- the learning-rate schedule is read at the count BEFORE the increment;
- RMSProp as optax's `scale_by_rms` has it: nu starts at 0, no bias
  correction, and eps INSIDE the root, `g · rsqrt(nu + eps)`.
  `torch.optim.RMSprop` puts eps outside (`g / (sqrt(nu) + eps)`); at the
  IMPALA setting eps = 0.1 that is a different optimizer.

Parameters are updated in place under `torch.no_grad()`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Union

import numpy as np
import torch

Schedule = Callable[[int], float]
# optax.adam's defaults, the only values the trainers use.
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    count: int  # optimizer steps taken (optax's int32 count, kept on the host)
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule, evaluated in float32 like optax's."""
    if transition_steps <= 0:
        return lambda count: init_value
    span = np.float32(init_value - end_value)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1.0) - c / np.float32(transition_steps)
        return float(span * frac + np.float32(end_value))

    return schedule


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))


def clip_by_global_norm(
    grads: Mapping[str, torch.Tensor], max_norm: float
) -> dict[str, torch.Tensor]:
    """optax.clip_by_global_norm, without a host sync (the branch is a
    `torch.where` on the device)."""
    g_norm = global_norm(grads)
    keep = g_norm < max_norm
    return {k: torch.where(keep, g, g / g_norm * max_norm) for k, g in grads.items()}


def _zeros_like(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in params.items()}


class ClippedAdam:
    """`chain(clip_by_global_norm(max_norm), adam(lr))`, lr a float or a
    schedule of the step count."""

    def __init__(self, lr: Union[float, Schedule], max_norm: float):
        self.lr = lr if callable(lr) else (lambda count, _lr=lr: _lr)
        self.max_norm = max_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    def step(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
        state: AdamState,
    ) -> None:
        """Apply one update to `params` in place and advance `state`."""
        lr = self.lr(state.count)
        count = state.count + 1
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
        grads = clip_by_global_norm(grads, self.max_norm)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu = (1 - B1) * g + B1 * state.mu[k]
                nu = (1 - B2) * (g * g) + B2 * state.nu[k]
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
                p.add_(update * -lr)
                state.mu[k], state.nu[k] = mu, nu
        state.count = count


@dataclasses.dataclass
class RMSPropState:
    nu: dict[str, torch.Tensor]  # running mean of squared (clipped) grads


class ClippedRMSProp:
    """`chain(clip_by_global_norm(max_norm), rmsprop(lr, decay, eps))` with
    optax's defaults for the rest (initial_scale 0, eps_in_sqrt, no bias
    correction, no momentum, not centered)."""

    def __init__(self, lr: float, max_norm: float, decay: float, eps: float):
        self.lr, self.max_norm, self.decay, self.eps = lr, max_norm, decay, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> RMSPropState:
        return RMSPropState(nu=_zeros_like(params))

    def step(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
        state: RMSPropState,
    ) -> None:
        """Apply one update to `params` in place and advance `state`."""
        grads = clip_by_global_norm(grads, self.max_norm)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                nu = (1 - self.decay) * (g * g) + self.decay * state.nu[k]
                p.add_(torch.rsqrt(nu + self.eps) * g * -self.lr)
                state.nu[k] = nu
