"""The trainers' optimizers, written out by hand to match optax.

`a2c.make_optimizer` in the JAX package builds
`optax.chain(clip_by_global_norm(max_norm), adam(lr or linear_schedule))`,
`ppo.make_optimizer` the same with `adam(..., eps=1e-5)`, and
`impala.make_optimizer` builds
`optax.chain(clip_by_global_norm(max_norm), rmsprop(lr, decay, eps))`;
the off-policy trainers (`ddpg.py`, `sac.py`) build a plain
`optax.adam(lr)` for each of their actor, critic and temperature, and keep
its whole state where their update gate is false. This module is those
optimizers (`ClippedAdam`, `ClippedRMSProp`, `Adam` with an optional
device-side mask), step for step and in float32:

- clip: `t / g_norm * max_norm` only when `g_norm >= max_norm` (optax's
  rule; `torch.nn.utils.clip_grad_norm_` adds 1e-6 and would drift);
- Adam: b1=0.9, b2=0.999, eps outside the square root (1e-8 unless the
  trainer passes another), bias correction `1 - b**count` computed in
  float32 as optax does;
- the learning-rate schedule is read at the count BEFORE the increment;
- RMSProp as optax's `scale_by_rms` has it: nu starts at 0, no bias
  correction, and eps INSIDE the root, `g · rsqrt(nu + eps)`.
  `torch.optim.RMSprop` puts eps outside (`g / (sqrt(nu) + eps)`); at the
  IMPALA setting eps = 0.1 that is a different optimizer.

Parameters, moments and Adam's count are updated in place under
`torch.no_grad()`: a CUDA graph that captured a step reads and writes them
at the addresses it saw (`algos/loop.py`). For the same reason the count
lives on the device, as optax's does, and an Adam step looks its scalars
(lr and the two bias corrections) up there, in `scalar_table()` at the
count: a Python float would be frozen into the graph.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Union

import numpy as np
import torch

# optax.adam's b1, b2 and default eps.
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # [1] int64 on the moments' device: optimizer steps taken
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LinearSchedule:
    """optax.linear_schedule, evaluated in float32 like optax's; constant
    (`init_value`) when `transition_steps <= 0`."""

    init_value: float
    end_value: float
    transition_steps: int

    def __call__(self, count: int) -> float:
        if self.transition_steps <= 0:
            return self.init_value
        c = np.float32(min(max(count, 0), self.transition_steps))
        frac = np.float32(1.0) - c / np.float32(self.transition_steps)
        return float(np.float32(self.init_value - self.end_value) * frac
                     + np.float32(self.end_value))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> LinearSchedule:
    return LinearSchedule(init_value, end_value, transition_steps)


def bias_corrections(count: int) -> tuple[float, float]:
    """(1 − b1^count, 1 − b2^count) in float32 for the 1-based step `count`,
    as optax's `bias_correction` computes them."""
    return (float(np.float32(1.0) - np.float32(B1) ** np.float32(count)),
            float(np.float32(1.0) - np.float32(B2) ** np.float32(count)))


@functools.cache
def _bias_correction_table() -> np.ndarray:
    """`bias_corrections(k + 1)` for k = 0, 1, … up to and including the
    first k from which both are 1.0 in float32 (k = 17,320 for b2 = 0.999),
    as a read-only float32 [K, 2]. Built once per process by the scalar
    expression above: numpy's vectorised float32 power rounds ~300 of these
    counts differently."""
    rows = [bias_corrections(1)]
    while rows[-1] != (1.0, 1.0):
        rows.append(bias_corrections(len(rows) + 1))
    table = np.asarray(rows, np.float32)
    table.setflags(write=False)
    return table


def scalars_at(table: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The [3] (lr, bc1, bc2) of the step taken at `count` (a [1] int64
    tensor) from `ClippedAdam.scalar_table()` on the same device: its row at
    `count`, clamped at the last row, from which every value is constant."""
    return table.index_select(0, torch.clamp(count, max=table.shape[0] - 1))[0]


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


class Adam:
    """`optax.adam(lr, eps=eps)`, lr a float or a `LinearSchedule` of the
    step count, with no gradient transform before it: what the off-policy
    trainers build for their actor, critic and temperature."""

    def __init__(self, lr: Union[float, LinearSchedule], eps: float = EPS):
        self.lr = lr if isinstance(lr, LinearSchedule) else LinearSchedule(lr, lr, 0)
        self.eps = eps

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(count=torch.zeros(1, dtype=torch.int64, device=device),
                         mu=_zeros_like(params), nu=_zeros_like(params))

    def scalars(self, count: int) -> tuple[float, float, float]:
        """(lr, 1 − b1^(count+1), 1 − b2^(count+1)): the float32 scalars of
        the step taken at `count` steps, as `scalar_table()` holds them."""
        return (self.lr(count), *bias_corrections(count + 1))

    def scalar_table(self) -> np.ndarray:
        """`scalars(k)` for k = 0 … R−1 as float32 [R, 3]. Every later k has
        row R−1's values (the schedule has ended and both corrections are
        1.0), so a lookup clamps its index at R−1."""
        bias = _bias_correction_table()
        rows = max(len(bias), self.lr.transition_steps + 1)
        table = np.empty((rows, 3), np.float32)
        ramp = min(rows, self.lr.transition_steps + 1)
        table[:ramp, 0] = [self.lr(k) for k in range(ramp)]
        table[ramp:, 0] = self.lr(ramp)
        table[:len(bias), 1:] = bias
        table[len(bias):, 1:] = 1.0
        return table

    def step(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
        state: AdamState,
        table: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> None:
        """Apply one update to `params` and the moments in place, and count
        it in `state.count`. `table` is `scalar_table()` on the parameters'
        device; the step's (lr, bc1, bc2) is its row at `state.count`, looked
        up on the device. With `mask` (a 0-dim bool tensor on the device)
        the parameters, moments and count take their new values only where
        it is true, and keep the old ones otherwise, as the off-policy
        trainers' `select(mask, new, old)` over the whole optimizer state;
        the step is computed either way."""
        lr, bc1, bc2 = scalars_at(table, state.count).unbind()
        with torch.no_grad():
            for k, p in params.items():
                g, mu, nu = grads[k], state.mu[k], state.nu[k]
                new_mu = (1 - B1) * g + B1 * mu
                new_nu = (1 - B2) * (g * g) + B2 * nu
                update = (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + self.eps)
                if mask is None:
                    mu.copy_(new_mu)
                    nu.copy_(new_nu)
                    p.add_(update * -lr)
                else:
                    torch.where(mask, new_mu, mu, out=mu)
                    torch.where(mask, new_nu, nu, out=nu)
                    torch.where(mask, p + update * -lr, p, out=p)
            state.count.add_(1 if mask is None else mask)


class ClippedAdam(Adam):
    """`chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))`, lr a float
    or a `LinearSchedule` of the step count."""

    def __init__(self, lr: Union[float, LinearSchedule], max_norm: float, eps: float = EPS):
        super().__init__(lr, eps)
        self.max_norm = max_norm

    def step(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
        state: AdamState,
        table: torch.Tensor,
    ) -> None:
        """Clip `grads` by their global norm, then `Adam.step`."""
        super().step(params, clip_by_global_norm(grads, self.max_norm), state, table)


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
        """Apply one update to `params` and `state.nu` in place."""
        grads = clip_by_global_norm(grads, self.max_norm)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                nu = state.nu[k]
                nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
                p.add_(torch.rsqrt(nu + self.eps) * g * -self.lr)
