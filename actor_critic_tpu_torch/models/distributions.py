"""Action distributions (counterpart of `actor_critic_tpu/models/distributions.py`).

`Categorical` and `DiagGaussian`; `TanhGaussian` comes with SAC.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class Categorical:
    """Categorical distribution over discrete actions, parameterised by
    logits of shape [..., num_actions] (the trailing axis is the event
    axis)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def log_probs(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, dim=-1)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Gumbel-max draw, as `jax.random.categorical` does; the uniforms
        come from `generator` (on the logits' device)."""
        u = torch.rand(
            self.logits.shape, generator=generator,
            device=self.logits.device, dtype=self.logits.dtype,
        )
        u = u.clamp_min(torch.finfo(u.dtype).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        idx = action.to(torch.int64).unsqueeze(-1)
        return torch.gather(self.log_probs, -1, idx).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        lp = self.log_probs
        return -torch.sum(torch.exp(lp) * lp, dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)


class DiagGaussian:
    """Diagonal Gaussian over continuous actions; `mean` and `log_std` are
    [..., action_dim] and log-prob / entropy reduce over that trailing
    event axis."""

    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor):
        self.mean = mean
        self.log_std = log_std

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(self.log_std)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std·ε, ε standard normal from `generator` (on the mean's device)."""
        eps = torch.randn(
            self.mean.shape, generator=generator,
            device=self.mean.device, dtype=self.mean.dtype,
        )
        return self.mean + self.std * eps

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        z = (action - self.mean) / self.std
        return torch.sum(-0.5 * (z * z + _LOG_2PI) - self.log_std, dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        var, ovar = torch.exp(2 * self.log_std), torch.exp(2 * other.log_std)
        per_dim = (other.log_std - self.log_std
                   + (var + (self.mean - other.mean) ** 2) / (2.0 * ovar) - 0.5)
        return torch.sum(per_dim, dim=-1)
