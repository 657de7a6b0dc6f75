"""Action distributions (counterpart of `actor_critic_tpu/models/distributions.py`).

`Categorical`, `DiagGaussian` and SAC's `TanhGaussian`. A sample draws its
noise from a torch generator; the tanh-Gaussian's sampling methods also
take the standard-normal noise `eps` itself, so that a test can feed them
the draws of the JAX package's keys.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_2PI = math.log(2.0 * math.pi)
# The tanh-Gaussian's log-std clip (SAC-style), so exp() never over- or
# underflows.
LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0


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

    def kl(self, other: "Categorical") -> torch.Tensor:
        """KL(self ‖ other), summed over the event axis."""
        lp, lq = self.log_probs, other.log_probs
        return torch.sum(torch.exp(lp) * (lp - lq), dim=-1)


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


def _tanh_log_det_jacobian(pre_tanh: torch.Tensor) -> torch.Tensor:
    """log |d tanh(x)/dx| = log(1 − tanh(x)²), computed stably as
    2·(log 2 − x − softplus(−2x)). JAX's softplus is `logaddexp(x, 0)`;
    `torch.nn.functional.softplus` returns x itself above its threshold of
    20, so the port takes `torch.logaddexp` against zero too."""
    neg2x = -2.0 * pre_tanh
    softplus = torch.logaddexp(neg2x, torch.zeros((), dtype=neg2x.dtype, device=neg2x.device))
    return 2.0 * (math.log(2.0) - pre_tanh - softplus)


class TanhGaussian:
    """Tanh-squashed diagonal Gaussian (SAC's actor): actions in (−1, 1)^d.
    Build it with `create`, which clips `log_std` to [LOG_STD_MIN,
    LOG_STD_MAX]."""

    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor):
        self.mean = mean
        self.log_std = log_std

    @classmethod
    def create(cls, mean: torch.Tensor, log_std: torch.Tensor) -> "TanhGaussian":
        return cls(mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX))

    @property
    def base(self) -> DiagGaussian:
        return DiagGaussian(self.mean, self.log_std)

    def _pre_tanh(self, generator: Optional[torch.Generator], eps: Optional[torch.Tensor]):
        if eps is None:
            return self.base.sample(generator)
        return self.mean + self.base.std * eps

    def sample_and_log_prob(
        self, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """A reparameterised sample (noise from `generator`, or `eps`) and
        its log-prob, the change of variables taken at the pre-tanh value."""
        pre = self._pre_tanh(generator, eps)
        logp = self.base.log_prob(pre) - torch.sum(_tanh_log_det_jacobian(pre), dim=-1)
        return torch.tanh(pre), logp

    def sample(
        self, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return torch.tanh(self._pre_tanh(generator, eps))

    def log_prob(
        self, action: torch.Tensor, pre_tanh: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Log-prob of a squashed action; without `pre_tanh` the action is
        clipped to ±(1 − 1e-6) before the atanh."""
        if pre_tanh is None:
            pre_tanh = torch.atanh(torch.clamp(action, -1.0 + 1e-6, 1.0 - 1e-6))
        return self.base.log_prob(pre_tanh) - torch.sum(_tanh_log_det_jacobian(pre_tanh), dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.mean)
