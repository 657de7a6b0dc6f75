"""Action distributions (counterpart of `actor_critic_tpu/models/distributions.py`).

Only `Categorical` is ported in this slice; the Gaussian heads come with
the continuous-control trainers.
"""

from __future__ import annotations

from typing import Optional

import torch


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
