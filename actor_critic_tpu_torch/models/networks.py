"""Actor-critic networks (counterpart of `actor_critic_tpu/models/networks.py`).

`MLPTorso` and `ActorCriticDiscrete` only, in float32. Submodule names
follow the flax parameter tree (`torso.dense_{i}`, `policy`, `value`) so
that `weights.from_flax` maps one onto the other by name. Initialisation
matches the JAX package's: orthogonal with gain √2 on the torso, 0.01 on
the policy head and 1.0 on the value head, zero biases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from actor_critic_tpu_torch.models.distributions import Categorical


def _dense(
    in_dim: int, out_dim: int, gain: float, generator: Optional[torch.Generator]
) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        nn.init.zeros_(layer.bias)
    return layer


class MLPTorso(nn.Module):
    """Tanh MLP torso shared by the actor and critic heads."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int] = (64, 64),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_layers = len(hidden)
        for i, h in enumerate(hidden):
            self.add_module(f"dense_{i}", _dense(in_dim, h, math.sqrt(2.0), generator))
            in_dim = h
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        for i in range(self.num_layers):
            x = torch.tanh(getattr(self, f"dense_{i}")(x))
        return x


class ActorCriticDiscrete(nn.Module):
    """Shared-torso policy+value net for discrete actions; `forward(obs)`
    returns (Categorical over logits, value[...]), both float32."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (64, 64),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.torso = MLPTorso(obs_dim, hidden, generator)
        self.policy = _dense(self.torso.out_dim, num_actions, 0.01, generator)
        self.value = _dense(self.torso.out_dim, 1, 1.0, generator)

    def forward(self, obs: torch.Tensor) -> tuple[Categorical, torch.Tensor]:
        z = self.torso(obs)
        return Categorical(self.policy(z).float()), self.value(z)[..., 0].float()
