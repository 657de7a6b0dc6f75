"""Actor-critic networks (counterpart of `actor_critic_tpu/models/networks.py`).

`MLPTorso`, `NatureCNN`, `ActorCriticDiscrete` and `ActorCriticGaussian`
(the on-policy nets), and the off-policy `DeterministicActor`,
`SquashedGaussianActor`, `QFunction` and `TwinQ` (ReLU torsos), in
float32. Submodule names follow the flax parameter tree
(`torso.dense_{i}`, `torso.conv_{i}`, `torso.Dense_0`, `pi_torso`,
`vf_torso`, `policy`, `value`, `log_std`, `action`, `mean`, `q`,
`q1`/`q2`) so that `weights.from_flax` maps one onto the other by name.
Initialisation matches the JAX package's: orthogonal with gain √2 on the
torso, 0.01 on the policy, action, mean and log-std heads and 1.0 on the
value and Q heads, zero biases, a zero `log_std` parameter.

Pixel observations keep the JAX package's NHWC layout `[..., H, W, C]` at
the public interface (the env's obs, the Transition); `NatureCNN`
permutes to NCHW for `F.conv2d` and back to NHWC before the flatten, so
that `Dense_0` sees flax's flatten order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from actor_critic_tpu_torch.models.distributions import Categorical, DiagGaussian, TanhGaussian

_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _dense(
    in_dim: int, out_dim: int, gain: float, generator: Optional[torch.Generator]
) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        nn.init.zeros_(layer.bias)
    return layer


class MLPTorso(nn.Module):
    """MLP torso shared by the actor and critic heads: tanh after each
    layer (the on-policy nets), or ReLU (`activation=torch.relu`, the
    off-policy actors and critics)."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int] = (64, 64),
        generator: Optional[torch.Generator] = None,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
    ):
        super().__init__()
        self.num_layers = len(hidden)
        self.activation = activation
        for i, h in enumerate(hidden):
            self.add_module(f"dense_{i}", _dense(in_dim, h, math.sqrt(2.0), generator))
            in_dim = h
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        for i in range(self.num_layers):
            x = self.activation(getattr(self, f"dense_{i}")(x))
        return x


class NatureCNN(nn.Module):
    """Nature-DQN conv stack for pixel observations `[..., H, W, C]`, uint8
    (scaled by 1/255) or float: three VALID convolutions (32/64/64
    channels, kernels 8/4/3, strides 4/2/1), each with a ReLU, then Dense
    512 with a ReLU."""

    channels = (32, 64, 64)
    kernels = (8, 4, 3)
    strides = (4, 2, 1)
    dense = 512

    def __init__(self, obs_shape: Sequence[int], generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w, c_in = obs_shape
        for i, (c, k, s) in enumerate(zip(self.channels, self.kernels, self.strides)):
            conv = nn.Conv2d(c_in, c, k, stride=s)
            with torch.no_grad():
                nn.init.orthogonal_(conv.weight, gain=math.sqrt(2.0), generator=generator)
                nn.init.zeros_(conv.bias)
            self.add_module(f"conv_{i}", conv)
            h, w, c_in = (h - k) // s + 1, (w - k) // s + 1, c
        if h < 1 or w < 1:
            raise ValueError(f"observation {tuple(obs_shape)} is too small for the conv stack")
        # flax names the unnamed Dense of `NatureCNN` `Dense_0`.
        self.Dense_0 = _dense(h * w * c_in, self.dense, math.sqrt(2.0), generator)
        self.out_dim = self.dense

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # XLA compiles the JAX package's `x / 255.0` as a multiply by the
        # float32 reciprocal (126 of the 256 byte values then differ from a
        # true division by one ulp); the port computes what XLA computes.
        x = x.float() * _INV_255 if x.dtype == torch.uint8 else x.float()
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(len(self.channels)):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)
        return F.relu(self.Dense_0(x))


class ActorCriticDiscrete(nn.Module):
    """Shared-torso policy+value net for discrete actions; `forward(obs)`
    returns (Categorical over logits, value[...]), both float32. The torso
    is `NatureCNN` when `pixel_obs` (then `obs_shape` is `(H, W, C)`), else
    `MLPTorso` over `obs_shape` = `(obs_dim,)` or `obs_dim`."""

    def __init__(
        self,
        obs_shape: Union[int, Sequence[int]],
        num_actions: int,
        hidden: Sequence[int] = (64, 64),
        generator: Optional[torch.Generator] = None,
        pixel_obs: bool = False,
    ):
        super().__init__()
        if pixel_obs:
            self.torso = NatureCNN(obs_shape, generator)
        else:
            obs_dim = obs_shape if isinstance(obs_shape, int) else obs_shape[-1]
            self.torso = MLPTorso(obs_dim, hidden, generator)
        self.policy = _dense(self.torso.out_dim, num_actions, 0.01, generator)
        self.value = _dense(self.torso.out_dim, 1, 1.0, generator)

    def forward(self, obs: torch.Tensor) -> tuple[Categorical, torch.Tensor]:
        z = self.torso(obs)
        return Categorical(self.policy(z).float()), self.value(z)[..., 0].float()


class ActorCriticGaussian(nn.Module):
    """Policy+value net for continuous actions: separate tanh MLP torsos for
    the actor (`pi_torso`) and the critic (`vf_torso`), and a learned
    state-independent `log_std`; `forward(obs)` returns (DiagGaussian,
    value[...]), both float32."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (64, 64),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.pi_torso = MLPTorso(obs_dim, hidden, generator)
        self.vf_torso = MLPTorso(obs_dim, hidden, generator)
        self.policy = _dense(self.pi_torso.out_dim, action_dim, 0.01, generator)
        self.value = _dense(self.vf_torso.out_dim, 1, 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs: torch.Tensor) -> tuple[DiagGaussian, torch.Tensor]:
        mean = self.policy(self.pi_torso(obs)).float()
        value = self.value(self.vf_torso(obs))[..., 0].float()
        return DiagGaussian(mean, self.log_std.expand_as(mean)), value


class DeterministicActor(nn.Module):
    """DDPG/TD3's actor: a ReLU torso and a tanh-bounded action head
    (`action`, gain 0.01); `forward(obs)` returns the action in (−1, 1)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.torso = MLPTorso(obs_dim, hidden, generator, activation=torch.relu)
        self.action = _dense(self.torso.out_dim, action_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.action(self.torso(obs)).float())


class SquashedGaussianActor(nn.Module):
    """SAC's actor: a ReLU torso, then `mean` and a state-dependent
    `log_std` head (both gain 0.01); `forward(obs)` returns the
    `TanhGaussian` (log-std clipped by `create`)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.torso = MLPTorso(obs_dim, hidden, generator, activation=torch.relu)
        self.mean = _dense(self.torso.out_dim, action_dim, 0.01, generator)
        self.log_std = _dense(self.torso.out_dim, action_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor) -> TanhGaussian:
        z = self.torso(obs)
        return TanhGaussian.create(self.mean(z).float(), self.log_std(z).float())


class QFunction(nn.Module):
    """Q(s, a): a ReLU torso over [obs, action] and a scalar head (`q`,
    gain 1.0); `forward(obs, action)` returns q[...]."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.torso = MLPTorso(obs_dim + action_dim, hidden, generator, activation=torch.relu)
        self.q = _dense(self.torso.out_dim, 1, 1.0, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        return self.q(self.torso(x))[..., 0].float()


class TwinQ(nn.Module):
    """TD3's and SAC's twin critics `q1` and `q2`; `forward(obs, action)`
    returns (q1, q2)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.q1 = QFunction(obs_dim, action_dim, hidden, generator)
        self.q2 = QFunction(obs_dim, action_dim, hidden, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.q1(obs, action), self.q2(obs, action)
