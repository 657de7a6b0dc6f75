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

`compute_dtype=torch.bfloat16` is the JAX networks' `compute_dtype`
(`--update-dtype bf16`): the parameters stay float32 tensors (the master
weights the optimizer steps), and each forward casts the input, the
weight and the bias to bf16 and rounds the product, the bias add and the
activation to bf16 op by op, as flax's `nn.Dense(dtype=bf16)` and
`nn.Conv(dtype=bf16)` do on XLA (`_dense_forward`, `_conv_forward`). The
heads cast their outputs up to float32 where the JAX heads do, before any
log or exp; the Gaussian's `log_std` parameter stays float32. In float32
every module computes what it computed before the option existed. A
rollout's forwards share one set of bf16 weight copies (`shared_casts`).

Pixel observations keep the JAX package's NHWC layout `[..., H, W, C]` at
the public interface (the env's obs, the Transition); `NatureCNN`
permutes to NCHW for `F.conv2d` and back to NHWC before the flatten, so
that `Dense_0` sees flax's flatten order.
"""

from __future__ import annotations

import contextlib
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


def _cast_weights(layer: Union[nn.Linear, nn.Conv2d], dtype: torch.dtype):
    """(weight, bias) in `dtype`: the copies `shared_casts` made, in a
    forward without autograd inside its block, else cast now."""
    shared = layer.__dict__.get("_shared_casts")
    if shared is not None and not torch.is_grad_enabled():
        return shared
    return layer.weight.to(dtype), layer.bias.to(dtype)


def _dense_forward(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype`: the module's own call in float32;
    in bf16 the weight and bias cast to bf16, the product and the bias add
    each rounded to bf16 (flax adds the bias after its dot, so a fused
    add would round once where XLA rounds twice)."""
    if dtype == torch.float32:
        return layer(x)
    weight, bias = _cast_weights(layer, dtype)
    return F.linear(x.to(dtype), weight) + bias


def _conv_forward(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`conv(x)` (NCHW) computed in `dtype`, as `_dense_forward`."""
    if dtype == torch.float32:
        return conv(x)
    weight, bias = _cast_weights(conv, dtype)
    return F.conv2d(x.to(dtype), weight, None, conv.stride) + bias[:, None, None]


@contextlib.contextmanager
def shared_casts(net: nn.Module):
    """Inside the block, the bf16 layers of `net` read bf16 copies of their
    weights and biases made once on entry, where each forward would cast
    them anew: a rollout's T forwards share one set, the same bits with two
    kernels a layer fewer a step. Only forwards without autograd read the
    copies, so a gradient always reaches the float32 master weights.
    Entered inside a captured step, the copies are made on every replay
    from the weights as they then are. Float32 nets are left as they are."""
    layers = [(layer, owner.compute_dtype) for owner in net.modules()
              if getattr(owner, "compute_dtype", torch.float32) != torch.float32
              for layer in owner.children() if isinstance(layer, (nn.Linear, nn.Conv2d))]
    with torch.no_grad():
        for layer, dtype in layers:
            layer.__dict__["_shared_casts"] = (layer.weight.to(dtype), layer.bias.to(dtype))
    try:
        yield
    finally:
        for layer, _ in layers:
            layer.__dict__.pop("_shared_casts", None)


class MLPTorso(nn.Module):
    """MLP torso shared by the actor and critic heads: tanh after each
    layer (the on-policy nets), or ReLU (`activation=torch.relu`, the
    off-policy actors and critics). Its output is in `compute_dtype`."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int] = (64, 64),
        generator: Optional[torch.Generator] = None,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.tanh,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_layers = len(hidden)
        self.activation = activation
        self.compute_dtype = compute_dtype
        for i, h in enumerate(hidden):
            self.add_module(f"dense_{i}", _dense(in_dim, h, math.sqrt(2.0), generator))
            in_dim = h
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for i in range(self.num_layers):
            x = self.activation(_dense_forward(getattr(self, f"dense_{i}"), x,
                                               self.compute_dtype))
        return x


class NatureCNN(nn.Module):
    """Nature-DQN conv stack for pixel observations `[..., H, W, C]`, uint8
    (scaled by 1/255) or float: three VALID convolutions (32/64/64
    channels, kernels 8/4/3, strides 4/2/1), each with a ReLU, then Dense
    512 with a ReLU. Its output is in `compute_dtype`."""

    channels = (32, 64, 64)
    kernels = (8, 4, 3)
    strides = (4, 2, 1)
    dense = 512

    def __init__(self, obs_shape: Sequence[int], generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
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
        dtype = self.compute_dtype
        if dtype == torch.float32:
            # XLA compiles the JAX package's `x / 255.0` as a multiply by
            # the float32 reciprocal (126 of the 256 byte values then differ
            # from a true division by one ulp); the port computes what XLA
            # computes.
            x = x.float() * _INV_255 if x.dtype == torch.uint8 else x.float()
        else:
            # In bf16 the division's float32 ulp vanishes in the rounding
            # to bf16: all 256 byte values equal XLA's (tests/test_torch_bf16.py).
            x = x.to(dtype) / 255.0 if x.dtype == torch.uint8 else x.to(dtype)
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(len(self.channels)):
            x = F.relu(_conv_forward(getattr(self, f"conv_{i}"), x, dtype))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)
        return F.relu(_dense_forward(self.Dense_0, x, dtype))


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
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        if pixel_obs:
            self.torso = NatureCNN(obs_shape, generator, compute_dtype)
        else:
            obs_dim = obs_shape if isinstance(obs_shape, int) else obs_shape[-1]
            self.torso = MLPTorso(obs_dim, hidden, generator, compute_dtype=compute_dtype)
        self.policy = _dense(self.torso.out_dim, num_actions, 0.01, generator)
        self.value = _dense(self.torso.out_dim, 1, 1.0, generator)

    def forward(self, obs: torch.Tensor) -> tuple[Categorical, torch.Tensor]:
        z = self.torso(obs)
        logits = _dense_forward(self.policy, z, self.compute_dtype)
        value = _dense_forward(self.value, z, self.compute_dtype)
        return Categorical(logits.float()), value[..., 0].float()


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
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.pi_torso = MLPTorso(obs_dim, hidden, generator, compute_dtype=compute_dtype)
        self.vf_torso = MLPTorso(obs_dim, hidden, generator, compute_dtype=compute_dtype)
        self.policy = _dense(self.pi_torso.out_dim, action_dim, 0.01, generator)
        self.value = _dense(self.vf_torso.out_dim, 1, 1.0, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs: torch.Tensor) -> tuple[DiagGaussian, torch.Tensor]:
        dtype = self.compute_dtype
        mean = _dense_forward(self.policy, self.pi_torso(obs), dtype).float()
        value = _dense_forward(self.value, self.vf_torso(obs), dtype)[..., 0].float()
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
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.torso = MLPTorso(obs_dim, hidden, generator, activation=torch.relu,
                              compute_dtype=compute_dtype)
        self.action = _dense(self.torso.out_dim, action_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(_dense_forward(self.action, self.torso(obs), self.compute_dtype).float())


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
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.torso = MLPTorso(obs_dim, hidden, generator, activation=torch.relu,
                              compute_dtype=compute_dtype)
        self.mean = _dense(self.torso.out_dim, action_dim, 0.01, generator)
        self.log_std = _dense(self.torso.out_dim, action_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor) -> TanhGaussian:
        z = self.torso(obs)
        dtype = self.compute_dtype
        return TanhGaussian.create(_dense_forward(self.mean, z, dtype).float(),
                                   _dense_forward(self.log_std, z, dtype).float())


class QFunction(nn.Module):
    """Q(s, a): a ReLU torso over [obs, action] and a scalar head (`q`,
    gain 1.0); `forward(obs, action)` returns q[...]."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        generator: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.torso = MLPTorso(obs_dim + action_dim, hidden, generator, activation=torch.relu,
                              compute_dtype=compute_dtype)
        self.q = _dense(self.torso.out_dim, 1, 1.0, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        return _dense_forward(self.q, self.torso(x), self.compute_dtype)[..., 0].float()


class TwinQ(nn.Module):
    """TD3's and SAC's twin critics `q1` and `q2`; `forward(obs, action)`
    returns (q1, q2)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        hidden: Sequence[int] = (256, 256),
        generator: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.q1 = QFunction(obs_dim, action_dim, hidden, generator, compute_dtype)
        self.q2 = QFunction(obs_dim, action_dim, hidden, generator, compute_dtype)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.q1(obs, action), self.q2(obs, action)
