"""Return / advantage computations as plain reverse loops over T.

Counterpart of `actor_critic_tpu/ops/returns.py` (`gae`, `lambda_returns`,
`normalize_advantages`). These are the PLAIN versions of the GAE kernel in
`ops/gae_cuda.py`: the wrapper uses them for CPU tensors, and
`chip_smoke.py` holds the kernel against them on the card.

Same conventions as the JAX module: time-major `[T, ...]` inputs, `dones`
are terminations (they cut both the bootstrap and the trace), float32
accumulation. The arithmetic is written in the kernel's order, with the
advantage carry as one fused multiply-add (`addcmul`) where XLA contracts
it too, so the kernel, this version and the JAX reference agree bit for
bit on 0/1 dones.
"""

from __future__ import annotations

import torch


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation; returns (advantages, returns) with
    returns = advantages + values (the λ-return targets)."""
    dones = dones.to(rewards.dtype)
    adv = torch.empty_like(rewards)
    a = torch.zeros_like(bootstrap_value)
    v_next = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        # One fused multiply-add, as XLA contracts this line in the JAX
        # reference and as the kernel computes it.
        a = torch.addcmul(delta, gamma * lam * nonterm, a)
        adv[t] = a
        v_next = values[t]
    return adv, adv + values


def lambda_returns(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    lam: float,
) -> torch.Tensor:
    """TD(λ) return targets; equals `gae(...)[1]`."""
    return gae(rewards, values, dones, bootstrap_value, gamma, lam)[1]


def normalize_advantages(advantages: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Standard advantage normalization over all elements (single device;
    the data-parallel variant comes with the multi-GPU slice)."""
    mean = torch.mean(advantages)
    sq = torch.mean(advantages**2)
    var = torch.clamp(sq - mean**2, min=0.0)
    return (advantages - mean) / (torch.sqrt(var) + eps)
