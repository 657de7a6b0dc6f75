"""Target-network updates (counterpart of `actor_critic_tpu/ops/polyak.py`),
in place on the target's own tensors, as a CUDA graph of the off-policy
step needs them (`algos/ddpg.py`, `algos/sac.py`)."""

from __future__ import annotations

from typing import Mapping, Optional

import torch


def polyak_update(
    online: Mapping[str, torch.Tensor],
    target: Mapping[str, torch.Tensor],
    tau: float,
    mask: Optional[torch.Tensor] = None,
) -> None:
    """target ← (1−τ)·target + τ·online, tensor by tensor, in place. τ is
    the update rate (e.g. 0.005). The JAX package writes
    `(1.0 - tau) * t + tau * o`, and XLA contracts it into one fused
    multiply-add, `fma(t, 1−τ, τ·o)`; `addcmul` is that, on the CPU and on
    the card (`lerp_` rounds otherwise). With `mask` (a 0-dim bool tensor
    on the device) the target takes the new value only where it is true,
    as the trainers' `select(mask, polyak_update(...), target)`."""
    with torch.no_grad():
        first = next(iter(target.values()))
        keep = torch.full((), 1.0 - tau, dtype=first.dtype, device=first.device)
        for k, t in target.items():
            new = torch.addcmul(tau * online[k], t, keep)
            if mask is None:
                t.copy_(new)
            else:
                torch.where(mask, new, t, out=t)


def hard_update(online: Mapping[str, torch.Tensor], target: Mapping[str, torch.Tensor]) -> None:
    """target ← online (a periodic hard sync, DQN-style), in place."""
    with torch.no_grad():
        for k, t in target.items():
            t.copy_(online[k])
