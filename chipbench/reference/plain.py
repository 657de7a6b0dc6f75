"""Plain PyTorch pieces shared by the configurations' references.

Written from the algorithms' published descriptions (GAE: Schulman et
al. 2016; V-trace: Espeholt et al. 2018; Adam and RMSProp as optax
defines them, with its float32 schedules and bias corrections; clipping
by the global norm), in float32, with plain tensor operations and Python
loops over time. Nothing here imports the program under test or JAX.

The random draws take their uniforms from a torch generator of the run's
seed in the order the step draws them, so that the reference meets the
same actions and resets as the program. Each float32 expression is
written in one stated order (a product before a sum, a division by a
tensor, a bias added inside the matrix product): the envs are chaotic,
and a last-bit difference in a state or a logit grows within a rollout
into a different action for that env, which would make a sound run read
like a wrong one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def pin_float32() -> None:
    """Full float32 on the card: no TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def const(value: float, device) -> torch.Tensor:
    """A float32 constant as a 0-dim tensor on `device` (a division by it is
    a true division, where one by a Python number may be a product with its
    reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def dense(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """x·Wᵀ + b of the layer `name`, the bias added inside the product."""
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def gumbel_max(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A categorical draw: argmax(logits + Gumbel noise), the noise from
    one uniform per logit, clamped away from 0."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=logits.dtype)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def log_prob_and_entropy(logits: torch.Tensor, actions: torch.Tensor):
    """log π(a) of each row's action, and each row's entropy."""
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, -1, actions.long().unsqueeze(-1)).squeeze(-1)
    return chosen, -torch.sum(torch.exp(logp) * logp, dim=-1)


def gae(rewards, values, dones, bootstrap, gamma: float, lam: float):
    """(advantages, λ-returns) over [T, E]; a done cuts bootstrap and trace.
    The carry a = δ + γλ(1−d)·a is one fused multiply-add."""
    adv = torch.empty_like(rewards)
    carry = torch.zeros_like(bootstrap)
    next_v = bootstrap
    for t in reversed(range(rewards.shape[0])):
        keep = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_v * keep - values[t]
        carry = torch.addcmul(delta, gamma * lam * keep, carry)
        adv[t] = carry
        next_v = values[t]
    return adv, adv + values


def vtrace(target_lp, behaviour_lp, rewards, values, dones, bootstrap, gamma: float,
           rho_bar: float, c_bar: float, lam: float, log_ratio_cap: float = 20.0):
    """(vs, pg_advantages) of V-trace over [T, E]: ρ = min(ρ̄, π/μ),
    c = λ·min(c̄, π/μ), the log ratio capped before the exp; the trace
    carry is one fused multiply-add."""
    vs = torch.empty_like(rewards)
    pg = torch.empty_like(rewards)
    acc = torch.zeros_like(bootstrap)
    next_v = next_vs = bootstrap
    for t in reversed(range(rewards.shape[0])):
        ratio = torch.exp(torch.clamp(target_lp[t] - behaviour_lp[t], max=log_ratio_cap))
        rho = torch.clamp(ratio, max=rho_bar)
        c = lam * torch.clamp(ratio, max=c_bar)
        disc = gamma * (1.0 - dones[t])
        delta = rho * (rewards[t] + disc * next_v - values[t])
        acc = torch.addcmul(delta, disc * c, acc)
        vs[t] = acc + values[t]
        pg[t] = rho * (rewards[t] + disc * next_vs - values[t])
        next_v, next_vs = values[t], vs[t]
    return vs, pg


def clip_global_norm(grads: dict, max_norm: float) -> dict:
    """g / ‖g‖ · max_norm where the global norm ‖g‖ is at least max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm) for k, g in grads.items()}


def f32_linear(init: float, final: float | None, steps: int, count: int) -> float:
    """optax's linear schedule in float32: `init` to `final` over `steps`
    counts, constant after (and `init` throughout where there is no
    schedule)."""
    if steps <= 0 or final is None:
        return init
    c = np.float32(min(max(count, 0), steps))
    frac = np.float32(1.0) - c / np.float32(steps)
    return float(np.float32(init - final) * frac + np.float32(final))


def f32_anneal(init: float, final: float | None, steps: int, count: int) -> float:
    """A coefficient annealed linearly in float32: init + (final − init)·min(count / steps, 1)."""
    if steps <= 0 or final is None:
        return init
    frac = np.clip(np.float32(count) / np.float32(steps), np.float32(0.0), np.float32(1.0))
    return float(np.float32(init) + np.float32(final - init) * np.float32(frac))


def adam_step(params: dict, grads: dict, mu: dict, nu: dict, count: int, lr: float, device,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step in place (`count` = steps taken before this one): the
    moments, then the bias-corrected update with eps outside the root; the
    corrections 1 − b^(count+1) in float32, as optax computes them."""
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count + 1))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count + 1))
    lr_t, c1_t, c2_t = (const(v, device) for v in (lr, c1, c2))
    with torch.no_grad():
        for k, p in params.items():
            mu[k] = (1 - b1) * grads[k] + b1 * mu[k]
            nu[k] = (1 - b2) * (grads[k] * grads[k]) + b2 * nu[k]
            step = (mu[k] / c1_t) / (torch.sqrt(nu[k] / c2_t) + eps)
            p.add_(step * -lr_t)


def rmsprop_step(params: dict, grads: dict, nu: dict, lr: float, decay: float,
                 eps: float) -> None:
    """One RMSProp step in place: ν from zero, eps inside the root, no
    momentum, no centring."""
    with torch.no_grad():
        for k, p in params.items():
            nu[k] = (1 - decay) * (grads[k] * grads[k]) + decay * nu[k]
            p.add_(torch.rsqrt(nu[k] + eps) * grads[k] * -lr)


class EpisodeFold:
    """Per-env running return and length over [T, E] rewards and dones,
    with an exponential moving average of the mean return of the episodes
    that end."""

    def __init__(self, num_envs: int, device, decay: float = 0.99):
        self.ret = torch.zeros(num_envs, device=device)
        self.length = torch.zeros(num_envs, device=device)
        self.avg = torch.zeros((), device=device)
        self.decay = decay

    def __call__(self, rewards: torch.Tensor, dones: torch.Tensor) -> None:
        for r, d in zip(rewards, dones):
            self.ret = self.ret + r
            self.length = self.length + 1.0
            k = torch.sum(d)
            if k > 0:
                mean = torch.sum(self.ret * d) / torch.clamp(k, min=1.0)
                self.avg = self.decay * self.avg + (1 - self.decay) * mean
            self.ret = self.ret * (1.0 - d)
            self.length = self.length * (1.0 - d)


def leaf_norms(tensors: dict) -> dict:
    """The float64 L2 norm of each tensor, by name."""
    return {k: math.sqrt(float((t.double() ** 2).sum())) for k, t in tensors.items()}
