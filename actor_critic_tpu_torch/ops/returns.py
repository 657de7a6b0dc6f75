"""Return / advantage computations as plain reverse loops over T.

Counterpart of `actor_critic_tpu/ops/returns.py` (`discounted_returns`,
`gae`, `lambda_returns`, `vtrace`, `n_step_returns`,
`normalize_advantages`). These are the PLAIN versions of the GAE
kernel in `ops/gae_cuda.py` and of the V-trace kernel in
`ops/vtrace_cuda.py`: the wrappers use them for CPU tensors, and
`chip_smoke.py` holds the kernels against them on the card.

Same conventions as the JAX module: time-major `[T, ...]` inputs, `dones`
are terminations (they cut both the bootstrap and the trace), float32
accumulation. The arithmetic is written in the kernels' order, with the
advantage carry as one fused multiply-add (`addcmul`) where XLA contracts
it too, so the kernel, this version and the JAX reference agree bit for
bit on 0/1 dones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Cap on log importance ratios before the exp, the JAX package's
# `ops.returns.LOG_RATIO_CAP`: exp(20) ≈ 4.9e8 is far above any ratio the
# clips keep and far below float32 overflow, so a drifted behaviour policy
# can never turn a ratio into inf (and inf · 0 into nan).
LOG_RATIO_CAP = 20.0


def discounted_returns(
    rewards: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
) -> torch.Tensor:
    """Monte-Carlo returns G_t = r_t + γ·(1−d_t)·G_{t+1}, bootstrapped with
    G_T = `bootstrap_value`. XLA contracts the line into one fused
    multiply-add, `fma(γ·(1−d), G′, r)`, and so does `addcmul`."""
    dones = dones.to(rewards.dtype)
    out = torch.empty_like(rewards)
    g = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = torch.addcmul(rewards[t], gamma * (1.0 - dones[t]), g)
        out[t] = g
    return out


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


class VTraceOutput(NamedTuple):
    vs: torch.Tensor  # [T, ...] V-trace value targets
    pg_advantages: torch.Tensor  # [T, ...] policy-gradient advantages
    clipped_rhos: torch.Tensor  # [T, ...] min(rho_bar, π/μ)


def vtrace(
    target_log_probs: torch.Tensor,
    behaviour_log_probs: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
) -> VTraceOutput:
    """V-trace targets (IMPALA), as the TPU kernel computes them: in reverse
    over t with carries acc_T = 0 and v_T = vs_T = bootstrap,

        raw = exp(min(tlp − blp, LOG_RATIO_CAP)),  ρ = min(ρ̄, raw)
        c   = λ·min(c̄, raw)   (c clips the RAW ratio, not ρ)
        γ_t = γ·(1 − d),       δ = ρ·(r + γ_t·v_{t+1} − v)
        acc = δ + γ_t·c·acc,   vs = acc + v
        pg  = ρ·(r + γ_t·vs_{t+1} − v)
    """
    dones = dones.to(rewards.dtype)
    vs = torch.empty_like(rewards)
    pg = torch.empty_like(rewards)
    rhos = torch.empty_like(rewards)
    acc = torch.zeros_like(bootstrap_value)
    v_next = vs_next = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        raw = torch.exp(torch.clamp(target_log_probs[t] - behaviour_log_probs[t], max=LOG_RATIO_CAP))
        rho = torch.clamp(raw, max=rho_bar)
        c = lam * torch.clamp(raw, max=c_bar)
        disc = gamma * (1.0 - dones[t])
        r, v = rewards[t], values[t]
        delta = rho * (r + disc * v_next - v)
        # One fused multiply-add, as XLA contracts this line in the JAX
        # reference and as the kernel computes it.
        acc = torch.addcmul(delta, disc * c, acc)
        vs[t] = acc + v
        pg[t] = rho * (r + disc * vs_next - v)
        rhos[t] = rho
        v_next, vs_next = v, vs[t]
    return VTraceOutput(vs=vs, pg_advantages=pg, clipped_rhos=rhos)


def n_step_returns(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float,
    n: int,
) -> torch.Tensor:
    """n-step truncated returns G_t = Σ_{k<m} γ^k r_{t+k} + γ^m V(s_{t+m}),
    m = min(n, T−t), the sum stopping at an episode's termination.
    `values[t]` is V(s_t) and `bootstrap_value` V(s_T). All t at once, a
    static loop over k < n, as the JAX function vmaps it. The discounts
    are host constants as JAX has them: γ^k a Python (float64) product
    rounded to float32 where it multiplies, γ^m a float32 power computed
    as numpy computes it (`np.float32(γ) ** np.float32(m)`, which is what
    XLA's float32 power gives)."""
    T = rewards.shape[0]
    dones = dones.to(rewards.dtype)
    vals_ext = torch.cat([values, bootstrap_value[None]], dim=0)
    t_idx = torch.arange(T, device=rewards.device)
    shape = (T,) + (1,) * (rewards.dim() - 1)
    g = torch.zeros_like(rewards)
    alive = torch.ones_like(rewards)
    disc = 1.0
    for k in range(n):
        idx = torch.clamp(t_idx + k, max=T - 1)
        valid = ((t_idx + k) < T).to(rewards.dtype).reshape(shape)
        g = g + disc * alive * valid * rewards[idx]
        alive = alive * (1.0 - dones[idx] * valid)
        disc = disc * gamma
    m = np.minimum(n, T - np.arange(T))
    boot_disc = torch.tensor(np.float32(gamma) ** m.astype(np.float32), device=rewards.device)
    boot_idx = torch.clamp(t_idx + n, max=T)
    return g + boot_disc.reshape(shape) * alive * vals_ext[boot_idx]


def normalize_advantages(advantages: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Standard advantage normalization over all elements (single device;
    the data-parallel variant comes with the multi-GPU slice)."""
    mean = torch.mean(advantages)
    sq = torch.mean(advantages**2)
    var = torch.clamp(sq - mean**2, min=0.0)
    return (advantages - mean) / (torch.sqrt(var) + eps)
