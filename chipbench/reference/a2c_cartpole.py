"""Plain reference of `a2c_cartpole`: A2C (Mnih et al. 2016, synchronous)
on batched CartPole-v1, written from the published algorithm and
gymnasium's CartPole, in float32.

One iteration: T steps of [MLP forward → Gumbel-max draw → Euler step of
the cart and pole → auto-reset of the ended episodes], then the bootstrap
value at the last obs, the time-limit bootstrap r + γ·V(final obs) where
an episode was truncated, GAE(γ, λ), the loss pg + c_v·v − c_e·H with the
entropy coefficient annealed by iteration, its gradients clipped by their
global norm, one Adam step at the annealed lr, and the episode fold (all
in float32: see `plain.py` on the order of its expressions).
The uniforms come from a generator of the run's seed on the device, in
the order the step draws them: the reset's [E, 4] at the start, then per
env step the action's [E, 2] and the auto-reset's [E, 4].
"""

from __future__ import annotations

import math

import torch

from chipbench.reference import plain

GRAVITY, MASSCART, MASSPOLE, HALF_LENGTH, FORCE_MAG, TAU = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
THETA_LIMIT = 12 * 2 * math.pi / 360
X_LIMIT = 2.4
TIME_LIMIT = 500


def forward(p: dict, obs: torch.Tensor):
    """(logits, value) of the shared-torso tanh MLP."""
    h = obs
    i = 0
    while f"torso.dense_{i}.weight" in p:
        h = torch.tanh(plain.dense(h, p, f"torso.dense_{i}"))
        i += 1
    return plain.dense(h, p, "policy"), plain.dense(h, p, "value")[:, 0]


def reset(n: int, g: torch.Generator, device) -> torch.Tensor:
    """[n, 5] states (x, ẋ, θ, θ̇, t): U(−0.05, 0.05), t = 0."""
    s = torch.rand((n, 4), generator=g, device=device) * 0.1 - 0.05
    return torch.cat([s, torch.zeros((n, 1), device=device)], dim=1)


def physics(s: torch.Tensor, action: torch.Tensor):
    """gymnasium's Euler step; returns (state, terminated, truncated). The
    masses, length, gravity and force are float32 tensors, as a batch of
    envs holds them."""
    x, x_dot, th, th_dot, t = s.unbind(1)
    gravity, masscart, masspole, length, force_mag = (
        plain.const(v, s.device) for v in (GRAVITY, MASSCART, MASSPOLE, HALF_LENGTH, FORCE_MAG))
    total = masscart + masspole
    pml = masspole * length
    force = torch.where(action == 1, force_mag, -force_mag)
    cos, sin = torch.cos(th), torch.sin(th)
    temp = (force + pml * th_dot ** 2 * sin) / total
    th_acc = (gravity * sin - cos * temp) / (length * (4.0 / 3.0 - masspole * cos ** 2 / total))
    x_acc = temp - pml * th_acc * cos / total
    new = torch.stack([x + TAU * x_dot, x_dot + TAU * x_acc, th + TAU * th_dot,
                       th_dot + TAU * th_acc, t + 1], dim=1)
    term = ((new[:, 0].abs() > X_LIMIT) | (new[:, 2].abs() > THETA_LIMIT)).float()
    trunc = (new[:, 4] >= TIME_LIMIT).float() * (1.0 - term)
    return new, term, trunc


def run(conf: dict, num_envs: int, steps_per_rollout: int, weights: dict, seed: int,
        device, iterations: int = 3, fault: str | None = None) -> dict:
    """Follow `iterations` train steps from `weights` and the seed's draws.
    Returns the losses, the clipped first gradient's norm by leaf, the
    parameters' change by leaf and the carried episode and env state.
    `fault` plants one of the faults a check must catch ("half_batch": the
    loss over half the envs; "altered_reward": one env's rewards
    altered where the env produces them)."""
    plain.pin_float32()
    c = conf["config"]
    if c["normalize_adv"] or c["value_huber_delta"] > 0 or conf["env_kwargs"]:
        raise ValueError("the reference follows unnormalized advantages, the squared value "
                         "loss and gymnasium's CartPole only")
    E, T = num_envs, steps_per_rollout
    gamma, lam = c["gamma"], c["gae_lambda"]
    g = torch.Generator(device=device).manual_seed(seed)
    p = {k: w.detach().clone().float().requires_grad_(True) for k, w in weights.items()}
    p0 = {k: w.detach().clone() for k, w in p.items()}
    mu = {k: torch.zeros_like(w) for k, w in p.items()}
    nu = {k: torch.zeros_like(w) for k, w in p.items()}
    state = reset(E, g, device)
    fold = plain.EpisodeFold(E, device)
    losses, first_grads = [], None
    for it in range(iterations):
        obs_l, act_l, val_l, rew_l, done_l, term_l, fin_l = [], [], [], [], [], [], []
        with torch.no_grad():
            for _ in range(T):
                obs = state[:, :4]
                logits, value = forward(p, obs)
                action = plain.gumbel_max(logits, g)
                new, term, trunc = physics(state, action)
                reward = torch.ones(E, device=device)
                if fault == "altered_reward":
                    reward[0] = 2.0
                done = torch.maximum(term, trunc)
                fresh = reset(E, g, device)
                obs_l.append(obs); act_l.append(action); val_l.append(value)
                rew_l.append(reward); done_l.append(done); term_l.append(term)
                fin_l.append(new[:, :4])
                state = torch.where(done[:, None] > 0, fresh, new)
            obs, act, val, rew, done, term, fin = (torch.stack(x) for x in (
                obs_l, act_l, val_l, rew_l, done_l, term_l, fin_l))
            _, boot = forward(p, state[:, :4])
            _, final_v = forward(p, fin.reshape(T * E, 4))
            rew_b = rew + gamma * final_v.reshape(T, E) * done * (1.0 - term)
            adv, ret = plain.gae(rew_b, val, done, boot, gamma, lam)
        cols = slice(0, E // 2) if fault == "half_batch" else slice(0, E)
        logits, value = forward(p, obs[:, cols].reshape(-1, 4))
        logp, ent = plain.log_prob_and_entropy(logits, act[:, cols].reshape(-1))
        a, r = adv[:, cols].reshape(-1), ret[:, cols].reshape(-1)
        ent_coef = plain.const(plain.f32_anneal(c["entropy_coef"], c["entropy_coef_final"],
                                                c["anneal_iters"], it), device)
        loss = (-torch.mean(a * logp) + c["value_coef"] * (0.5 * torch.mean((value - r) ** 2))
                - ent_coef * torch.mean(ent))
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        grads = plain.clip_global_norm(grads, c["max_grad_norm"])
        if first_grads is None:
            first_grads = plain.leaf_norms(grads)
        lr = plain.f32_linear(c["lr"], c["lr_final"], c["anneal_iters"], it)
        plain.adam_step(p, grads, mu, nu, it, lr, device)
        fold(rew, done)
        losses.append(float(loss.detach()))
    return {
        "losses": losses,
        "grad_norms": first_grads,
        "delta_norms": plain.leaf_norms({k: p[k].detach() - p0[k] for k in p}),
        "state": {"obs": state[:, :4].cpu(), "ep_return": fold.ret.cpu(),
                  "ep_length": fold.length.cpu()},
    }
