"""Plain reference of `impala_pong`: IMPALA (Espeholt et al. 2018) with
V-trace, the Nature CNN (Mnih et al. 2015) on two stacked 84×84 uint8
frames of a Pong-like game, in float32.

The game: the agent is the right paddle (actions stay, up, down), a
scripted left paddle tracks the ball at capped speed, the ball reflects
off the walls and the paddles (a paddle hit adds spin in proportion to
the hit's offset), a point is +1 when the opponent misses and −1 when the
agent misses, and the ball is served again from the centre after every
point; five points end the episode, 1,000 decisions truncate it. A frame
lights the ball (3×3) and both paddles (3 wide, 2·h+1 tall).

One iteration: T steps of [the actors' stale CNN forward → Gumbel-max
draw → one physics frame → render → auto-reset], the behaviour log-probs
kept; the learner's forward at the observations (with gradients), at the
last obs and at the pre-reset obs (without), the time-limit bootstrap,
V-trace(ρ̄, c̄, λ), the loss pg + c_v·v − c_e·H, its gradients clipped by
their global norm, one RMSProp step, the step count and the actor
refresh every k steps, and the episode fold. The uniforms come from a
generator of the run's seed on the device, in the order the step draws
them: the reset's serve [2, E] at the start, then per env step the
action's [E, 3], the point's serve [2, E] and the auto-reset's [2, E].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chipbench.reference import plain

CONVS = (("torso.conv_0", 4), ("torso.conv_1", 2), ("torso.conv_2", 1))
INV_255 = float(np.float32(1.0) / np.float32(255.0))


def forward(p: dict, frames: torch.Tensor):
    """(logits, value) of the Nature CNN on [N, H, W, 2] uint8 frames,
    scaled by the float32 reciprocal of 255."""
    x = (frames.float() * INV_255).permute(0, 3, 1, 2)
    for name, stride in CONVS:
        x = F.relu(F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], stride=stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flattened as (H, W, C)
    h = F.relu(plain.dense(x, p, "torso.Dense_0"))
    return plain.dense(h, p, "policy"), plain.dense(h, p, "value")[:, 0]


class Pong:
    """The game over [E] float32 tensors, with the sizes of `env_kwargs`."""

    def __init__(self, device, size=84, points_to_win=5, max_steps=1000, paddle_hh=6.0,
                 ball_speed=1.0, opp_skill=1.0, frame_skip=1):
        self.device, self.size, self.points, self.max_steps = device, size, points_to_win, max_steps
        self.frame_skip = frame_skip
        scale = size / 84.0
        self.hh = paddle_hh * scale
        self.inv_hh = float(np.float32(1.0) / np.float32(self.hh))
        self.paddle_speed = 2.0 * scale
        self.opp_speed = 1.1 * scale * ball_speed * opp_skill
        self.serve_x = 1.8 * scale * ball_speed
        self.vy_max = 2.2 * scale * ball_speed
        self.english = 1.2 * scale * ball_speed
        self.scale = scale
        self.player_x, self.opp_x = float(size - 3), 2.0
        self.lo, self.hi = self.hh, float(size - 1) - self.hh
        self.top = float(size - 1)
        self.centre = (size - 1) / 2.0
        self.grid = torch.arange(size, dtype=torch.float32, device=device)

    def serve(self, n: int, g: torch.Generator):
        u = torch.rand((2, n), generator=g, device=self.device)
        vx = torch.where(u[0] < 0.5, 1.0, -1.0) * self.serve_x
        vy = (u[1] * 2.0 - 1.0) * self.scale
        c = torch.full((n,), self.centre, device=self.device)
        return c, c.clone(), vx, vy

    def render(self, s: dict) -> torch.Tensor:
        def box(x, y, hw, hh):
            rows = (self.grid - y[:, None]).abs() <= hh
            cols = (self.grid - x[:, None]).abs() <= hw
            return rows[:, :, None] & cols[:, None, :]

        lit = (box(s["bx"], s["by"], 1.0, 1.0)
               | box(torch.full_like(s["bx"], self.player_x), s["py"], 1.0, self.hh)
               | box(torch.full_like(s["bx"], self.opp_x), s["oy"], 1.0, self.hh))
        return lit.to(torch.uint8) * 255

    def reset(self, n: int, g: torch.Generator):
        bx, by, vx, vy = self.serve(n, g)
        c = torch.full((n,), self.centre, device=self.device)
        z = torch.zeros(n, device=self.device)
        s = {"bx": bx, "by": by, "vx": vx, "vy": vy, "py": c, "oy": c.clone(),
             "ps": z, "os": z.clone(), "t": z.clone()}
        s["frame"] = self.render(s)
        return s, torch.stack([s["frame"], s["frame"]], dim=-1)

    def frame_step(self, s: dict, move: torch.Tensor, g: torch.Generator):
        py = torch.clamp(s["py"] + move * self.paddle_speed, self.lo, self.hi)
        oy = torch.clamp(s["oy"] + torch.clamp(s["by"] - s["oy"], -self.opp_speed, self.opp_speed),
                         self.lo, self.hi)
        bx, by = s["bx"] + s["vx"], s["by"] + s["vy"]
        wall = (by < 0.0) | (by > self.top)
        by = torch.where(by < 0.0, -by, by)
        by = torch.where(by > self.top, 2.0 * self.top - by, by)
        vy = torch.where(wall, -s["vy"], s["vy"])
        hit_p = (bx >= self.player_x) & ((by - py).abs() <= self.hh + 1.0)
        hit_o = (bx <= self.opp_x) & ((by - oy).abs() <= self.hh + 1.0)
        bx = torch.where(hit_p, 2.0 * self.player_x - bx, bx)
        bx = torch.where(hit_o, 2.0 * self.opp_x - bx, bx)
        hit = hit_p | hit_o
        vx = torch.where(hit, -s["vx"], s["vx"])
        offset = torch.where(hit_p, (by - py) * self.inv_hh,
                             torch.where(hit_o, (by - oy) * self.inv_hh, 0.0))
        vy = torch.clamp(vy + torch.where(hit, self.english * offset, 0.0), -self.vy_max, self.vy_max)
        p_point, o_point = bx < 0.0, bx > self.top
        reward = torch.where(p_point, 1.0, torch.where(o_point, -1.0, 0.0))
        sx, sy, svx, svy = self.serve(bx.shape[0], g)
        scored = p_point | o_point
        out = dict(s, bx=torch.where(scored, sx, bx), by=torch.where(scored, sy, by),
                   vx=torch.where(scored, svx, vx), vy=torch.where(scored, svy, vy), py=py, oy=oy,
                   ps=s["ps"] + p_point.float(), os=s["os"] + o_point.float())
        return out, reward

    def step(self, s: dict, action: torch.Tensor, g: torch.Generator):
        """(state after auto-reset, obs, reward, done, terminated, pre-reset obs)."""
        move = torch.where(action == 1, -1.0, torch.where(action == 2, 1.0, 0.0))
        new, reward = self.frame_step(s, move, g)
        for _ in range(self.frame_skip - 1):
            new, r = self.frame_step(new, move, g)
            reward = reward + r
        new["t"] = s["t"] + 1
        term = ((new["ps"] >= self.points) | (new["os"] >= self.points)).float()
        trunc = (new["t"] >= self.max_steps).float() * (1.0 - term)
        frame = self.render(new)
        final_obs = torch.stack([s["frame"], frame], dim=-1)
        new["frame"] = frame
        done = torch.maximum(term, trunc)
        fresh, fresh_obs = self.reset(action.shape[0], g)
        d = done > 0

        def pick(a, b):
            return torch.where(d.reshape(d.shape + (1,) * (a.dim() - 1)), a, b)

        out = {k: pick(fresh[k], new[k]) for k in new}
        return out, pick(fresh_obs, final_obs), reward, done, term, final_obs


def run(conf: dict, num_envs: int, steps_per_rollout: int, weights: dict, seed: int,
        device, iterations: int = 3, fault: str | None = None) -> dict:
    """Follow `iterations` train steps from `weights` (the learner's and,
    as a stale copy, the actors') and the seed's draws. Returns the
    losses, the clipped first gradient's norm by leaf, the learner's and
    the actors' change by leaf, and the carried episode state and last
    obs. `fault` as in `a2c_cartpole.run`."""
    plain.pin_float32()
    c = conf["config"]
    if c["correction"] != "vtrace":
        raise ValueError("the reference follows the V-trace correction only")
    E, T = num_envs, steps_per_rollout
    env = Pong(device, **conf["env_kwargs"])
    g = torch.Generator(device=device).manual_seed(seed)
    p = {k: w.detach().clone().float().requires_grad_(True) for k, w in weights.items()}
    p0 = {k: w.detach().clone() for k, w in p.items()}
    actor = {k: w.detach().clone() for k, w in p.items()}
    nu = {k: torch.zeros_like(w) for k, w in p.items()}
    state, obs = env.reset(E, g)
    fold = plain.EpisodeFold(E, device)
    losses, first_grads = [], None
    for it in range(iterations):
        obs_l, act_l, blp_l, rew_l, done_l, term_l, fin_l = [], [], [], [], [], [], []
        with torch.no_grad():
            for _ in range(T):
                logits, _ = forward(actor, obs)
                action = plain.gumbel_max(logits, g)
                blp, _ = plain.log_prob_and_entropy(logits, action)
                new_state, new_obs, reward, done, term, final_obs = env.step(state, action, g)
                if fault == "altered_reward":
                    reward = reward.clone()
                    reward[0] = reward[0] + 1.0
                obs_l.append(obs); act_l.append(action); blp_l.append(blp); rew_l.append(reward)
                done_l.append(done); term_l.append(term); fin_l.append(final_obs)
                state, obs = new_state, new_obs
        o, act, blp, rew, done, term, fin = (torch.stack(x) for x in (
            obs_l, act_l, blp_l, rew_l, done_l, term_l, fin_l))
        cols = slice(0, E // 2) if fault == "half_batch" else slice(0, E)
        o, act, blp, rew, done, term, fin = (x[:, cols] for x in (o, act, blp, rew, done, term, fin))
        n = o.shape[1]
        logits, values = forward(p, o.reshape(T * n, *o.shape[2:]))
        tlp, ent = plain.log_prob_and_entropy(logits, act.reshape(-1))
        tlp, values = tlp.reshape(T, n), values.reshape(T, n)
        with torch.no_grad():
            _, boot = forward(p, obs[cols])
            _, final_v = forward(p, fin.reshape(T * n, *fin.shape[2:]))
            rew_b = rew + c["gamma"] * final_v.reshape(T, n) * done * (1.0 - term)
            vs, pg = plain.vtrace(tlp.detach(), blp, rew_b, values.detach(), done, boot,
                                     c["gamma"], c["rho_bar"], c["c_bar"], c["lam"])
        loss = (-torch.mean(pg * tlp) + c["value_coef"] * (0.5 * torch.mean((values - vs) ** 2))
                - c["entropy_coef"] * torch.mean(ent))
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        grads = plain.clip_global_norm(grads, c["max_grad_norm"])
        if first_grads is None:
            first_grads = plain.leaf_norms(grads)
        plain.rmsprop_step(p, grads, nu, c["lr"], c["rms_decay"], c["rms_eps"])
        if (it + 1) % c["actor_refresh_every"] == 0:
            actor = {k: w.detach().clone() for k, w in p.items()}
        fold(torch.stack(rew_l), torch.stack(done_l))
        losses.append(float(loss.detach()))
    return {
        "losses": losses,
        "grad_norms": first_grads,
        "delta_norms": plain.leaf_norms({k: p[k].detach() - p0[k] for k in p}),
        "actor_delta_norms": plain.leaf_norms({k: actor[k] - p0[k] for k in actor}),
        "state": {"obs": obs.float().cpu(), "ep_return": fold.ret.cpu(),
                  "ep_length": fold.length.cpu()},
    }
