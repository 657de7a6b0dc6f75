"""Batched Pong-like pixel env (counterpart of `actor_critic_tpu/envs/pong.py`).

The same game as the JAX env, over `[E]` float32 state tensors: the agent
is the RIGHT paddle (actions 0 stay, 1 up, 2 down), the LEFT paddle is a
scripted opponent tracking the ball with capped speed, the ball bounces
off the walls and the paddles (a paddle hit adds "english"), +1 when the
opponent misses and −1 when the agent misses, first to `points_to_win`
terminates and `max_steps` agent decisions truncate. The observation is
`[E, size, size, 2]` uint8: the previous and the current frame.

The constants, clips and their order are the JAX env's, so from the same
state and action both envs give the same frames, positions and rewards.
Randomness (the serve after every point, and at reset) is drawn from the
generator for the whole batch and selected with `torch.where`, as the JAX
env draws a serve every physics frame and selects it where a point fell;
the draws differ from JAX's, their distributions do not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from actor_critic_tpu_torch.envs.env import EnvSpec, TorchEnv, auto_reset


class PongState(NamedTuple):
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor
    player_y: torch.Tensor  # agent paddle centre (right side)
    opp_y: torch.Tensor     # scripted paddle centre (left side)
    player_score: torch.Tensor  # int32
    opp_score: torch.Tensor     # int32
    t: torch.Tensor             # int32 agent decisions this episode
    prev_frame: torch.Tensor    # [E, H, W] uint8, for the 2-frame stack


def make_pong(
    size: int = 84,
    points_to_win: int = 5,
    max_steps: int = 1000,
    paddle_hh: float = 6.0,
    ball_speed: float = 1.0,
    opp_skill: float = 1.0,
    frame_skip: int = 1,
) -> TorchEnv:
    """Build the Pong-like env; the knobs are the JAX `make_pong`'s (see its
    docstring): `paddle_hh` paddle half-height in 84-scale pixels,
    `ball_speed` scales the ball (and the opponent and english with it),
    `opp_skill` the opponent's tracking speed alone, `frame_skip` repeats
    each action over that many physics frames and sums their rewards."""
    if size < 36:
        raise ValueError("size must be >= 36 for the Nature-CNN conv stack")
    if frame_skip < 1:
        raise ValueError("frame_skip must be >= 1 (0 would freeze the env)")
    if not 0.0 <= opp_skill < 2.0:
        # opp_speed = 1.1·scale·ball_speed·opp_skill must stay below
        # vy_max = 2.2·scale·ball_speed, or the opponent tracks every ball.
        raise ValueError("opp_skill must be in [0, 2) to keep the opponent beatable")
    scale = size / 84.0
    hh = paddle_hh * scale      # paddle half-height (pixels)
    # XLA compiles the JAX env's `offset / hh` as a multiply by the float32
    # reciprocal of the constant; so does this port, to give its values.
    inv_hh = float(np.float32(1.0) / np.float32(hh))
    paddle_speed = 2.0 * scale
    opp_speed = 1.1 * scale * ball_speed * opp_skill
    serve_speed_x = 1.8 * scale * ball_speed
    vy_max = 2.2 * scale * ball_speed
    english = 1.2 * scale * ball_speed  # vy gain per unit of hit offset
    player_x = float(size - 3)  # paddle planes
    opp_x = 2.0
    lo, hi = hh, float(size - 1) - hh  # paddle-centre travel range
    top = float(size - 1)
    centre = (size - 1) / 2.0

    def render(ball_x, ball_y, player_y, opp_y) -> torch.Tensor:
        """[E, H, W] uint8: 255 on the ball and the paddles, 0 elsewhere.
        Each shape is a row band AND a column band, as the JAX render's
        `(|ys − y| <= a) & (|xs − x| <= b)` over the [H, W] grid."""
        coords = torch.arange(size, dtype=torch.float32, device=ball_x.device)

        def box(x, y, half_w, half_h):
            rows = (coords - y[:, None]).abs() <= half_h   # [E, H]
            cols = (coords - x[:, None]).abs() <= half_w   # [E, W]
            return rows[:, :, None] & cols[:, None, :]

        px = torch.full_like(ball_x, player_x)
        ox = torch.full_like(ball_x, opp_x)
        lit = box(ball_x, ball_y, 1.0, 1.0) | box(px, player_y, 1.0, hh) | box(ox, opp_y, 1.0, hh)
        return lit.to(torch.uint8) * 255

    def serve(n: int, generator: torch.Generator, device):
        """Centred ball, random direction on x, vy uniform in [−1, 1)·scale."""
        u = torch.rand((2, n), generator=generator, device=device)
        dir_x = torch.where(u[0] < 0.5, 1.0, -1.0)
        vy = (u[1] * 2.0 - 1.0) * scale
        c = torch.full((n,), centre, dtype=torch.float32, device=device)
        return c, c, dir_x * serve_speed_x, vy

    def reset(num_envs: int, generator: torch.Generator):
        device = generator.device
        ball_x, ball_y, vel_x, vel_y = serve(num_envs, generator, device)
        c = torch.full((num_envs,), centre, dtype=torch.float32, device=device)
        zeros = torch.zeros(num_envs, dtype=torch.int32, device=device)
        frame = render(ball_x, ball_y, c, c)
        state = PongState(
            ball_x=ball_x, ball_y=ball_y, vel_x=vel_x, vel_y=vel_y,
            player_y=c, opp_y=c, player_score=zeros, opp_score=zeros, t=zeros,
            prev_frame=frame,
        )
        return state, torch.stack([frame, frame], dim=-1)

    def physics_substep(s: PongState, move: torch.Tensor, generator: torch.Generator):
        """One physics frame with the agent's move held fixed; returns the
        new state (frame not yet rendered) and the frame's reward."""
        player_y = torch.clamp(s.player_y + move * paddle_speed, lo, hi)
        opp_y = torch.clamp(
            s.opp_y + torch.clamp(s.ball_y - s.opp_y, -opp_speed, opp_speed), lo, hi
        )
        ball_x = s.ball_x + s.vel_x
        ball_y = s.ball_y + s.vel_y

        # Top/bottom wall bounce (positions reflect, vy flips).
        bounced = (ball_y < 0.0) | (ball_y > top)
        ball_y = torch.where(ball_y < 0.0, -ball_y, ball_y)
        ball_y = torch.where(ball_y > top, 2.0 * top - ball_y, ball_y)
        vel_y = torch.where(bounced, -s.vel_y, s.vel_y)

        # Paddle hits: reflect off the paddle plane, add english.
        hit_player = (ball_x >= player_x) & ((ball_y - player_y).abs() <= hh + 1.0)
        hit_opp = (ball_x <= opp_x) & ((ball_y - opp_y).abs() <= hh + 1.0)
        ball_x = torch.where(hit_player, 2.0 * player_x - ball_x, ball_x)
        ball_x = torch.where(hit_opp, 2.0 * opp_x - ball_x, ball_x)
        hit = hit_player | hit_opp
        vel_x = torch.where(hit, -s.vel_x, s.vel_x)
        offset = torch.where(
            hit_player, (ball_y - player_y) * inv_hh,
            torch.where(hit_opp, (ball_y - opp_y) * inv_hh, 0.0),
        )
        vel_y = torch.clamp(vel_y + torch.where(hit, english * offset, 0.0), -vy_max, vy_max)

        # Scoring: the ball got past a paddle plane without a hit.
        player_point = ball_x < 0.0   # opponent missed
        opp_point = ball_x > top      # agent missed
        reward = torch.where(player_point, 1.0, torch.where(opp_point, -1.0, 0.0))

        # Re-serve where a point fell (drawn for the whole batch).
        sx, sy, svx, svy = serve(ball_x.shape[0], generator, ball_x.device)
        scored = player_point | opp_point
        return s._replace(
            ball_x=torch.where(scored, sx, ball_x),
            ball_y=torch.where(scored, sy, ball_y),
            vel_x=torch.where(scored, svx, vel_x),
            vel_y=torch.where(scored, svy, vel_y),
            player_y=player_y, opp_y=opp_y,
            player_score=s.player_score + player_point.to(torch.int32),
            opp_score=s.opp_score + opp_point.to(torch.int32),
        ), reward

    def raw_step(state: PongState, action: torch.Tensor, generator: torch.Generator):
        move = torch.where(action == 1, -1.0, torch.where(action == 2, 1.0, 0.0))
        s, reward = physics_substep(state, move, generator)
        # ALE-style action repeat: the same move drives `frame_skip` physics
        # frames and the rewards sum over the window (play goes on within a
        # window after match point, as in the JAX env).
        for _ in range(frame_skip - 1):
            s, r = physics_substep(s, move, generator)
            reward = reward + r

        t = state.t + 1
        terminated = (
            (s.player_score >= points_to_win) | (s.opp_score >= points_to_win)
        ).to(torch.float32)
        truncated = (t >= max_steps).to(torch.float32) * (1.0 - terminated)
        frame = render(s.ball_x, s.ball_y, s.player_y, s.opp_y)
        nstate = s._replace(t=t, prev_frame=frame)
        obs = torch.stack([state.prev_frame, frame], dim=-1)
        return nstate, obs, reward, terminated, truncated

    spec = EnvSpec(
        obs_shape=(size, size, 2), action_dim=3, discrete=True, episode_horizon=max_steps,
    )
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
