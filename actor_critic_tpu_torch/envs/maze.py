"""Batched procedural obstacle maze (counterpart of
`actor_critic_tpu/envs/maze.py`).

Every episode draws a fresh layout per instance: an N×N grid (`size`,
default 8) of Bernoulli obstacles at the scenario's density (clipped to
[0, 0.9]), a start and a goal cell (a goal drawn on the start is shifted
one cell diagonally, mod N), both cleared. Four actions (up, right, down,
left); a move into a wall or an obstacle stays put; reaching the goal
terminates with `goal_reward`; every step costs `step_cost`; episodes
truncate at 8·N steps. The observation is 13 floats: the 3×3 window of the
grid around the agent, cells outside it read as walls (the grid padded
with 1s), then the agent's row and column and the goal's offset, each over
N.

The whole batch is generated and stepped with tensor ops: the start and
goal cells are cleared with one index write, the window and the blocked
test are gathers at computed flat indices, with no loop over instances and
no host round trip. Scenario fleet (`envs/env.py`): density, step_cost and
goal_reward, drawn per instance at every reset.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from actor_critic_tpu_torch.envs.env import (
    DeviceTable,
    EnvSpec,
    ScenarioBounds,
    TorchEnv,
    auto_reset,
    draw_scenario,
    scenario_ranges,
)

DENSITY = 0.25
STEP_COST = 0.05
GOAL_REWARD = 1.0

# The columns of `MazeState.scenario`, in order.
SCENARIO_DEFAULTS = {
    "density": DENSITY,
    "step_cost": STEP_COST,
    "goal_reward": GOAL_REWARD,
}

# (row, col) deltas for actions 0..3 = up/right/down/left.
DELTAS = ((-1, 0), (0, 1), (1, 0), (0, -1))


class MazeState(NamedTuple):
    grid: torch.Tensor  # [E, N, N] float32, 1.0 = obstacle
    row: torch.Tensor   # int64 agent cell
    col: torch.Tensor
    goal_row: torch.Tensor
    goal_col: torch.Tensor
    t: torch.Tensor     # int32 steps this episode
    scenario: torch.Tensor  # [E, 3] float32, SCENARIO_DEFAULTS' parameters


def make_maze(
    size: int = 8,
    randomize: float = 0.0,
    density=None,
    step_cost=None,
    goal_reward=None,
) -> TorchEnv:
    """The procedural maze, optionally with randomized generation knobs.
    `size` fixes the shapes; the layout is new every episode whatever
    `randomize` is."""
    if size < 3:
        raise ValueError(f"size must be >= 3, got {size}")
    max_steps = 8 * size
    bounds = ScenarioBounds.of(scenario_ranges(
        SCENARIO_DEFAULTS, randomize,
        {"density": density, "step_cost": step_cost, "goal_reward": goal_reward},
    ))
    deltas = DeviceTable(DELTAS, torch.int64)
    # Flat offsets of the 3×3 window in the 1-padded grid (row stride N+2)
    # from the window's top-left cell, which is the agent's own cell there.
    window = DeviceTable(
        [r * (size + 2) + c for r in range(3) for c in range(3)], torch.int64)
    # XLA compiles the JAX env's `/ n` as a multiply by the float32
    # reciprocal of the constant; so does this port, to give its values.
    inv_size = float(np.float32(1.0) / np.float32(size))

    def obs_of(s: MazeState) -> torch.Tensor:
        padded = F.pad(s.grid, (1, 1, 1, 1), value=1.0).flatten(1)
        corner = s.row * (size + 2) + s.col
        cells = torch.gather(padded, 1, corner[:, None] + window.on(corner.device))
        feats = torch.stack(
            [s.row, s.col, s.goal_row - s.row, s.goal_col - s.col], dim=-1
        ).to(torch.float32) * inv_size
        return torch.cat([cells, feats], dim=-1)

    def reset(num_envs: int, generator: torch.Generator) -> tuple[MazeState, torch.Tensor]:
        device = generator.device
        scenario = draw_scenario(generator, num_envs, bounds)
        dens = torch.clamp(scenario[:, 0], 0.0, 0.9)
        grid = (torch.rand((num_envs, size, size), generator=generator, device=device)
                < dens[:, None, None]).to(torch.float32)
        cells = torch.randint(0, size, (num_envs, 4), generator=generator, device=device)
        pos, goal = cells[:, :2], cells[:, 2:]
        # A goal on the start moves one cell diagonally (mod N): no
        # rejection loop, the shapes stay static.
        same = (pos == goal).all(dim=-1, keepdim=True)
        goal = torch.where(same, (goal + 1) % size, goal)
        # Start and goal are free: one index write clears both cells.
        flat = torch.stack([pos[:, 0] * size + pos[:, 1], goal[:, 0] * size + goal[:, 1]], 1)
        grid.view(num_envs, -1).scatter_(1, flat, 0.0)
        state = MazeState(
            grid=grid, row=pos[:, 0], col=pos[:, 1], goal_row=goal[:, 0], goal_col=goal[:, 1],
            t=torch.zeros(num_envs, dtype=torch.int32, device=device), scenario=scenario,
        )
        return state, obs_of(state)

    def raw_step(state: MazeState, action: torch.Tensor, generator: torch.Generator):
        del generator  # deterministic dynamics
        _, step_cost, goal_reward = state.scenario.unbind(-1)
        delta = deltas.on(action.device)[action.to(torch.int64) % 4]
        nr = torch.clamp(state.row + delta[:, 0], 0, size - 1)
        nc = torch.clamp(state.col + delta[:, 1], 0, size - 1)
        blocked = torch.gather(state.grid.flatten(1), 1, (nr * size + nc)[:, None])[:, 0] > 0.5
        row = torch.where(blocked, state.row, nr)
        col = torch.where(blocked, state.col, nc)
        t = state.t + 1
        nstate = state._replace(row=row, col=col, t=t)
        reached = ((row == state.goal_row) & (col == state.goal_col)).to(torch.float32)
        reward = goal_reward * reached - step_cost
        terminated = reached
        truncated = (t >= max_steps).to(torch.float32) * (1.0 - terminated)
        return nstate, obs_of(nstate), reward, terminated, truncated

    spec = EnvSpec(obs_shape=(13,), action_dim=4, discrete=True, episode_horizon=max_steps)
    return TorchEnv(spec=spec, reset=reset, step=auto_reset(reset, raw_step))
