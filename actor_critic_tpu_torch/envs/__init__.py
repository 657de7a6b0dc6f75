from actor_critic_tpu_torch.envs.acrobot import make_acrobot
from actor_critic_tpu_torch.envs.cartpole import make_cartpole
from actor_critic_tpu_torch.envs.env import (
    EnvSpec,
    StepOutput,
    TorchEnv,
    auto_reset,
    draw_scenario,
    is_randomized,
    scenario_ranges,
)
from actor_critic_tpu_torch.envs.maze import make_maze
from actor_critic_tpu_torch.envs.mixture import MixtureEnv, make_mixture, parse_mixture_spec
from actor_critic_tpu_torch.envs.pendulum import make_pendulum
from actor_critic_tpu_torch.envs.pong import make_pong
from actor_critic_tpu_torch.envs.testbeds import make_bandit, make_point_mass, make_two_state_mdp

__all__ = [
    "EnvSpec", "MixtureEnv", "StepOutput", "TorchEnv", "auto_reset", "draw_scenario",
    "is_randomized", "make_acrobot", "make_bandit", "make_cartpole", "make_maze",
    "make_mixture", "make_pendulum", "make_point_mass", "make_pong", "make_two_state_mdp",
    "parse_mixture_spec", "scenario_ranges",
]
