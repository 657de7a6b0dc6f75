from actor_critic_tpu_torch.envs.cartpole import make_cartpole
from actor_critic_tpu_torch.envs.env import EnvSpec, StepOutput, TorchEnv, auto_reset
from actor_critic_tpu_torch.envs.pong import make_pong
from actor_critic_tpu_torch.envs.testbeds import make_point_mass, make_two_state_mdp

__all__ = [
    "EnvSpec", "StepOutput", "TorchEnv", "auto_reset", "make_cartpole", "make_point_mass",
    "make_pong", "make_two_state_mdp",
]
