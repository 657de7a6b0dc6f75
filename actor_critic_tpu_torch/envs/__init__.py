from actor_critic_tpu_torch.envs.cartpole import make_cartpole
from actor_critic_tpu_torch.envs.env import EnvSpec, StepOutput, TorchEnv, auto_reset

__all__ = ["EnvSpec", "StepOutput", "TorchEnv", "auto_reset", "make_cartpole"]
