"""Named presets (counterpart of `actor_critic_tpu/config.py`).

The presets ported so far: `a2c_cartpole`, `ppo_cartpole`, and the
IMPALA/A3C trio on the Pong-like pixel env, `impala_pong`,
`impala_pong_learn` and `a3c_pong`. Their values are held equal to the JAX
presets' by a test.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from actor_critic_tpu_torch.algos import a2c, impala, ppo


@dataclasses.dataclass(frozen=True)
class Preset:
    """A runnable training setup: algorithm + environment + config."""

    algo: str        # a2c | ppo | impala | a3c
    env: str         # env name, see train.ENVS
    config: Any      # the algorithm's frozen config dataclass
    iterations: int  # default --iterations
    description: str
    # Keyword arguments for the env maker: the difficulty and shape knobs
    # that define a runnable result, e.g. pong's opp_skill / frame_skip.
    env_kwargs: dict = dataclasses.field(default_factory=dict)


PRESETS: dict[str, Preset] = {
    # The JAX package's flagship preset: E=4096, T=64, lr 3e-3 and the
    # entropy bonus both annealed to 0 over 400 iterations.
    "a2c_cartpole": Preset(
        algo="a2c",
        env="cartpole",
        config=a2c.A2CConfig(
            num_envs=4096, rollout_steps=64, lr=3e-3,
            anneal_iters=400, lr_final=0.0,
            entropy_coef=0.01, entropy_coef_final=0.0,
        ),
        iterations=400,
        description="A2C on batched CartPole-v1, GAE through the CUDA kernel",
    ),
    # The JAX package's CartPole solver: E=256, T=128, 4 epochs × 8
    # minibatches, lr 2.5e-4 and the entropy bonus 0.01 annealed to 0 over
    # 100 iterations (lr per optimizer step); clip-ε is not annealed.
    "ppo_cartpole": Preset(
        algo="ppo",
        env="cartpole",
        config=ppo.PPOConfig(
            num_envs=256, rollout_steps=128, epochs=4, num_minibatches=8,
            lr=2.5e-4, entropy_coef=0.01, gae_lambda=0.95, gamma=0.99,
            anneal_iters=100, lr_final=0.0, entropy_coef_final=0.0,
        ),
        iterations=100,
        description="PPO on batched CartPole-v1, GAE through the CUDA kernel",
    ),
    # IMPALA with 64 actors, unroll 20 and a 4-step actor lag, Nature CNN
    # on 84×84×2 uint8 Pong frames.
    "impala_pong": Preset(
        algo="impala",
        env="pong",
        config=impala.ImpalaConfig(num_envs=64, rollout_steps=20, actor_refresh_every=4),
        iterations=2000,
        description="IMPALA on the Pong-like pixel env, V-trace through the CUDA kernel",
    ),
    # The same learner at the difficulty where it learns in the JAX
    # package's runs: opponent at half speed, frame_skip 4, 36 px frames.
    "impala_pong_learn": Preset(
        algo="impala",
        env="pong",
        config=impala.ImpalaConfig(num_envs=64, rollout_steps=20, actor_refresh_every=4),
        iterations=40_000,
        description="IMPALA on the Pong-like pixel env at the learnable difficulty "
        "(opp_skill=0.5, frame_skip=4, 36px)",
        env_kwargs={"opp_skill": 0.5, "frame_skip": 4, "size": 36},
    ),
    # The same trainer with no importance correction (the A3C rule): GAE
    # through the CUDA kernel.
    "a3c_pong": Preset(
        algo="a3c",
        env="pong",
        config=impala.ImpalaConfig(
            num_envs=64, rollout_steps=20, actor_refresh_every=4,
            correction="none", lam=0.95,
        ),
        iterations=2000,
        description="A3C-style (no importance correction) on the Pong-like pixel env",
    ),
}
