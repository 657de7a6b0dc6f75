"""Named presets (counterpart of `actor_critic_tpu/config.py`).

Only `a2c_cartpole` is ported in this slice; its values are held equal to
the JAX preset's by a test.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from actor_critic_tpu_torch.algos import a2c


@dataclasses.dataclass(frozen=True)
class Preset:
    """A runnable training setup: algorithm + environment + config."""

    algo: str        # a2c (the only algorithm ported so far)
    env: str         # env name, see train.ENVS
    config: Any      # the algorithm's frozen config dataclass
    iterations: int  # default --iterations
    description: str


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
}
