"""Sleep-padded gym testbed envs (counterpart of
`actor_critic_tpu/envs/sleep_pad.py`).

`SleepPadEnv` pads every step with `time.sleep(sleep_s)` (wall time, no
CPU), on a deterministic drift over a 4-dim state seeded through
gymnasium's `np_random`; `crash_at_step > 0` raises inside `step()` once
that many steps have run in the instance (the actor-death tests).
`SleepPadCartPoleEnv` is CartPole-v1 with the same pad: real dynamics
under a simulator-shaped wall cost, the async straggler testbed.

This is the only module of the port that imports gymnasium at import
time, and nothing on the card's path imports it. Make the envs from any
process by gymnasium's module-import id syntax; the module registers them
at import:

    gym.make("actor_critic_tpu_torch.envs.sleep_pad:SleepPad-v0", sleep_s=0.002)
"""

from __future__ import annotations

import time
from typing import Optional

import gymnasium as gym
import numpy as np
from gymnasium import spaces

ENV_ID = "SleepPad-v0"
# The full id `gym.make` resolves with no prior registration import.
QUALIFIED_ENV_ID = f"{__name__}:{ENV_ID}"


class SleepPadEnv(gym.Env):
    metadata: dict = {"render_modes": []}

    def __init__(self, sleep_s: float = 0.0, horizon: int = 200, crash_at_step: int = 0):
        self.observation_space = spaces.Box(-np.inf, np.inf, (4,), np.float32)
        self.action_space = spaces.Discrete(2)
        self._sleep_s = float(sleep_s)
        self._horizon = int(horizon)
        self._crash_at_step = int(crash_at_step)
        self._t = 0
        self._lifetime_steps = 0
        self._state = np.zeros(4, np.float32)

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._state = self.np_random.uniform(-1.0, 1.0, size=4).astype(np.float32)
        return self._state.copy(), {}

    def step(self, action):
        self._lifetime_steps += 1
        if self._crash_at_step and self._lifetime_steps >= self._crash_at_step:
            raise RuntimeError(
                "SleepPadEnv: injected crash at lifetime step "
                f"{self._lifetime_steps} (crash_at_step={self._crash_at_step})")
        if self._sleep_s > 0:
            time.sleep(self._sleep_s)
        self._t += 1
        drift = np.float32(0.01) * (np.float32(int(action)) * 2.0 - 1.0)
        self._state = (self._state + drift).astype(np.float32)
        reward = float(action)
        truncated = self._t >= self._horizon
        return self._state.copy(), reward, False, truncated, {}


CARTPOLE_ENV_ID = "SleepPadCartPole-v0"
QUALIFIED_CARTPOLE_ID = f"{__name__}:{CARTPOLE_ENV_ID}"


class SleepPadCartPoleEnv(gym.Env):
    """CartPole-v1 with a per-step wall-time pad. A plain delegating Env (not
    a gym.Wrapper): a registered entry point needs a class-level
    `metadata` dict."""

    metadata: dict = {"render_modes": []}

    def __init__(self, sleep_s: float = 0.0):
        self._env = gym.make("CartPole-v1")
        self._sleep_s = float(sleep_s)
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space

    def reset(self, *, seed: Optional[int] = None, options=None):
        return self._env.reset(seed=seed, options=options)

    def step(self, action):
        if self._sleep_s > 0:
            time.sleep(self._sleep_s)
        return self._env.step(action)

    def close(self):
        self._env.close()


if ENV_ID not in gym.registry:
    gym.register(id=ENV_ID, entry_point=f"{__name__}:SleepPadEnv")
if CARTPOLE_ENV_ID not in gym.registry:
    gym.register(id=CARTPOLE_ENV_ID, entry_point=f"{__name__}:SleepPadCartPoleEnv")
