"""NativeVecEnv: the C++ batched engine (`native/vecenv.cpp`) behind the
vector-env API `HostEnvPool` uses (counterpart of
`actor_critic_tpu/envs/native_pool.py`).

`reset(seed)` → (obs, info); `step(actions)` → (obs, reward, terminated,
truncated, info with `final_obs`), with gymnasium's SAME_STEP auto-reset.
The whole batch steps in one C call. Env ids: CartPole-v1 and Acrobot-v1
(discrete), Pendulum-v1 and MountainCarContinuous-v0 (continuous), with
gymnasium's dynamics to the bit.

The spaces are the engine's own `Box` and `Discrete` (the attributes the
pool reads), so the engine runs where gymnasium is not installed.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np

_SPECS = {
    "CartPole-v1": dict(
        prefix="cartpole",
        state_dim=4, obs_dim=4, discrete=True, n_actions=2, max_steps=500,
        obs_high=np.array([4.8, np.inf, 0.41887903, np.inf], np.float32),
    ),
    "Pendulum-v1": dict(
        prefix="pendulum",
        state_dim=2, obs_dim=3, discrete=False, act_low=-2.0, act_high=2.0,
        max_steps=200,
        obs_high=np.array([1.0, 1.0, 8.0], np.float32),
    ),
    "MountainCarContinuous-v0": dict(
        prefix="mountaincar",
        state_dim=2, obs_dim=2, discrete=False, act_low=-1.0, act_high=1.0,
        max_steps=999,
        obs_low=np.array([-1.2, -0.07], np.float32),
        obs_high=np.array([0.6, 0.07], np.float32),
    ),
    "Acrobot-v1": dict(
        prefix="acrobot",
        state_dim=4, obs_dim=6, discrete=True, n_actions=3, max_steps=500,
        obs_high=np.array([1.0, 1.0, 1.0, 1.0, 4 * np.pi, 9 * np.pi], np.float32),
    ),
}


def supported(env_id: str) -> bool:
    return env_id in _SPECS


@dataclasses.dataclass(frozen=True)
class Box:
    """A float32 box space: `low`, `high` (arrays of `shape`), `shape`, `dtype`."""

    low: np.ndarray
    high: np.ndarray
    shape: tuple[int, ...]
    dtype: np.dtype = np.dtype(np.float32)

    @classmethod
    def of(cls, low, high, shape: Optional[tuple[int, ...]] = None) -> "Box":
        high = np.asarray(high, np.float32)
        shape = tuple(shape if shape is not None else high.shape)
        return cls(np.broadcast_to(np.asarray(low, np.float32), shape).copy(),
                   np.broadcast_to(high, shape).copy(), shape)


@dataclasses.dataclass(frozen=True)
class Discrete:
    """`n` actions."""

    n: int


class NativeVecEnv:
    """The engine's env batch, with the gymnasium.vector API subset that
    `HostEnvPool` uses."""

    def __init__(self, env_id: str, num_envs: int):
        if env_id not in _SPECS:
            raise ValueError(f"native backend supports {sorted(_SPECS)}, got {env_id!r}")
        from actor_critic_tpu_torch import native

        self._lib = native.load()
        self._spec = _SPECS[env_id]
        self.env_id = env_id
        self.num_envs = num_envs

        high = self._spec["obs_high"]
        self.single_observation_space = Box.of(self._spec.get("obs_low", -high), high)
        if self._spec["discrete"]:
            self.single_action_space = Discrete(self._spec["n_actions"])
        else:
            self.single_action_space = Box.of(self._spec["act_low"], self._spec["act_high"], (1,))

        n, sd, od = num_envs, self._spec["state_dim"], self._spec["obs_dim"]
        self._state = np.zeros((n, sd), np.float64)  # gymnasium's precision
        self._steps = np.zeros(n, np.int32)
        self._rng = np.zeros(1, np.uint64)
        self._obs = np.zeros((n, od), np.float32)
        self._reward = np.zeros(n, np.float32)
        self._term = np.zeros(n, np.uint8)
        self._trunc = np.zeros(n, np.uint8)
        self._final_obs = np.zeros((n, od), np.float32)

    @staticmethod
    def _p(a: np.ndarray, ctype=ctypes.c_float):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng[0] = np.uint64(seed) ^ np.uint64(0xDA3E39CB94B95BDB)
        fn = getattr(self._lib, self._spec["prefix"] + "_reset")
        fn(self._p(self._state, ctypes.c_double), self._p(self._obs), self.num_envs,
           self._p(self._rng, ctypes.c_uint64), self._p(self._steps, ctypes.c_int32))
        return self._obs.copy(), {}

    def step(self, actions: np.ndarray):
        fn = getattr(self._lib, self._spec["prefix"] + "_step")
        if self._spec["discrete"]:
            acts = np.ascontiguousarray(actions, np.int64).reshape(self.num_envs)
            act_ptr = self._p(acts, ctypes.c_int64)
        else:
            acts = np.ascontiguousarray(actions, np.float32).reshape(self.num_envs)
            act_ptr = self._p(acts)
        fn(self._p(self._state, ctypes.c_double), act_ptr, self.num_envs,
           self._p(self._rng, ctypes.c_uint64), self._p(self._steps, ctypes.c_int32),
           np.int32(self._spec["max_steps"]), self._p(self._obs), self._p(self._reward),
           self._p(self._term, ctypes.c_uint8), self._p(self._trunc, ctypes.c_uint8),
           self._p(self._final_obs))
        term = self._term.astype(bool)
        trunc = self._trunc.astype(bool)
        info = {}
        if (term | trunc).any():
            # Unlike gymnasium's list of optional rows, the engine fills
            # final_obs for every env (the obs where the episode went on),
            # so the dense [E, obs] array is passed: consumers tell ended
            # episodes by terminated | truncated, as HostEnvPool does.
            info["final_obs"] = self._final_obs.copy()
        return self._obs.copy(), self._reward.copy(), term, trunc, info

    def set_state(self, values: np.ndarray) -> None:
        """Test hook: force exact dynamics states (step counts to 0)."""
        values = np.ascontiguousarray(values, np.float64)
        self._lib.set_state(self._p(self._state, ctypes.c_double),
                            self._p(values, ctypes.c_double), self.num_envs,
                            self._spec["state_dim"])
        self._steps[:] = 0

    def close(self) -> None:
        pass
