"""Host environment pool: gymnasium/MuJoCo envs, or the C++ engine, in
numpy behind one batched `step(actions)` (counterpart of
`actor_critic_tpu/envs/host_pool.py`).

The pool's semantics are the device envs' (`envs/env.py`): `done` marks
the ending step, `final_obs` carries the pre-reset observation and the
returned obs is the new episode's (SAME_STEP auto-reset). It adds the
MuJoCo preprocessing: running mean/std observation normalization
(clipped) and discounted-return-scale reward normalization, in float64,
checkpointed through `get_state`/`set_state`. The pool is plain numpy, so
its outputs are the JAX package's pool's to the bit.

Not ported yet (Queue 1, "the sharded host pool"): `workers > 1` (the
sharded multi-process pool) and `pixel_preprocess` (the Atari pixel
wrappers); both raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from actor_critic_tpu_torch.envs.env import EnvSpec

NOT_PORTED = "not ported yet (it comes with the sharded host pool, a later slice)"


def make_host_env(env_id: str, env_kwargs: dict, pixel_preprocess: bool = False):
    """One gym env exactly as the pool's gym backend builds it."""
    if pixel_preprocess:
        raise NotImplementedError(f"pixel_preprocess is {NOT_PORTED}")
    import gymnasium as gym

    return gym.make(env_id, **env_kwargs)


class RunningMeanStd:
    """Welford-style running mean/variance over batches (float64)."""

    def __init__(self, shape: tuple[int, ...]):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = 1e-4

    def update(self, x: np.ndarray) -> None:
        bmean = x.mean(axis=0)
        bvar = x.var(axis=0)
        bcount = x.shape[0]
        delta = bmean - self.mean
        tot = self.count + bcount
        self.mean = self.mean + delta * bcount / tot
        m_a = self.var * self.count
        m_b = bvar * bcount
        m2 = m_a + m_b + delta**2 * self.count * bcount / tot
        self.var = m2 / tot
        self.count = tot

    def normalize(self, x: np.ndarray, clip: float) -> np.ndarray:
        z = (x - self.mean) / np.sqrt(self.var + 1e-8)
        return np.clip(z, -clip, clip).astype(np.float32)

    def state_dict(self) -> dict[str, Any]:
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def load_state_dict(self, d: dict[str, Any]) -> None:
        self.mean = np.asarray(d["mean"], np.float64)
        self.var = np.asarray(d["var"], np.float64)
        self.count = float(d["count"])


@dataclasses.dataclass
class HostStepOutput:
    obs: np.ndarray          # post-reset obs (normalized)
    reward: np.ndarray       # normalized reward
    raw_reward: np.ndarray   # unnormalized (for episode-return reporting)
    done: np.ndarray         # 1.0 where the episode ended this step
    terminated: np.ndarray   # true termination (cuts the bootstrap)
    final_obs: np.ndarray    # pre-reset obs (normalized); == obs where not done


def scalable_bounds(discrete: bool, low, high) -> bool:
    """Whether an action space supports the [-1, 1] → Box affine map: a
    continuous Box with finite bounds (an infinite bound would make every
    scaled action nan)."""
    return not discrete and bool(np.isfinite(low).all() and np.isfinite(high).all())


class HostEnvPool:
    """Batched host envs with normalization, one `step(actions)` call.

    Actions: on a Box the policy's raw actions are clipped to the bounds; a
    Discrete space takes int arrays. With `scale_actions=True` the pool
    instead reads actions as normalized [-1, 1] and maps them affinely onto
    the Box (the tanh-policy convention: the replayed action is then the
    executed one on envs whose bounds are narrower than [-1, 1], such as
    Humanoid-v5's ±0.4). Off by default, and never to be changed under a
    resumed run.

    `backend`: "gym" (a gymnasium SyncVectorEnv, SAME_STEP auto-reset) or
    "native" (the C++ engine, `envs/native_pool.py`).
    """

    def __init__(
        self,
        env_id: str,
        num_envs: int,
        seed: int = 0,
        normalize_obs: bool = True,
        normalize_reward: bool = True,
        clip_obs: float = 10.0,
        clip_reward: float = 10.0,
        gamma: float = 0.99,
        backend: str = "gym",
        pixel_preprocess: bool = False,
        scale_actions: bool = False,
        env_kwargs: dict | None = None,
        workers: int = 1,
    ):
        self.env_id = env_id
        self.num_envs = num_envs
        env_kwargs = dict(env_kwargs or {})
        if pixel_preprocess:
            raise NotImplementedError(f"pixel_preprocess is {NOT_PORTED}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if workers > 1:
            raise NotImplementedError(f"workers > 1 is {NOT_PORTED}")
        if env_kwargs and backend != "gym":
            raise ValueError("env_kwargs go to gym.make; the native engine takes none")
        if backend == "native":
            from actor_critic_tpu_torch.envs.native_pool import NativeVecEnv

            self._envs = NativeVecEnv(env_id, num_envs)
        elif backend == "gym":
            from gymnasium.vector import AutoresetMode, SyncVectorEnv

            self._envs = SyncVectorEnv(
                [(lambda: make_host_env(env_id, env_kwargs)) for _ in range(num_envs)],
                autoreset_mode=AutoresetMode.SAME_STEP,
            )
        else:
            raise ValueError(f"backend must be 'gym' or 'native', got {backend!r}")
        try:
            space = self._envs.single_action_space
            obs_space = self._envs.single_observation_space
            self._discrete = hasattr(space, "n")
            if self._discrete:
                action_dim = int(space.n)
                self._act_low = self._act_high = None
            else:
                action_dim = int(np.prod(space.shape))
                self._act_low = np.asarray(space.low, np.float32)
                self._act_high = np.asarray(space.high, np.float32)
            if scale_actions and not scalable_bounds(self._discrete, self._act_low, self._act_high):
                raise ValueError("scale_actions needs a finite continuous action Box")
        except Exception:
            self._envs.close()
            raise
        self._scale_actions = scale_actions
        if scale_actions:
            self._act_mid = 0.5 * (self._act_high + self._act_low)
            self._act_half = 0.5 * (self._act_high - self._act_low)
        # Observations reach the trainers as float32 (MuJoCo emits float64).
        self.spec = EnvSpec(
            obs_shape=tuple(obs_space.shape),
            action_dim=action_dim,
            discrete=self._discrete,
            can_truncate=True,
        )
        self._seed = seed
        self._normalize_obs = normalize_obs
        self._normalize_reward = normalize_reward
        self._clip_obs = clip_obs
        self._clip_reward = clip_reward
        self._gamma = gamma
        self._frozen_stats = False
        self.obs_rms = RunningMeanStd(tuple(obs_space.shape))
        self.ret_rms = RunningMeanStd(())
        self._returns = np.zeros(num_envs, np.float64)
        self._backend = backend
        self._env_kwargs = env_kwargs

    @property
    def normalizes_obs(self) -> bool:
        """Whether observations are normalized with running stats (the
        resume checks of `algos/host_loop.py` read it)."""
        return self._normalize_obs

    @property
    def scales_actions(self) -> bool:
        """Whether policy actions are mapped from [-1, 1] onto the action
        Box (else clipped)."""
        return self._scale_actions

    def eval_pool(self, num_envs: int = 4, seed: int = 1234) -> "HostEnvPool":
        """A companion pool for greedy evaluation: the same env and backend,
        the SAME obs-normalization statistics (shared by reference, and
        frozen: eval sees the training policy's input distribution), raw
        rewards, fresh episodes."""
        pool = HostEnvPool(
            self.env_id, num_envs, seed=seed,
            normalize_obs=self._normalize_obs, normalize_reward=False,
            clip_obs=self._clip_obs, gamma=self._gamma,
            backend=self._backend, scale_actions=self._scale_actions,
            env_kwargs=self._env_kwargs,
        )
        pool.obs_rms = self.obs_rms  # aliased on purpose; frozen below
        pool._frozen_stats = True
        return pool

    # -- normalization ----------------------------------------------------
    def _norm_obs(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        if not self._normalize_obs:
            obs = np.asarray(obs)
            return obs if obs.dtype == np.uint8 else obs.astype(np.float32)
        obs = np.asarray(obs, np.float32)
        if update and not self._frozen_stats:
            self.obs_rms.update(obs)
        return self.obs_rms.normalize(obs, self._clip_obs)

    def _norm_reward(self, reward: np.ndarray, done: np.ndarray) -> np.ndarray:
        reward = np.asarray(reward, np.float64)
        if not self._normalize_reward:
            return reward.astype(np.float32)
        self._returns = self._returns * self._gamma * (1.0 - done) + reward
        self.ret_rms.update(self._returns)
        scaled = reward / np.sqrt(self.ret_rms.var + 1e-8)
        return np.clip(scaled, -self._clip_reward, self._clip_reward).astype(np.float32)

    # -- protocol ---------------------------------------------------------
    def reset(self) -> np.ndarray:
        obs, _ = self._envs.reset(seed=self._seed)
        self._returns[:] = 0.0
        return self._norm_obs(obs)

    def step(self, actions: np.ndarray) -> HostStepOutput:
        actions = np.asarray(actions)
        if self._discrete:
            actions = actions.astype(np.int64)
        elif self._scale_actions:
            a = np.clip(actions.astype(np.float32), -1.0, 1.0)
            actions = self._act_mid + self._act_half * a
        else:
            actions = np.clip(actions.astype(np.float32), self._act_low, self._act_high)
        obs, reward, term, trunc, info = self._envs.step(actions)
        term = np.asarray(term)
        trunc = np.asarray(trunc)
        done = (term | trunc).astype(np.float32)

        raw_obs = np.asarray(obs)
        fos = info.get("final_obs")
        if isinstance(fos, np.ndarray) and fos.dtype != object:
            # The native engine: a dense [E, ...] array, right for the
            # envs that did not end too.
            final_obs = fos.astype(raw_obs.dtype, copy=False)
        else:
            # gymnasium: an object array of optional rows (or none ended).
            final_obs = raw_obs.copy()
            if fos is not None:
                for i, fo in enumerate(fos):
                    if fo is not None:
                        final_obs[i] = fo

        nobs = self._norm_obs(obs)
        # final_obs normalized with the SAME stats, not updating them twice.
        if self._normalize_obs:
            nfinal = self.obs_rms.normalize(final_obs, self._clip_obs)
        elif final_obs.dtype == np.uint8:
            nfinal = final_obs
        else:
            nfinal = final_obs.astype(np.float32)
        nreward = self._norm_reward(reward, done)
        return HostStepOutput(
            obs=nobs,
            reward=nreward,
            raw_reward=np.asarray(reward, np.float32),
            done=done,
            terminated=term.astype(np.float32),
            final_obs=nfinal,
        )

    # -- checkpointable state --------------------------------------------
    def get_state(self) -> dict[str, Any]:
        return {
            "obs_rms": self.obs_rms.state_dict(),
            "ret_rms": self.ret_rms.state_dict(),
            "returns": self._returns.copy(),
        }

    def set_state(self, state: dict[str, Any]) -> None:
        self.obs_rms.load_state_dict(state["obs_rms"])
        self.ret_rms.load_state_dict(state["ret_rms"])
        self._returns = np.asarray(state["returns"], np.float64).copy()

    def close(self) -> None:
        self._envs.close()
