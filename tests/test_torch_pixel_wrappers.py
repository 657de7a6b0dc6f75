"""The port's pixel preprocessing (`actor_critic_tpu_torch/envs/pixel_wrappers.py`)
against the JAX package's: the same seeded RGB frames through both
`PixelPreprocess` wrappers, every observation, reward and flag compared
bitwise (the wrapper is numpy and cv2, so the tolerance is 0), with cv2's
`INTER_AREA` resize and with the nearest-neighbour fallback taken when cv2
is missing. The cases are those of `tests/test_pixel_wrappers.py`."""

import gymnasium as gym
import numpy as np
import pytest

from actor_critic_tpu.envs import pixel_wrappers as jpx
from actor_critic_tpu_torch.envs import pixel_wrappers as px


class _SeededPixelEnv(gym.Env):
    """RGB frames of seeded noise (60×80×3 uint8) whose mean brightness
    steps with the step count; reward 2.5 a step; terminates at step 10."""

    observation_space = gym.spaces.Box(0, 255, (60, 80, 3), np.uint8)
    action_space = gym.spaces.Discrete(2)

    def __init__(self, seed: int = 0):
        self.t = 0
        self._rng = np.random.default_rng(seed)

    def _frame(self):
        noise = self._rng.integers(0, 40, (60, 80, 3))
        return np.clip(30 + 20 * self.t + noise, 0, 255).astype(np.uint8)

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._frame(), {}

    def step(self, action):
        self.t += 1
        return self._frame(), 2.5, self.t >= 10, False, {}


def _pair(seed: int = 0, **kw):
    return (px.PixelPreprocess(_SeededPixelEnv(seed), **kw),
            jpx.PixelPreprocess(_SeededPixelEnv(seed), **kw))


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        else:
            assert x == y


def _drive(env, steps: int):
    out = [env.reset()[0]]
    for _ in range(steps):
        obs, r, term, trunc, _ = env.step(0)
        out.append((obs, r, term, trunc))
        if term or trunc:
            out.append(env.reset()[0])
    return out


@pytest.mark.parametrize("cv2", [True, False], ids=["cv2", "numpy-fallback"])
@pytest.mark.parametrize("kw", [
    {"size": 84, "stack": 4},
    {"size": 60, "stack": 3},
    {"size": 30, "stack": 2},
    {"action_repeat": 3, "clip_reward": True},
    {"action_repeat": 4, "clip_reward": False},
], ids=["84x4", "60x3", "30x2", "repeat3-clip", "repeat4-raw"])
def test_frames_equal_jax_bitwise(kw, cv2, monkeypatch):
    if not cv2:
        monkeypatch.setattr(px, "_CV2", False)
        monkeypatch.setattr(jpx, "_HAS_CV2", False)
    ours, theirs = _pair(seed=3, **kw)
    a, b = _drive(ours, 14), _drive(theirs, 14)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _assert_same(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,))
    assert ours.observation_space == theirs.observation_space


def test_obs_contract():
    env = px.PixelPreprocess(_SeededPixelEnv(), size=84, stack=4)
    obs, _ = env.reset()
    assert obs.shape == (84, 84, 4) and obs.dtype == np.uint8
    assert env.observation_space.shape == (84, 84, 4)
    # reset repeats the first frame across the stack
    assert (obs[:, :, 0] == obs[:, :, 3]).all()


def test_reward_clip_and_action_repeat():
    env = px.PixelPreprocess(_SeededPixelEnv(), action_repeat=3, clip_reward=True)
    env.reset()
    assert env.step(0)[1] == 1.0  # sign(3 * 2.5)
    env2 = px.PixelPreprocess(_SeededPixelEnv(), action_repeat=3, clip_reward=False)
    env2.reset()
    assert abs(env2.step(0)[1] - 7.5) < 1e-6


def test_action_repeat_stops_at_termination():
    env = px.PixelPreprocess(_SeededPixelEnv(), action_repeat=4, clip_reward=False)
    env.reset()
    term, steps = False, 0
    while not term:
        _, _, term, _, _ = env.step(0)
        steps += 1
        assert steps < 10
    assert env.env.t == 10


def test_uint8_survives_host_pool():
    """With `normalize_obs=False` the port's pool delivers the wrapped
    frames as uint8 (the CNN scales them), equal to JAX's pool's bitwise."""
    import gymnasium.envs.registration as reg

    from actor_critic_tpu.envs.host_pool import HostEnvPool as JaxPool
    from actor_critic_tpu_torch.envs.host_pool import HostEnvPool

    if "SeededPx-v0" not in gym.registry:
        reg.register(id="SeededPx-v0", entry_point=_SeededPixelEnv)
    kw = dict(num_envs=2, pixel_preprocess=True, normalize_obs=False, normalize_reward=False)
    pool, jpool = HostEnvPool("SeededPx-v0", **kw), JaxPool("SeededPx-v0", **kw)
    try:
        obs, jobs = pool.reset(), jpool.reset()
        assert obs.dtype == np.uint8 and obs.shape == (2, 84, 84, 4)
        assert obs.tobytes() == jobs.tobytes()
        assert pool.spec.pixel_obs and pool.spec.obs_shape == (84, 84, 4)
        for _ in range(12):
            out, jout = pool.step(np.zeros(2, np.int64)), jpool.step(np.zeros(2, np.int64))
            assert out.obs.dtype == np.uint8 and out.final_obs.dtype == np.uint8
            for k in ("obs", "final_obs", "reward", "done", "terminated"):
                assert getattr(out, k).tobytes() == getattr(jout, k).tobytes(), k
    finally:
        pool.close()
        jpool.close()


def test_pixel_preprocess_refused_off_the_gym_backend():
    from actor_critic_tpu_torch.envs.host_pool import HostEnvPool

    with pytest.raises(ValueError, match="gym backend only"):
        HostEnvPool("Pendulum-v1", 2, backend="native", pixel_preprocess=True)


def test_module_imports_without_gymnasium_or_cv2():
    """The card's machine has neither: importing the module must not pull
    them in (the class is built on first access of its name)."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['gymnasium'] = None; sys.modules['cv2'] = None; "
            "import actor_critic_tpu_torch.envs.pixel_wrappers as m; "
            "import actor_critic_tpu_torch.envs.host_pool, actor_critic_tpu_torch.envs.shard_pool; "
            "print(m._resize.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
