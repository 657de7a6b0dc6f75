"""The port's build of the C++ env engine (`actor_critic_tpu_torch/native`)
against the JAX package's library (`actor_critic_tpu/native`), step for
step and bit for bit: reset draws, forced dynamics states, actions past
the bounds, terminations, truncations and `final_obs`, for the four engine
envs. The port's library is built into `build/native/` of the checkout,
never next to the JAX package's; a missing compiler raises, with no
gymnasium stand-in.
"""

import numpy as np
import pytest

from actor_critic_tpu.envs.native_pool import NativeVecEnv as JaxNative
from actor_critic_tpu_torch import native
from actor_critic_tpu_torch.envs.native_pool import Box, Discrete, NativeVecEnv
from actor_critic_tpu_torch.utils import compile_cache

ENVS = {
    "CartPole-v1": lambda rng, n: rng.integers(0, 2, n),
    "Pendulum-v1": lambda rng, n: rng.uniform(-3, 3, (n, 1)).astype(np.float32),
    "MountainCarContinuous-v0": lambda rng, n: rng.uniform(-1.5, 1.5, (n, 1)).astype(np.float32),
    "Acrobot-v1": lambda rng, n: rng.integers(0, 3, n),
}


@pytest.mark.parametrize("env_id", sorted(ENVS))
def test_engine_steps_equal_jax_library(env_id):
    n = 5
    j, t = JaxNative(env_id, n), NativeVecEnv(env_id, n)
    for a, b in zip(j.reset(seed=11), t.reset(seed=11)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    # A forced state far from the reset distribution, then 1100 steps:
    # terminations, every time limit (MountainCar's 999) and resets.
    start = rng.uniform(-0.2, 0.2, (n, j._spec["state_dim"]))
    j.set_state(start)
    t.set_state(start)
    ended = 0
    for step in range(1100):
        acts = ENVS[env_id](rng, n)
        jo, tout = j.step(acts), t.step(acts)
        for k, (a, b) in enumerate(zip(jo[:4], tout[:4])):
            assert a.dtype == b.dtype, (env_id, step, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{env_id} step {step} output {k}")
        assert sorted(jo[4]) == sorted(tout[4])
        if "final_obs" in tout[4]:
            np.testing.assert_array_equal(jo[4]["final_obs"], tout[4]["final_obs"])
            ended += 1
    assert ended > 0
    np.testing.assert_array_equal(j._state, t._state)


def test_spaces_equal_gymnasium():
    gym = pytest.importorskip("gymnasium")
    for env_id in ENVS:
        env = gym.make(env_id)
        ours = NativeVecEnv(env_id, 1)
        o, g = ours.single_observation_space, env.observation_space
        assert o.shape == g.shape and o.dtype == g.dtype
        np.testing.assert_array_equal(o.low, g.low)
        np.testing.assert_array_equal(o.high, g.high)
        a, ga = ours.single_action_space, env.action_space
        if isinstance(a, Discrete):
            assert a.n == ga.n
        else:
            assert isinstance(a, Box) and a.shape == ga.shape
            np.testing.assert_array_equal(a.low, ga.low)
            np.testing.assert_array_equal(a.high, ga.high)
        env.close()


def test_library_is_built_into_build_dir():
    native.load()
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == "native"
    assert lib.parent.parent.name == "build"
    assert "actor_critic_tpu/" not in str(lib)
    assert "-ffp-contract=off" in native.CXX_FLAGS


def test_build_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with compile_cache.temporary_cache(tmp_path):
        with pytest.raises(ImportError, match="needs g\\+\\+"):
            native.build()
    assert list((tmp_path / "native").iterdir()) == []


def test_build_renames_into_place(tmp_path):
    with compile_cache.temporary_cache(tmp_path / "b"):
        out = native.build()
    assert out.exists() and out == tmp_path / "b" / "native" / out.name
    assert [p.name for p in (tmp_path / "b" / "native").iterdir()] == [out.name]
