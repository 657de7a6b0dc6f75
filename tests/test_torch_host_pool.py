"""The port's host pool (`actor_critic_tpu_torch/envs/host_pool.py`, with
the C++ engine behind `native:`) against the JAX package's
(`actor_critic_tpu/envs/host_pool.py`): the same env ids, seeds and
actions give the same obs, rewards, dones, `final_obs` and normalizer
statistics, bit for bit (both pools are numpy), under clipped and scaled
actions, with and without normalization; the eval pool shares and freezes
the obs statistics; `get_state`/`set_state` round-trip; the sharded pool
and the pixel wrappers are refused off the gym backend, as in JAX
(`tests/test_torch_shard_pool.py` and `test_torch_pixel_wrappers.py` hold
them on gym).
"""

import numpy as np
import pytest

from actor_critic_tpu.envs.host_pool import HostEnvPool as JaxPool
from actor_critic_tpu.envs.host_pool import RunningMeanStd as JaxRMS
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool, RunningMeanStd, scalable_bounds

FIELDS = ("obs", "reward", "raw_reward", "done", "terminated", "final_obs")
NATIVE = ["CartPole-v1", "Pendulum-v1", "MountainCarContinuous-v0", "Acrobot-v1"]


def _actions(spec, rng, n, scale):
    if spec.discrete:
        return rng.integers(0, spec.action_dim, n)
    # Beyond the bounds on purpose: the clip (or the [-1, 1] clip of the
    # scaled convention) must act.
    return (rng.normal(size=(n, spec.action_dim)) * scale).astype(np.float32)


def _assert_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_state_equal(js, ts):
    for k in ("obs_rms", "ret_rms"):
        for f in ("mean", "var", "count"):
            _assert_equal(js[k][f], ts[k][f], f"{k}.{f}")
    _assert_equal(js["returns"], ts["returns"], "returns")


def _run_both(env_id, backend, steps, seed=3, num_envs=3, **kw):
    """Step the two pools side by side; assert every output equal."""
    jp = JaxPool(env_id, num_envs, seed=seed, backend=backend, **kw)
    tp = HostEnvPool(env_id, num_envs, seed=seed, backend=backend, **kw)
    assert (tp.spec.obs_shape, tp.spec.action_dim, tp.spec.discrete, tp.spec.can_truncate) == (
        jp.spec.obs_shape, jp.spec.action_dim, jp.spec.discrete, jp.spec.can_truncate)
    _assert_equal(jp.reset(), tp.reset(), "reset obs")
    rng = np.random.default_rng(seed)
    dones = 0
    for t in range(steps):
        a = _actions(tp.spec, rng, num_envs, scale=3.0)
        jo, to = jp.step(a), tp.step(a)
        for f in FIELDS:
            _assert_equal(getattr(jo, f), getattr(to, f), f"{env_id} step {t} {f}")
        dones += int(to.done.sum())
    _assert_state_equal(jp.get_state(), tp.get_state())
    return jp, tp, dones


@pytest.mark.parametrize("env_id", NATIVE)
def test_native_pool_equals_jax(env_id):
    """1000 steps: past every env's time limit (MountainCar's is 999), so
    `final_obs` and the auto-reset are compared too."""
    jp, tp, dones = _run_both(env_id, "native", 1000)
    assert dones > 0, env_id
    jp.close()
    tp.close()


@pytest.mark.parametrize("env_id", ["Pendulum-v1", "MountainCarContinuous-v0"])
@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
def test_native_scaled_actions_equal_jax(env_id, normalize):
    _run_both(env_id, "native", 250, scale_actions=True, normalize_obs=normalize,
              normalize_reward=normalize)


@pytest.mark.parametrize("scale_actions", [False, True], ids=["clip", "scale"])
def test_gym_pendulum_equals_jax(scale_actions):
    pytest.importorskip("gymnasium")
    _, _, dones = _run_both("Pendulum-v1", "gym", 450, scale_actions=scale_actions)
    assert dones > 0


@pytest.mark.parametrize("scale_actions", [False, True], ids=["clip", "scale"])
def test_gym_halfcheetah_equals_jax(scale_actions):
    """MuJoCo emits float64 obs; both pools deliver float32."""
    pytest.importorskip("mujoco")
    pytest.importorskip("gymnasium")
    jp, tp, _ = _run_both("HalfCheetah-v5", "gym", 60, num_envs=2, scale_actions=scale_actions)
    assert tp.reset().dtype == np.float32


def test_eval_pool_shares_frozen_stats():
    jp, tp, _ = _run_both("Pendulum-v1", "native", 50)
    je, te = jp.eval_pool(2, seed=7), tp.eval_pool(2, seed=7)
    assert te.obs_rms is tp.obs_rms
    count = tp.obs_rms.count
    _assert_equal(je.reset(), te.reset(), "eval reset")
    rng = np.random.default_rng(0)
    for t in range(210):
        a = _actions(te.spec, rng, 2, scale=2.0)
        jo, to = je.step(a), te.step(a)
        for f in FIELDS:
            _assert_equal(getattr(jo, f), getattr(to, f), f"eval step {t} {f}")
        # Raw rewards: the eval pool does not normalize them.
        _assert_equal(to.reward, to.raw_reward, "eval reward")
    assert tp.obs_rms.count == count


def test_state_roundtrip_equals_jax():
    jp, tp, _ = _run_both("Acrobot-v1", "native", 80)
    state = tp.get_state()
    _assert_state_equal(jp.get_state(), state)
    fresh = HostEnvPool("Acrobot-v1", 3, seed=3, backend="native")
    jfresh = JaxPool("Acrobot-v1", 3, seed=3, backend="native")
    fresh.set_state(state)
    jfresh.set_state(jp.get_state())
    _assert_state_equal(jfresh.get_state(), fresh.get_state())
    assert fresh.get_state()["returns"] is not state["returns"]
    _assert_equal(jfresh.reset(), fresh.reset(), "reset after set_state")


def test_running_mean_std_equals_jax():
    rng = np.random.default_rng(1)
    j, t = JaxRMS((4,)), RunningMeanStd((4,))
    for n in (1, 7, 32):
        x = rng.normal(size=(n, 4)).astype(np.float32) * 3 + 1
        j.update(x)
        t.update(x)
        for f in ("mean", "var"):
            _assert_equal(getattr(j, f), getattr(t, f), f)
        assert j.count == t.count
        _assert_equal(j.normalize(x, 10.0), t.normalize(x, 10.0), "normalize")


def test_scaled_bounds_and_refusals():
    assert scalable_bounds(False, np.float32([-1]), np.float32([2]))
    assert not scalable_bounds(False, np.float32([-np.inf]), np.float32([2]))
    assert not scalable_bounds(True, None, None)
    with pytest.raises(ValueError, match="scale_actions"):
        HostEnvPool("CartPole-v1", 2, backend="native", scale_actions=True)
    # The sharded pool and the pixel wrappers are gym-only, as in JAX
    # (`tests/test_torch_shard_pool.py` drives them on gym).
    with pytest.raises(ValueError, match="workers applies to the gym backend only"):
        HostEnvPool("Pendulum-v1", 4, backend="native", workers=2)
    with pytest.raises(ValueError, match="pixel_preprocess applies to the gym backend only"):
        HostEnvPool("Pendulum-v1", 4, backend="native", pixel_preprocess=True)
    with pytest.raises(ValueError, match="native engine takes none"):
        HostEnvPool("Pendulum-v1", 2, backend="native", env_kwargs={"g": 9.0})
    with pytest.raises(ValueError, match="native backend supports"):
        HostEnvPool("HalfCheetah-v5", 2, backend="native")
    with pytest.raises(ValueError, match="backend must be"):
        HostEnvPool("Pendulum-v1", 2, backend="sharded")
