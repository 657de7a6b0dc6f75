"""The off-policy building blocks of the port against the JAX package's, on
the same numpy inputs and flax parameters (converted by
`actor_critic_tpu_torch.weights.from_flax`):

- `DeterministicActor`, `SquashedGaussianActor`, `QFunction`, `TwinQ`
  forward (tolerance 1e-5: float32 matrix products summed in another
  order), their parameter names, and the init gains (0.01 on the action,
  mean and log-std heads, 1.0 on the Q heads);
- `TanhGaussian`: `log_prob` (with the ±(1 − 1e-6) pre-atanh clip),
  `sample_and_log_prob` and `sample` from the same ε, `mode`, the log-std
  clip; `_tanh_log_det_jacobian` over a range that reaches |2x| > 20,
  where `torch.nn.functional.softplus` would switch to its linear branch
  (within 1e-6, the ulp mismatches of exp/log1p counted);
- `polyak_update` (bit for bit: XLA's fused multiply-add is `addcmul`),
  its mask, and `hard_update`;
- `discounted_returns` and `n_step_returns`;
- `ddpg.nstep_batch` on `tests/test_ddpg.py`'s three window cases and on
  random windows, the float32 powers γ^k and γ^m bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import ddpg as jddpg
from actor_critic_tpu.algos.common import OffPolicyTransition as JTransition
from actor_critic_tpu.models import distributions as jdist
from actor_critic_tpu.models import networks as jnets
from actor_critic_tpu.ops import polyak as jpolyak
from actor_critic_tpu.ops import returns as jreturns
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import ddpg as tddpg
from actor_critic_tpu_torch.algos.common import OffPolicyTransition
from actor_critic_tpu_torch.models import distributions as tdist
from actor_critic_tpu_torch.models import networks as tnets
from actor_critic_tpu_torch.ops import polyak as tpolyak
from actor_critic_tpu_torch.ops import returns as treturns

TOL = dict(rtol=1e-5, atol=1e-5)
OBS, ACT, HIDDEN = 5, 3, (32, 16)


def _pair(name, seed=0):
    rng = np.random.default_rng(seed)
    obs = jnp.zeros((1, OBS), jnp.float32)
    act = jnp.zeros((1, ACT), jnp.float32)
    if name == "deterministic":
        jnet, args = jnets.DeterministicActor(ACT, HIDDEN), (obs,)
        tnet = tnets.DeterministicActor(OBS, ACT, HIDDEN)
    elif name == "squashed":
        jnet, args = jnets.SquashedGaussianActor(ACT, HIDDEN), (obs,)
        tnet = tnets.SquashedGaussianActor(OBS, ACT, HIDDEN)
    elif name == "q":
        jnet, args = jnets.QFunction(HIDDEN), (obs, act)
        tnet = tnets.QFunction(OBS, ACT, HIDDEN)
    else:
        jnet, args = jnets.TwinQ(HIDDEN), (obs, act)
        tnet = tnets.TwinQ(OBS, ACT, HIDDEN)
    params = jax.device_get(jnet.init(jax.random.key(seed), *args))
    # The actors' heads scaled up from their 0.01 init, so the tanh and the
    # log-std clip are exercised away from zero.
    for head in ("action", "mean", "log_std"):
        if head in params["params"]:
            params["params"][head] = jax.tree.map(
                lambda x: x * float(rng.uniform(100, 300)), params["params"][head])
    tnet.load_state_dict(weights.from_flax(params))
    return jnet, params, tnet


def _obs_act(n=301, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=2.0, size=(n, OBS)).astype(np.float32),
            rng.uniform(-1, 1, size=(n, ACT)).astype(np.float32))


@pytest.mark.parametrize("name", ["deterministic", "squashed", "q", "twin"])
def test_forward_matches_flax(name):
    jnet, params, tnet = _pair(name)
    obs, act = _obs_act()
    with torch.no_grad():
        if name == "deterministic":
            np.testing.assert_allclose(tnet(torch.from_numpy(obs)).numpy(),
                                       np.asarray(jnet.apply(params, obs)), **TOL)
        elif name == "squashed":
            got, want = tnet(torch.from_numpy(obs)), jnet.apply(params, obs)
            np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), **TOL)
            np.testing.assert_allclose(got.log_std.numpy(), np.asarray(want.log_std), **TOL)
            assert float(got.log_std.max()) == tdist.LOG_STD_MAX  # the clip bites
            np.testing.assert_allclose(got.mode().numpy(), np.asarray(want.mode()), **TOL)
        elif name == "q":
            got = tnet(torch.from_numpy(obs), torch.from_numpy(act))
            assert got.shape == (len(obs),)
            np.testing.assert_allclose(got.numpy(), np.asarray(jnet.apply(params, obs, act)), **TOL)
        else:
            got = tnet(torch.from_numpy(obs), torch.from_numpy(act))
            want = jnet.apply(params, obs, act)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_parameter_names_follow_the_flax_tree():
    assert sorted(tnets.TwinQ(OBS, ACT, (8,)).state_dict()) == sorted(
        f"{q}.{m}.{p}" for q in ("q1", "q2") for m in ("torso.dense_0", "q")
        for p in ("weight", "bias"))
    assert sorted(tnets.SquashedGaussianActor(OBS, ACT, (8,)).state_dict()) == sorted(
        f"{m}.{p}" for m in ("torso.dense_0", "mean", "log_std") for p in ("weight", "bias"))
    assert sorted(tnets.DeterministicActor(OBS, ACT, (8,)).state_dict()) == sorted(
        f"{m}.{p}" for m in ("torso.dense_0", "action") for p in ("weight", "bias"))


@pytest.mark.parametrize("net,head,gain", [
    (lambda g: tnets.DeterministicActor(OBS, ACT, HIDDEN, g), "action", 0.01),
    (lambda g: tnets.SquashedGaussianActor(OBS, ACT, HIDDEN, g), "mean", 0.01),
    (lambda g: tnets.SquashedGaussianActor(OBS, ACT, HIDDEN, g), "log_std", 0.01),
    (lambda g: tnets.QFunction(OBS, ACT, HIDDEN, g), "q", 1.0),
    (lambda g: tnets.TwinQ(OBS, ACT, HIDDEN, g), "q2.q", 1.0),
    (lambda g: tnets.QFunction(OBS, ACT, HIDDEN, g), "torso.dense_0", 2.0 ** 0.5),
])
def test_init_gains(net, head, gain):
    sd = net(torch.Generator().manual_seed(0)).state_dict()
    w = sd[f"{head}.weight"].double() / gain
    small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    np.testing.assert_allclose(small.numpy(), np.eye(small.shape[0]), atol=1e-5)
    assert torch.count_nonzero(sd[f"{head}.bias"]) == 0


def _tanh_pair(seed=2, n=513, log_std_range=(-25, 4)):
    rng = np.random.default_rng(seed)
    mean = rng.normal(scale=2.0, size=(n, ACT)).astype(np.float32)
    log_std = rng.uniform(*log_std_range, size=(n, ACT)).astype(np.float32)
    jd = jdist.TanhGaussian.create(jnp.asarray(mean), jnp.asarray(log_std))
    td = tdist.TanhGaussian.create(torch.from_numpy(mean), torch.from_numpy(log_std))
    return jd, td


def test_tanh_gaussian_create_log_prob_and_mode():
    jd, td = _tanh_pair()
    np.testing.assert_array_equal(td.log_std.numpy(), np.asarray(jd.log_std))
    assert float(td.log_std.min()) == -20.0 and float(td.log_std.max()) == 2.0
    np.testing.assert_allclose(td.mode().numpy(), np.asarray(jd.mode()), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(3)
    # Actions at and beyond ±1 go through the ±(1 − 1e-6) clip.
    action = rng.uniform(-1, 1, size=td.mean.shape).astype(np.float32)
    action[:8] = np.float32(1.0)
    action[8:16] = np.float32(-1.0)
    want = np.asarray(jax.jit(lambda a: jd.log_prob(a))(action))
    got = td.log_prob(torch.from_numpy(action)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    pre = rng.normal(size=td.mean.shape).astype(np.float32)
    np.testing.assert_allclose(
        td.log_prob(torch.tanh(torch.from_numpy(pre)), torch.from_numpy(pre)).numpy(),
        np.asarray(jd.log_prob(jnp.tanh(pre), jnp.asarray(pre))), rtol=1e-5, atol=1e-4)


def test_tanh_gaussian_samples_from_shared_eps():
    """`sample_and_log_prob` and `sample` given the ε JAX's key draws, at
    log-stds an actor's head gives (a pre-tanh value deep in the
    saturation, where a last-bit change moves the log-det by a lot, is
    `test_tanh_log_det_jacobian_matches_jax`'s)."""
    jd, td = _tanh_pair(seed=4, log_std_range=(-5, 1))
    key = jax.random.key(5)
    eps = np.array(jax.random.normal(key, jd.mean.shape, jnp.float32))
    ja, jlogp = jax.jit(lambda: jd.sample_and_log_prob(key))()
    ta, tlogp = td.sample_and_log_prob(eps=torch.from_numpy(eps))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(td.sample(eps=torch.from_numpy(eps)).numpy(), ta.numpy())
    # From a generator: the same function of the generator's normals.
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    a, _ = td.sample_and_log_prob(g1)
    eps_t = torch.randn(td.mean.shape, generator=g2)
    np.testing.assert_array_equal(a.numpy(), td.sample(eps=eps_t).numpy())


def test_tanh_log_det_jacobian_matches_jax():
    """Over x in [−30, 30] (|2x| up to 60, past softplus's threshold of 20):
    within 1e-6 absolute, and XLA's and torch's exp/log1p differ in the last
    bit on a few inputs, counted."""
    x = np.linspace(-30, 30, 60001).astype(np.float32)
    want = np.asarray(jax.jit(jdist._tanh_log_det_jacobian)(x))
    got = tdist._tanh_log_det_jacobian(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all() and got.max() <= 2 * math.log(2.0)
    mismatches = int((got != want).sum())
    assert mismatches < x.size // 10, mismatches
    # Where softplus would have turned linear, the port still follows JAX.
    far = np.abs(x) > 10
    np.testing.assert_allclose(got[far], want[far], rtol=1e-6, atol=1e-6)


def test_polyak_update_is_bitwise_jax():
    rng = np.random.default_rng(6)
    online = {"w": rng.normal(size=(64, 48)).astype(np.float32),
              "b": rng.normal(size=(48,)).astype(np.float32)}
    target = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in online.items()}
    want = jax.jit(lambda o, t: jpolyak.polyak_update(o, t, 0.005))(online, target)
    t_target = {k: torch.from_numpy(v.copy()) for k, v in target.items()}
    ptrs = {k: v.data_ptr() for k, v in t_target.items()}
    tpolyak.polyak_update({k: torch.from_numpy(v) for k, v in online.items()}, t_target, 0.005)
    for k in online:
        np.testing.assert_array_equal(t_target[k].numpy(), np.asarray(want[k]))
        assert t_target[k].data_ptr() == ptrs[k]
    # A false mask keeps the target; hard_update copies.
    before = {k: v.clone() for k, v in t_target.items()}
    tpolyak.polyak_update({k: torch.from_numpy(v) for k, v in online.items()}, t_target, 0.5,
                          mask=torch.tensor(False))
    assert all(torch.equal(before[k], t_target[k]) for k in before)
    tpolyak.hard_update({k: torch.from_numpy(v) for k, v in online.items()}, t_target)
    assert all(np.array_equal(t_target[k].numpy(), online[k]) for k in online)


def _returns_inputs(T=13, E=6, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, E)).astype(np.float32), rng.normal(size=(T, E)).astype(np.float32),
            (rng.random((T, E)) < 0.2).astype(np.float32), rng.normal(size=(E,)).astype(np.float32))


def test_discounted_returns_matches_jax():
    rewards, _, dones, boot = _returns_inputs()
    want = np.asarray(jax.jit(lambda *a: jreturns.discounted_returns(*a, 0.97))(rewards, dones, boot))
    got = treturns.discounted_returns(*map(torch.from_numpy, (rewards, dones, boot)), 0.97).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert int((got != want).sum()) <= want.size // 10


@pytest.mark.parametrize("n", [1, 3, 20])
def test_n_step_returns_matches_jax(n):
    rewards, values, dones, boot = _returns_inputs()
    want = np.asarray(jax.jit(lambda *a: jreturns.n_step_returns(*a, 0.97, n))(
        rewards, values, dones, boot))
    got = treturns.n_step_returns(*map(torch.from_numpy, (rewards, values, dones, boot)),
                                  0.97, n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _seq(rewards, done, terminated, n):
    """tests/test_ddpg.py's hand-built [1, n] window, on both sides."""
    arrays = dict(
        obs=np.arange(n, dtype=np.float32).reshape(1, n, 1),
        action=np.full((1, n, 1), 0.5, np.float32),
        reward=np.asarray([rewards], np.float32),
        next_obs=(10.0 + np.arange(n, dtype=np.float32)).reshape(1, n, 1),
        terminated=np.asarray([terminated], np.float32),
        done=np.asarray([done], np.float32),
    )
    return arrays


NSTEP_CASES = {
    "no_done": ([1.0, 2.0, 4.0], [0, 0, 0], [0, 0, 0]),
    "terminates_mid_window": ([1.0, 2.0, 100.0], [0, 1, 0], [0, 1, 0]),
    "truncates_first_step": ([3.0, 7.0, 7.0], [1, 0, 0], [0, 0, 0]),
}


def _nstep_both(arrays, gamma):
    jb, jboot = jax.jit(lambda s: jddpg.nstep_batch(s, gamma))(
        JTransition(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    tb, tboot = tddpg.nstep_batch(
        OffPolicyTransition(**{k: torch.from_numpy(v) for k, v in arrays.items()}), gamma)
    return jb, jboot, tb, tboot


@pytest.mark.parametrize("case", sorted(NSTEP_CASES))
def test_nstep_batch_window_cases(case):
    jb, jboot, tb, tboot = _nstep_both(_seq(*NSTEP_CASES[case], 3), 0.9)
    for name in OffPolicyTransition._fields:
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(tboot.numpy(), np.asarray(jboot))
    # tests/test_ddpg.py's expectations, on the port.
    g = 0.9
    expect = {"no_done": (1.0 + g * 2.0 + g * g * 4.0, 12.0, 0.0, g ** 3),
              "terminates_mid_window": (1.0 + g * 2.0, 11.0, 1.0, g ** 2),
              "truncates_first_step": (3.0, 10.0, 0.0, g)}[case]
    assert np.isclose(float(tb.reward[0]), expect[0])
    assert float(tb.next_obs[0, 0]) == expect[1] and float(tb.terminated[0]) == expect[2]
    assert np.isclose(float(tboot[0]), expect[3])
    assert float(tb.obs[0, 0]) == 0.0 and float(tb.action[0, 0]) == 0.5


@pytest.mark.parametrize("n", [2, 5, 16])
def test_nstep_batch_random_windows(n):
    """256 random windows, dones anywhere (several in one window: argmax
    takes the first), rewards bit for bit up to the sum's order, the
    discount γ^m bit for bit."""
    rng = np.random.default_rng(n)
    B = 256
    arrays = dict(
        obs=rng.normal(size=(B, n, 3)).astype(np.float32),
        action=rng.uniform(-1, 1, (B, n, 2)).astype(np.float32),
        reward=rng.normal(size=(B, n)).astype(np.float32),
        next_obs=rng.normal(size=(B, n, 3)).astype(np.float32),
        terminated=(rng.random((B, n)) < 0.15).astype(np.float32),
        done=(rng.random((B, n)) < 0.3).astype(np.float32),
    )
    jb, jboot, tb, tboot = _nstep_both(arrays, 0.99)
    for name in ("obs", "action", "next_obs", "terminated", "done"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tb.reward.numpy(), np.asarray(jb.reward), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tboot.numpy(), np.asarray(jboot))
