"""The port's A2C pieces against the JAX package's `algos/a2c.py` and
`algos/common.py`, on inputs made with numpy from a seed.

Tolerances, with their reasons:
- loss, aux metrics and grads: 1e-5 (atol and rtol). Float32 reductions
  over a few hundred samples, summed in another order by XLA and PyTorch.
- parameters after an optimizer step: atol 1e-5·lr, rtol 1e-6. Adam's
  early steps move each parameter by about lr·g/|g|, so a grad element
  near 0 (|g| close to eps = 1e-8) would turn a last-bit difference in g
  into a visible fraction of lr; the tolerance is stated in units of lr
  for that reason. On these seeds the parameters differ by at most one
  float32 ulp (4.7e-10, 20× inside the tolerance at lr = 1e-3).
- episode accounting and bootstrapped rewards: 1e-6, elementwise float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import a2c as ja2c
from actor_critic_tpu.algos import common as jcommon
from actor_critic_tpu.envs import make_cartpole as make_jax_cartpole
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import a2c as ta2c
from actor_critic_tpu_torch.algos import common as tcommon
from actor_critic_tpu_torch.algos.metrics import aggregate_metrics
from actor_critic_tpu_torch.envs import make_cartpole

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)


def _param_tol(lr):
    return dict(rtol=1e-6, atol=1e-5 * lr)


def _jax_net_and_params(cfg, seed=0):
    net = ja2c.make_network(make_jax_cartpole(), cfg)
    return net, net.init(jax.random.key(seed), jnp.zeros((1, 4), jnp.float32))


def _torch_net(cfg, params):
    net = ta2c.make_network(make_cartpole(), cfg)
    net.load_state_dict(weights.from_flax(jax.device_get(params)))
    return net


def _batch(T, E, seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.normal(size=(T, E, 4)).astype(np.float32),
        action=rng.integers(0, 2, size=(T, E)).astype(np.int32),
        log_prob=np.full((T, E), -0.69, np.float32),
        value=rng.normal(size=(T, E)).astype(np.float32),
        reward=np.ones((T, E), np.float32),
        done=(rng.random((T, E)) < 0.1).astype(np.float32),
        terminated=np.zeros((T, E), np.float32),
        final_obs=rng.normal(size=(T, E, 4)).astype(np.float32),
    )


def _jtraj(b):
    return jcommon.Transition(**{k: jnp.asarray(v) for k, v in b.items()})


def _ttraj(b):
    return tcommon.Transition(**{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


def _flat_grads_flax(grads):
    g = jax.device_get(grads)
    return {k: v.numpy() for k, v in weights.from_flax(g).items()}


@pytest.mark.parametrize("normalize_adv,huber,entropy_coef", [
    (False, 0.0, None), (True, 0.0, None), (False, 5.0, None), (False, 0.0, 0.0037),
])
def test_loss_aux_and_grads_match_jax(normalize_adv, huber, entropy_coef):
    cfg = ta2c.A2CConfig(normalize_adv=normalize_adv, value_huber_delta=huber)
    jcfg = ja2c.A2CConfig(normalize_adv=normalize_adv, value_huber_delta=huber)
    jnet, params = _jax_net_and_params(jcfg, seed=1)
    tnet = _torch_net(cfg, params)
    b = _batch(8, 16, seed=2)
    rng = np.random.default_rng(3)
    adv = rng.normal(size=(8, 16)).astype(np.float32)
    # Returns far from the values, so the Huber branch clips some samples.
    ret = (rng.normal(size=(8, 16)) * 8.0).astype(np.float32)

    jec = None if entropy_coef is None else jnp.asarray(entropy_coef, jnp.float32)
    (jloss, jaux), jgrads = jax.value_and_grad(ja2c.a2c_loss, has_aux=True)(
        params, jnet.apply, _jtraj(b), jnp.asarray(adv), jnp.asarray(ret), jcfg, None, jec)
    tloss, taux = ta2c.a2c_loss(
        tnet, _ttraj(b), torch.from_numpy(adv), torch.from_numpy(ret), cfg, entropy_coef)
    tparams = dict(tnet.named_parameters())
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss, list(tparams.values()))))

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **GRAD_TOL, err_msg=k)
    jg = _flat_grads_flax(jgrads)
    assert sorted(jg) == sorted(tgrads)
    for k in jg:
        np.testing.assert_allclose(tgrads[k].numpy(), jg[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("clip", ["taken", "not-taken"])
def test_optimizer_steps_match_optax(clip):
    """Two steps of clip_by_global_norm + Adam under the linear lr schedule:
    the schedule is read at count 0, then 1."""
    lr = 3e-3
    max_grad_norm = 0.5 if clip == "taken" else 1e6
    kw = dict(lr=lr, anneal_iters=10, lr_final=0.0, max_grad_norm=max_grad_norm)
    jcfg, cfg = ja2c.A2CConfig(**kw), ta2c.A2CConfig(**kw)
    _, params = _jax_net_and_params(jcfg, seed=4)
    tnet = _torch_net(cfg, params)
    jopt, topt = ja2c.make_optimizer(jcfg), ta2c.make_optimizer(cfg)
    jstate = jopt.init(params)
    tparams = dict(tnet.named_parameters())
    tstate = topt.init(tparams)
    rng = np.random.default_rng(5)
    for step in range(2):
        gnp = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        g_norm = float(np.sqrt(sum(np.sum(x**2) for x in jax.tree.leaves(gnp))))
        assert (g_norm >= max_grad_norm) == (clip == "taken")
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, gnp), jstate, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        topt.step(tparams, {k: v for k, v in weights.from_flax(gnp).items()}, tstate,
                  torch.from_numpy(topt.scalar_table()))
        for k, v in weights.from_flax(jax.device_get(params)).items():
            np.testing.assert_allclose(tparams[k].detach().numpy(), v.numpy(),
                                       **_param_tol(lr), err_msg=f"step {step} {k}")
        # The moments and count carry across too.
        conv = weights.adam_state_from_optax(jax.device_get(jstate))
        assert int(conv.count) == int(tstate.count) == step + 1
        for k in conv.mu:
            np.testing.assert_allclose(tstate.mu[k].numpy(), conv.mu[k].numpy(), **ELEM_TOL)
            np.testing.assert_allclose(tstate.nu[k].numpy(), conv.nu[k].numpy(), **ELEM_TOL)


@pytest.mark.parametrize("count", [0, 1, 7, 10, 15])
def test_schedules_match_jax(count):
    import optax

    kw = dict(lr=3e-3, anneal_iters=10, lr_final=0.0, entropy_coef=0.01,
              entropy_coef_final=0.0)
    jcfg, cfg = ja2c.A2CConfig(**kw), ta2c.A2CConfig(**kw)
    from actor_critic_tpu_torch.optim import linear_schedule

    assert linear_schedule(3e-3, 0.0, 10)(count) == float(
        optax.linear_schedule(3e-3, 0.0, 10)(jnp.asarray(count, jnp.int32)))
    assert ta2c.entropy_coef_at(cfg, count) == float(
        ja2c.entropy_coef_at(jcfg, jnp.asarray(count, jnp.int32)))
    # Annealing off: the constant initial value.
    assert ta2c.entropy_coef_at(ta2c.A2CConfig(), count) == 0.01
    assert tcommon.anneal_fraction(count, 0) is None


def test_truncation_bootstrap_and_episode_metrics_match_jax():
    b = _batch(16, 32, seed=6)
    b["terminated"] = (b["done"] * (np.random.default_rng(7).random((16, 32)) < 0.5)).astype(np.float32)
    b["reward"] = np.random.default_rng(8).random((16, 32)).astype(np.float32)
    fv = np.random.default_rng(9).normal(size=(16, 32)).astype(np.float32)
    jr = jcommon.truncation_bootstrap_rewards(_jtraj(b), jnp.asarray(fv), 0.99)
    tr = tcommon.truncation_bootstrap_rewards(_ttraj(b), torch.from_numpy(fv), 0.99)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **ELEM_TOL)

    rng = np.random.default_rng(10)
    ep_ret = rng.random(32).astype(np.float32) * 10
    ep_len = rng.integers(0, 20, 32).astype(np.float32)
    j = jcommon.episode_metrics_update(
        jnp.asarray(ep_ret), jnp.asarray(ep_len), jnp.asarray(3.0), _jtraj(b))
    t = tcommon.episode_metrics_update(
        torch.from_numpy(ep_ret), torch.from_numpy(ep_len), torch.tensor(3.0), _ttraj(b))
    for a, w in zip(t[:3], j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **ELEM_TOL)
    for k in j[3]:
        np.testing.assert_allclose(float(t[3][k]), float(j[3][k]), rtol=1e-6, err_msg=k)
    agg = aggregate_metrics({"loss": torch.tensor(1.0)}, t[3])
    assert float(agg["mean_finished_return"]) == pytest.approx(
        float(j[3]["finished_return_sum"]) / float(j[3]["episodes_finished"]), rel=1e-6)


def test_update_matches_jax_on_jax_rollout():
    """Slice-level parity: JAX's own `rollout_scan` collects a batch at
    E=16, T=8; the JAX update (composed here from `gae_targets`,
    `a2c_loss` and `make_optimizer`, as `make_train_step` does) and the
    port's `update` take the same Transition and the same parameters, and
    give the same new parameters and loss metrics."""
    kw = dict(num_envs=16, rollout_steps=8, lr=1e-3, anneal_iters=10, lr_final=0.0,
              entropy_coef=0.01, entropy_coef_final=0.0)
    jcfg, cfg = ja2c.A2CConfig(**kw), ta2c.A2CConfig(**kw)
    jenv, tenv = make_jax_cartpole(), make_cartpole()
    jstate = ja2c.init_state(jenv, jcfg, jax.random.key(0))
    jnet = ja2c.make_network(jenv, jcfg)
    # Long enough episodes that the batch holds terminations.
    new_rollout, jtraj = jcommon.rollout_scan(
        jenv, jnet.apply, jstate.params, jstate.rollout, jax.random.key(1), 8)
    for _ in range(2):
        new_rollout, jtraj = jcommon.rollout_scan(
            jenv, jnet.apply, jstate.params, new_rollout, jax.random.key(2), 8)
    assert float(jnp.sum(jtraj.done)) > 0

    # --- the JAX update, as make_train_step composes it ---
    apply = jnet.apply
    params = jstate.params
    _, boot = apply(params, new_rollout.obs)
    _, fv = apply(params, jtraj.final_obs.reshape(8 * 16, 4))
    rewards = jcommon.truncation_bootstrap_rewards(jtraj, fv.reshape(8, 16), jcfg.gamma)
    adv, ret = jcommon.gae_targets(rewards, jtraj.value, jtraj.done, boot,
                                   jcfg.gamma, jcfg.gae_lambda)
    (_, jmetrics), grads = jax.value_and_grad(ja2c.a2c_loss, has_aux=True)(
        params, apply, jtraj, adv, ret, jcfg, None, ja2c.entropy_coef_at(jcfg, jstate.update_step))
    opt = ja2c.make_optimizer(jcfg)
    updates, _ = opt.update(grads, jstate.opt_state, params)
    new_params = jax.tree.map(lambda p, u: p + u, params, updates)

    # --- the port's update on the same Transition ---
    tnet = _torch_net(cfg, params)
    topt = ta2c.make_optimizer(cfg)
    tstate = tcommon.TrainState(
        net=tnet,
        opt_state=topt.init(dict(tnet.named_parameters())),
        rollout=tcommon.RolloutState(env_state=None,
                                     obs=torch.from_numpy(np.array(new_rollout.obs))),
        generator=torch.Generator(),
        ep_return=torch.zeros(16), ep_length=torch.zeros(16), avg_return=torch.zeros(()),
        step_counter=torch.zeros(1, dtype=torch.int64), schedule=ta2c.make_schedule(cfg),
    )
    ttraj = tcommon.Transition(*(torch.from_numpy(np.array(x)) for x in jtraj))
    tmetrics = ta2c.update(tenv, cfg, topt, tstate, ttraj)

    assert tstate.update_step == 1
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), **GRAD_TOL, err_msg=k)
    got = dict(tnet.named_parameters())
    for k, v in weights.from_flax(jax.device_get(new_params)).items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   **_param_tol(cfg.lr), err_msg=k)
    # And the parameters did move.
    moved = weights.from_flax(jax.device_get(params))
    assert not np.allclose(got["policy.weight"].detach().numpy(), moved["policy.weight"].numpy())


def test_train_runs_on_cpu_and_counts_steps():
    """The whole loop at a tiny size on the CPU: finite metrics, one
    optimizer step per iteration, logs on the first and last iteration."""
    cfg = ta2c.A2CConfig(num_envs=8, rollout_steps=4)
    rows = []
    state, metrics = ta2c.train(make_cartpole(), cfg, 3, seed=0, device="cpu",
                                log_fn=lambda it, m: rows.append((it, m)))
    assert [it for it, _ in rows] == [1, 3]
    assert state.update_step == 3 and int(state.opt_state.count) == 3
    assert all(np.isfinite(float(v)) for v in metrics.values())
    ev = ta2c.make_eval_fn(make_cartpole(), cfg)(state, torch.Generator().manual_seed(1), 4, 50)
    assert 1.0 <= float(ev) <= 50.0


@pytest.mark.parametrize("action_dim", [1, 2])
def test_gaussian_loss_aux_and_grads_match_jax(action_dim):
    """A2C on continuous actions (`--algo a2c --env jax:pendulum`): the
    Gaussian net of `make_network` with the JAX net's params converted by
    `weights.from_flax`, the same loss, aux metrics and grads at 1e-5."""
    from actor_critic_tpu.envs import make_point_mass as make_jax_point_mass
    from actor_critic_tpu.envs import make_pendulum as make_jax_pendulum
    from actor_critic_tpu_torch.envs import make_pendulum, make_point_mass

    jenv, tenv = ((make_jax_pendulum(), make_pendulum()) if action_dim == 1
                  else (make_jax_point_mass(), make_point_mass()))
    obs_dim = jenv.spec.obs_shape[0]
    cfg, jcfg = ta2c.A2CConfig(), ja2c.A2CConfig()
    jnet = ja2c.make_network(jenv, jcfg)
    params = jnet.init(jax.random.key(4), jnp.zeros((1, obs_dim), jnp.float32))
    tnet = ta2c.make_network(tenv, cfg)
    assert type(tnet).__name__ == "ActorCriticGaussian"
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    T, E = 8, 16
    rng = np.random.default_rng(5)
    b = _batch(T, E, seed=6)
    b["obs"] = rng.normal(size=(T, E, obs_dim)).astype(np.float32)
    b["final_obs"] = rng.normal(size=(T, E, obs_dim)).astype(np.float32)
    b["action"] = rng.normal(size=(T, E, jenv.spec.action_dim)).astype(np.float32)
    adv = rng.normal(size=(T, E)).astype(np.float32)
    ret = rng.normal(size=(T, E)).astype(np.float32)
    (jloss, jaux), jgrads = jax.value_and_grad(ja2c.a2c_loss, has_aux=True)(
        params, jnet.apply, _jtraj(b), jnp.asarray(adv), jnp.asarray(ret), jcfg)
    tloss, taux = ta2c.a2c_loss(tnet, _ttraj(b), torch.from_numpy(adv), torch.from_numpy(ret), cfg)
    tparams = dict(tnet.named_parameters())
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss, list(tparams.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **GRAD_TOL, err_msg=k)
    jg = _flat_grads_flax(jgrads)
    assert sorted(jg) == sorted(tgrads)
    for k in jg:
        np.testing.assert_allclose(tgrads[k].numpy(), jg[k], **GRAD_TOL, err_msg=k)
