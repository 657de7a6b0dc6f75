"""The port's IMPALA/A3C trainer (`actor_critic_tpu_torch.algos.impala`) and
its RMSProp against the JAX package's `algos/impala.py` and optax, on
inputs made with numpy from a seed; then the trainer's staleness semantics
and its learning checks on the two-state MDP (tests/test_impala.py's).

Tolerances, with their reasons:
- loss, aux metrics and grads: 1e-5 (atol and rtol), as in
  tests/test_torch_a2c.py: float32 convolutions, dense products and means
  over a few hundred frames, summed in another order by XLA and PyTorch;
  V-trace adds the last-bit difference of the two frameworks' exp.
- parameters after an optimizer step: atol 1e-5·lr, rtol 1e-6. RMSProp
  moves each parameter by lr·g·rsqrt(nu + 0.1), at most ~3.2·lr·|g|, so a
  last-bit difference in g stays far below the tolerance; it is stated in
  units of lr as for Adam.
- the RMSProp second moments: 1e-6, elementwise float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import common as jcommon
from actor_critic_tpu.algos import impala as jimpala
from actor_critic_tpu.envs import make_pong as make_jax_pong
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import common as tcommon
from actor_critic_tpu_torch.algos import impala as timpala
from actor_critic_tpu_torch.envs import make_pong, make_two_state_mdp

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
ELEM_TOL = dict(rtol=1e-6, atol=1e-6)
SIZE, T, E = 36, 4, 4


def _param_tol(lr):
    return dict(rtol=1e-6, atol=1e-5 * lr)


def _jax_net_and_params(jcfg, seed):
    jnet = jimpala.make_network(make_jax_pong(size=SIZE), jcfg)
    return jnet, jnet.init(jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 2), jnp.uint8))


def _torch_net(cfg, params):
    net = timpala.make_network(make_pong(size=SIZE), cfg)
    net.load_state_dict(weights.from_flax(jax.device_get(params)))
    return net


def _pixel_traj(seed):
    """A fixed [T, E] pixel trajectory with terminations, truncations and
    behaviour log-probs away from the learner's (so ρ is not 1)."""
    rng = np.random.default_rng(seed)
    frames = lambda *shape: np.where(rng.random(shape) < 0.06, 255, 0).astype(np.uint8)
    done = (rng.random((T, E)) < 0.3).astype(np.float32)
    b = dict(
        obs=frames(T, E, SIZE, SIZE, 2),
        action=rng.integers(0, 3, size=(T, E)).astype(np.int32),
        log_prob=(np.log(1 / 3) + rng.normal(scale=0.4, size=(T, E))).astype(np.float32),
        value=rng.normal(size=(T, E)).astype(np.float32),
        reward=rng.choice([-1.0, 0.0, 0.0, 1.0], size=(T, E)).astype(np.float32),
        done=done,
        terminated=(done * (rng.random((T, E)) < 0.5)).astype(np.float32),
        final_obs=frames(T, E, SIZE, SIZE, 2),
    )
    return b, frames(E, SIZE, SIZE, 2)


def _scale_policy(params, k):
    """Sharpen the policy head so log-probs and ρ vary across actions."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * k if "policy" in jax.tree_util.keystr(path) else x, params)


def _flat_grads(grads):
    return {k: v.numpy() for k, v in weights.from_flax(jax.device_get(grads)).items()}


CORRECTIONS = [dict(correction="vtrace"), dict(correction="vtrace", lam=0.9, c_bar=2.0),
               dict(correction="none", lam=0.95)]


@pytest.mark.parametrize("kw", CORRECTIONS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_impala_loss_aux_and_grads_match_jax(kw):
    jcfg, cfg = jimpala.ImpalaConfig(num_envs=E, rollout_steps=T, **kw), \
        timpala.ImpalaConfig(num_envs=E, rollout_steps=T, **kw)
    jnet, params = _jax_net_and_params(jcfg, seed=1)
    params = _scale_policy(params, 60.0)
    tnet = _torch_net(cfg, params)
    b, boot = _pixel_traj(seed=2)

    jtraj = jcommon.Transition(**{k: jnp.asarray(v) for k, v in b.items()})
    (jloss, jaux), jgrads = jax.value_and_grad(jimpala.impala_loss, has_aux=True)(
        params, jnet.apply, jtraj, jnp.asarray(boot), jcfg, True)
    ttraj = tcommon.Transition(**{k: torch.from_numpy(v) for k, v in b.items()})
    tloss, taux = timpala.impala_loss(tnet, ttraj, torch.from_numpy(boot), cfg, True)
    tparams = dict(tnet.named_parameters())
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss, list(tparams.values()))))

    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **GRAD_TOL, err_msg=k)
    if kw["correction"] == "vtrace":
        assert 0.0 < float(taux["mean_rho"]) < 0.99  # the ratios were exercised
    jg = _flat_grads(jgrads)
    assert sorted(jg) == sorted(tgrads)
    for k in jg:
        np.testing.assert_allclose(tgrads[k].numpy(), jg[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("kw", CORRECTIONS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_update_matches_jax(kw):
    """One full learner update (loss → grads → clip + RMSProp), the port's
    `update` against the JAX update as `make_train_step` composes it, from
    one set of parameters and one trajectory; with k=1 the actors then hold
    the new parameters."""
    kw = dict(num_envs=E, rollout_steps=T, lr=1e-3, actor_refresh_every=1, **kw)
    jcfg, cfg = jimpala.ImpalaConfig(**kw), timpala.ImpalaConfig(**kw)
    jnet, params = _jax_net_and_params(jcfg, seed=3)
    params = _scale_policy(params, 60.0)
    b, boot = _pixel_traj(seed=4)

    jtraj = jcommon.Transition(**{k: jnp.asarray(v) for k, v in b.items()})
    (_, jmetrics), grads = jax.value_and_grad(jimpala.impala_loss, has_aux=True)(
        params, jnet.apply, jtraj, jnp.asarray(boot), jcfg, True)
    jopt = jimpala.make_optimizer(jcfg)
    updates, _ = jopt.update(grads, jopt.init(params), params)
    new_params = jax.tree.map(lambda p, u: p + u, params, updates)

    tenv = make_pong(size=SIZE)
    tnet = _torch_net(cfg, params)
    topt = timpala.make_optimizer(cfg)
    state = timpala.ImpalaTrainState(
        net=tnet,
        opt_state=topt.init(dict(tnet.named_parameters())),
        rollout=tcommon.RolloutState(env_state=None, obs=torch.from_numpy(boot)),
        generator=torch.Generator(),
        ep_return=torch.zeros(E), ep_length=torch.zeros(E), avg_return=torch.zeros(()),
        step_counter=torch.zeros(1, dtype=torch.int64),
        actor_net=_torch_net(cfg, params),
    )
    ttraj = tcommon.Transition(**{k: torch.from_numpy(v) for k, v in b.items()})
    tmetrics = timpala.update(tenv, cfg, topt, state, ttraj)

    assert state.update_step == 1
    for k in ("loss", "pg_loss", "v_loss", "entropy", "mean_rho"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), **GRAD_TOL, err_msg=k)
    got = dict(tnet.named_parameters())
    want = weights.from_flax(jax.device_get(new_params))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), **_param_tol(cfg.lr),
                                   err_msg=k)
    actor = dict(state.actor_net.named_parameters())
    assert all(torch.equal(actor[k], got[k]) for k in got)
    old = weights.from_flax(jax.device_get(params))
    assert not np.allclose(got["torso.conv_0.weight"].detach().numpy(),
                           old["torso.conv_0.weight"].numpy())


@pytest.mark.parametrize("clip", ["taken", "not-taken"])
def test_rmsprop_steps_match_optax(clip):
    """Two steps of clip_by_global_norm + RMSProp(eps inside the root) on
    the pixel net's parameters (convolutions included)."""
    lr = 6e-4
    max_grad_norm = 40.0 if clip == "taken" else 1e6
    jcfg = jimpala.ImpalaConfig(lr=lr, max_grad_norm=max_grad_norm)
    cfg = timpala.ImpalaConfig(lr=lr, max_grad_norm=max_grad_norm)
    _, params = _jax_net_and_params(jcfg, seed=5)
    tnet = _torch_net(cfg, params)
    jopt, topt = jimpala.make_optimizer(jcfg), timpala.make_optimizer(cfg)
    jstate = jopt.init(params)
    tparams = dict(tnet.named_parameters())
    tstate = topt.init(tparams)
    rng = np.random.default_rng(6)
    for step in range(2):
        gnp = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        g_norm = float(np.sqrt(sum(np.sum(x**2) for x in jax.tree.leaves(gnp))))
        assert (g_norm >= max_grad_norm) == (clip == "taken")
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, gnp), jstate, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        topt.step(tparams, weights.from_flax(gnp), tstate)
        for k, v in weights.from_flax(jax.device_get(params)).items():
            np.testing.assert_allclose(tparams[k].detach().numpy(), v.numpy(),
                                       **_param_tol(lr), err_msg=f"step {step} {k}")
        conv = weights.rmsprop_state_from_optax(jax.device_get(jstate))
        assert sorted(conv.nu) == sorted(tstate.nu)
        for k in conv.nu:
            np.testing.assert_allclose(tstate.nu[k].numpy(), conv.nu[k].numpy(), **ELEM_TOL)


def test_rmsprop_puts_eps_inside_the_root():
    """The first step from nu = 0 moves p by lr·g/√(0.01·g² + eps); torch's
    RMSprop (eps outside the root) would move it by lr·g/(0.1·|g| + eps)."""
    cfg = timpala.ImpalaConfig(lr=0.1, max_grad_norm=1e9)
    p = {"w": torch.zeros(3)}
    g = {"w": torch.tensor([0.5, -2.0, 10.0])}
    opt = timpala.make_optimizer(cfg)
    opt.step(p, g, opt.init(p))
    want = -0.1 * g["w"] / torch.sqrt(0.01 * g["w"] ** 2 + 0.1)
    torch.testing.assert_close(p["w"], want, rtol=1e-6, atol=0.0)


def test_rmsprop_state_from_optax_rejects_adam_state():
    import optax

    state = optax.adam(1e-3).init({"w": jnp.zeros(2)})
    with pytest.raises(ValueError, match="RMSProp"):
        weights.rmsprop_state_from_optax(jax.device_get(state))


# ------------------------------------------------ staleness and learning


def test_on_policy_rhos_are_one():
    """With actor_refresh_every=1 the behaviour policy equals the learner's
    at rollout time, so every clipped ρ is exactly 1."""
    env = make_two_state_mdp()
    cfg = timpala.ImpalaConfig(num_envs=4, rollout_steps=8, hidden=(16,), actor_refresh_every=1)
    state = timpala.init_state(env, cfg, seed=0, device="cpu")
    step = timpala.make_train_step(env, cfg)
    for _ in range(2):  # still in sync after the refresh
        state, metrics = step(state)
        assert float(metrics["mean_rho"]) == 1.0


def test_staleness_refresh_schedule():
    """actor_refresh_every=3: the actors lag the learner until step 3."""
    env = make_two_state_mdp()
    cfg = timpala.ImpalaConfig(num_envs=4, rollout_steps=4, hidden=(16,), actor_refresh_every=3)
    state = timpala.init_state(env, cfg, seed=0, device="cpu")
    step = timpala.make_train_step(env, cfg)

    def in_sync():
        a = dict(state.actor_net.named_parameters())
        return all(torch.equal(a[k], p) for k, p in state.net.named_parameters())

    assert in_sync()
    for i in (1, 2, 3, 4, 5, 6):
        state, metrics = step(state)
        assert in_sync() == (i % 3 == 0), i
        # The lagging actors make the ratios differ from 1 after the first
        # update of each window.
        if i % 3 != 1:
            assert float(metrics["mean_rho"]) != 1.0, i
    assert not any(p.requires_grad for p in state.actor_net.parameters())


def _greedy_probs_and_values(state):
    with torch.no_grad():
        dist, values = state.net(torch.eye(2))
    return torch.softmax(dist.logits, -1), values


def test_impala_learns_two_state_mdp():
    """IMPALA with a 2-step policy lag still converges on the analytic MDP
    (V-trace corrects the off-policyness)."""
    env = make_two_state_mdp()
    cfg = timpala.ImpalaConfig(num_envs=16, rollout_steps=8, hidden=(32,), lr=3e-3,
                               actor_refresh_every=2, entropy_coef=0.001)
    state, _ = timpala.train(env, cfg, num_iterations=800, seed=0, device="cpu")
    probs, values = _greedy_probs_and_values(state)
    # Action 1 is optimal in both states (reward 1 forever).
    assert float(probs[0, 1]) > 0.8 and float(probs[1, 1]) > 0.8, probs
    # The critic heads toward V* = 1/(1-γ) = 100.
    assert 50.0 < float(values[0]) <= 110.0, values


def test_a3c_mode_learns_two_state_mdp():
    env = make_two_state_mdp()
    cfg = timpala.ImpalaConfig(num_envs=16, rollout_steps=8, hidden=(32,), lr=3e-3,
                               correction="none", actor_refresh_every=2, entropy_coef=0.001,
                               lam=0.95)
    state, _ = timpala.train(env, cfg, num_iterations=400, seed=0, device="cpu")
    probs, _ = _greedy_probs_and_values(state)
    assert float(probs[0, 1]) > 0.8 and float(probs[1, 1]) > 0.8, probs


def test_pixel_train_runs_on_cpu():
    """The CNN path end to end at a tiny size on the CPU: finite metrics,
    one update per iteration, a finite greedy eval."""
    env = make_pong(size=36, points_to_win=1, max_steps=16)
    cfg = timpala.ImpalaConfig(num_envs=2, rollout_steps=4, actor_refresh_every=2)
    state, metrics = timpala.train(env, cfg, 3, seed=0, device="cpu")
    assert state.update_step == 3
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert 0.0 < float(metrics["mean_rho"]) <= 1.0
    ev = timpala.make_eval_fn(env, cfg)(state, torch.Generator().manual_seed(1), 2, 20)
    assert np.isfinite(float(ev))


def test_config_validation_and_unported_options():
    with pytest.raises(ValueError):
        timpala.ImpalaConfig(correction="bogus")
    with pytest.raises(ValueError):
        timpala.ImpalaConfig(actor_refresh_every=0)
    # bf16 compute is ported: the flag builds the bf16 network.
    net = timpala.make_network(make_pong(size=36), dataclasses.replace(
        timpala.ImpalaConfig(), bf16_compute=True))
    assert net.compute_dtype == net.torso.compute_dtype == torch.bfloat16
