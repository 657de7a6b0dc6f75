"""The port's PPO trainer (`actor_critic_tpu_torch.algos.ppo`) against the
JAX package's `algos/ppo.py`, on inputs made with numpy from a seed: the
clipped surrogate's edge cases (tests/test_ppo.py's), the loss and its
gradients, `ppo_update` fed the permutations JAX draws, and the update half
of a train step on a JAX rollout; then the learning checks of
tests/test_ppo.py.

Tolerances, with their reasons:
- loss, aux metrics and grads: atol 1e-6, rtol 1e-5. Float32 means over
  64 samples, summed in another order by XLA and PyTorch.
- parameters and Adam moments after the updates: atol 1e-6, rtol 1e-5.
  Adam (eps 1e-5) moves a parameter by at most ~lr per step, so a
  last-bit difference in a grad moves it by ~lr·1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import common as jcommon
from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu.envs import make_cartpole as make_jax_cartpole
from actor_critic_tpu.envs.jax_env import EnvSpec as JaxEnvSpec
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import common as tcommon
from actor_critic_tpu_torch.algos import ppo as tppo
from actor_critic_tpu_torch.envs import EnvSpec, make_cartpole, make_point_mass, make_two_state_mdp

TOL = dict(rtol=1e-5, atol=1e-6)
OBS_DIM, NUM_ACTIONS, ACTION_DIM = 4, 3, 2


def _specs(discrete):
    action_dim = NUM_ACTIONS if discrete else ACTION_DIM
    return (JaxEnvSpec(obs_shape=(OBS_DIM,), action_dim=action_dim, discrete=discrete),
            EnvSpec(obs_shape=(OBS_DIM,), action_dim=action_dim, discrete=discrete))


def _nets(discrete, cfg_kw, seed=0):
    """The JAX net and params, the port's net with the converted params."""
    jspec, tspec = _specs(discrete)
    jcfg, cfg = jppo.PPOConfig(**cfg_kw), tppo.PPOConfig(**cfg_kw)
    jnet = jppo.make_network(jspec, jcfg)
    params = jnet.init(jax.random.key(seed), jnp.zeros((1, OBS_DIM), jnp.float32))
    tnet = tppo.make_network(tspec, cfg)
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    return jnet, params, tnet, jcfg, cfg


def _batch(discrete, B, seed):
    """A random batch; the old log-probs spread so that some ratios clip."""
    rng = np.random.default_rng(seed)
    if discrete:
        action = rng.integers(0, NUM_ACTIONS, size=B).astype(np.int32)
        log_prob_old = (np.log(1.0 / NUM_ACTIONS) + 0.3 * rng.normal(size=B)).astype(np.float32)
    else:
        action = rng.normal(size=(B, ACTION_DIM)).astype(np.float32)
        log_prob_old = (-2.0 + 0.5 * rng.normal(size=B)).astype(np.float32)
    return dict(
        obs=rng.normal(size=(B, OBS_DIM)).astype(np.float32),
        action=action,
        log_prob_old=log_prob_old,
        value_old=rng.normal(size=B).astype(np.float32),
        advantage=rng.normal(size=B).astype(np.float32),
        ret=(2.0 * rng.normal(size=B)).astype(np.float32),
    )


def _jbatch(b):
    return jppo.PPOBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def _tbatch(b):
    return tppo.PPOBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


def _flat(tree):
    return {k: v.numpy() for k, v in weights.from_flax(jax.device_get(tree)).items()}


# --- tests/test_ppo.py's clip-edge and value-clip cases on the port ---


class _FakeDist:
    """log_prob = theta broadcast over the actions, zero entropy."""

    def __init__(self, lp):
        self._lp = lp

    def log_prob(self, a):
        return self._lp.expand(a.shape)

    def entropy(self):
        return torch.zeros(())


def _const_batch(B=8):
    return tppo.PPOBatch(
        obs=torch.zeros((B, 2)),
        action=torch.zeros((B,), dtype=torch.int32),
        log_prob_old=torch.zeros((B,)),
        value_old=torch.zeros((B,)),
        advantage=torch.ones((B,)),
        ret=torch.zeros((B,)),
    )


def _loss_and_grad(theta, batch, cfg):
    th = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    net = lambda obs: (_FakeDist(th), torch.zeros(obs.shape[0]))
    loss, _ = tppo.ppo_loss(net, batch, cfg)
    (g,) = torch.autograd.grad(loss, [th])
    return float(loss.detach()), float(g)


def test_ppo_loss_clip_edges():
    cfg = tppo.PPOConfig(clip_eps=0.2, normalize_adv=False, vf_clip=0.0,
                         entropy_coef=0.0, value_coef=0.0)
    batch = _const_batch()
    # Positive advantage, ratio 1.5 > 1 + eps: clipped, no gradient, loss -1.2.
    loss, g = _loss_and_grad(np.log(1.5), batch, cfg)
    np.testing.assert_allclose(g, 0.0, atol=1e-6)
    np.testing.assert_allclose(loss, -1.2, rtol=1e-5)
    # Inside the clip band the gradient flows: d/dθ of -e^θ is -ratio.
    _, g_in = _loss_and_grad(np.log(1.1), batch, cfg)
    np.testing.assert_allclose(g_in, -1.1, rtol=1e-5)
    # Negative advantage, ratio 0.5 < 1 - eps: clipped, no gradient, loss 0.8.
    neg = batch._replace(advantage=-torch.ones(8))
    loss, g = _loss_and_grad(np.log(0.5), neg, cfg)
    np.testing.assert_allclose(g, 0.0, atol=1e-6)
    np.testing.assert_allclose(loss, 0.8, rtol=1e-5)


def test_ppo_value_clip():
    cfg = tppo.PPOConfig(vf_clip=0.1, normalize_adv=False, entropy_coef=0.0,
                         value_coef=1.0, clip_eps=0.2)
    batch = _const_batch()._replace(ret=torch.ones(8), advantage=torch.zeros(8))
    net = lambda obs: (_FakeDist(torch.zeros(())), torch.full((obs.shape[0],), 0.5))
    # v = 0.5 is clipped to 0.1: loss = 0.5·max((0.5-1)², (0.1-1)²) = 0.5·0.81.
    loss, _ = tppo.ppo_loss(net, batch, cfg)
    np.testing.assert_allclose(float(loss), 0.5 * 0.81, rtol=1e-5)


# --- parity with the JAX package ---


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "gaussian"])
@pytest.mark.parametrize("normalize_adv", [True, False], ids=["norm-adv", "raw-adv"])
def test_ppo_loss_aux_and_grads_match_jax(discrete, normalize_adv):
    kw = dict(normalize_adv=normalize_adv, entropy_coef=0.01, hidden=(32, 32))
    jnet, params, tnet, jcfg, cfg = _nets(discrete, kw, seed=1)
    b = _batch(discrete, 64, seed=2)
    # Annealed coefficients, as the train step passes them (0-dim float32).
    clip_eps, ent = np.float32(0.15), np.float32(0.004)
    (jloss, jaux), jgrads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        params, jnet.apply, _jbatch(b), jcfg, None, jnp.asarray(clip_eps), jnp.asarray(ent))
    tloss, taux = tppo.ppo_loss(tnet, _tbatch(b), cfg, torch.tensor(clip_eps), torch.tensor(ent))
    tparams = dict(tnet.named_parameters())
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss, list(tparams.values()))))

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), **TOL, err_msg=k)
    assert 0.0 < float(jaux["clip_frac"]) < 1.0  # both branches of the clip are taken
    jg = _flat(jgrads)
    assert sorted(jg) == sorted(tgrads)
    for k in jg:
        np.testing.assert_allclose(tgrads[k].numpy(), jg[k], **TOL, err_msg=k)


def _jax_permutations(key, epochs, B):
    """The permutations `jppo.ppo_update` draws from `key`, as [epochs, B]."""
    return np.stack([np.asarray(jax.random.permutation(k, B))
                     for k in jax.random.split(key, epochs)])


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "gaussian"])
def test_ppo_update_matches_jax_given_its_permutations(discrete):
    """Two iterations' `ppo_update` (2 epochs × 2 minibatches each, lr,
    clip-ε and entropy annealed), the port reading its scalars from the
    schedule table (clip-ε and entropy at step counter 0 and 1, Adam's
    scalars at its count), JAX's from its optax schedule and progress; the
    port is handed JAX's permutations."""
    kw = dict(epochs=2, num_minibatches=2, hidden=(16, 16), lr=3e-3, entropy_coef=0.01,
              anneal_iters=3, lr_final=0.0, clip_eps_final=0.1, entropy_coef_final=0.0)
    jnet, params, tnet, jcfg, cfg = _nets(discrete, kw, seed=3)
    jopt, topt = jppo.make_optimizer(jcfg), tppo.make_optimizer(cfg)
    jstate = jopt.init(params)
    tstate = topt.init(dict(tnet.named_parameters()))
    schedule = tppo.make_schedule(cfg)
    steps = cfg.epochs * cfg.num_minibatches
    for it in range(2):
        b = _batch(discrete, 64, seed=10 + it)
        key = jax.random.key(20 + it)
        params, jstate, jm = jppo.ppo_update(
            params, jstate, _jbatch(b), key, jnet.apply, jopt, jcfg,
            progress=jppo.anneal_progress(jcfg, jnp.asarray(it, jnp.int32)))
        clip_eps, ent = schedule.coefficients_at(torch.tensor([it])).unbind()
        tm = tppo.ppo_update(
            tnet, topt, tstate, _tbatch(b), torch.from_numpy(_jax_permutations(key, 2, 64)), cfg,
            schedule.optimizer, clip_eps, ent)

        got = {k: p.detach().numpy() for k, p in tnet.named_parameters()}
        for k, v in _flat(params).items():
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=f"iteration {it} {k}")
        conv = weights.adam_state_from_optax(jax.device_get(jstate))
        assert int(conv.count) == int(tstate.count) == (it + 1) * steps
        for k in conv.mu:
            np.testing.assert_allclose(tstate.mu[k].numpy(), conv.mu[k].numpy(), **TOL)
            np.testing.assert_allclose(tstate.nu[k].numpy(), conv.nu[k].numpy(), **TOL)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)


def test_update_matches_jax_train_step_on_its_rollout():
    """Slice-level parity: JAX's jitted `make_train_step` runs one iteration
    at E=16, T=8 (2 epochs × 2 minibatches, annealed). Its rollout and its
    permutations are redrawn from the keys it splits; the port's `update`
    takes that rollout and those permutations from the same parameters, and
    gives the same new parameters, loss metrics and episode accounting."""
    kw = dict(num_envs=16, rollout_steps=8, epochs=2, num_minibatches=2, lr=1e-3,
              entropy_coef=0.01, anneal_iters=10, lr_final=0.0, entropy_coef_final=0.0)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    jenv, tenv = make_jax_cartpole(), make_cartpole()
    jstate = jppo.init_state(jenv, jcfg, jax.random.key(0))
    new_jstate, jmetrics = jax.jit(jppo.make_train_step(jenv, jcfg))(jstate)

    jnet = jppo.make_network(jenv.spec, jcfg)
    _, rkey, ukey = jax.random.split(jstate.key, 3)
    new_rollout, jtraj = jcommon.rollout_scan(
        jenv, jnet.apply, jstate.params, jstate.rollout, rkey, cfg.rollout_steps)
    B = cfg.num_envs * cfg.rollout_steps

    tnet = tppo.make_network(tenv.spec, cfg)
    tnet.load_state_dict(weights.from_flax(jax.device_get(jstate.params)))
    topt = tppo.make_optimizer(cfg)
    tstate = tcommon.TrainState(
        net=tnet,
        opt_state=topt.init(dict(tnet.named_parameters())),
        rollout=tcommon.RolloutState(env_state=None,
                                     obs=torch.from_numpy(np.array(new_rollout.obs))),
        generator=torch.Generator(),
        ep_return=torch.zeros(16), ep_length=torch.zeros(16), avg_return=torch.zeros(()),
        step_counter=torch.zeros(1, dtype=torch.int64), schedule=tppo.make_schedule(cfg),
    )
    ttraj = tcommon.Transition(*(torch.from_numpy(np.array(x)) for x in jtraj))
    tmetrics = tppo.update(tenv, cfg, topt, tstate, ttraj,
                           perms=torch.from_numpy(_jax_permutations(ukey, cfg.epochs, B)))

    assert tstate.update_step == 1 and int(tstate.step_counter) == 1
    assert int(tstate.opt_state.count) == cfg.epochs * cfg.num_minibatches
    assert sorted(tmetrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), **TOL, err_msg=k)
    got = {k: p.detach().numpy() for k, p in tnet.named_parameters()}
    for k, v in _flat(new_jstate.params).items():
        np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
    for name in ("ep_return", "ep_length", "avg_return"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(new_jstate, name)), **TOL, err_msg=name)


def test_permutations_are_permutations_and_seeded():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    p1, p2 = tppo.draw_permutations(g1, 3, 257), tppo.draw_permutations(g2, 3, 257)
    assert p1.shape == (3, 257) and p1.dtype == torch.int64
    assert torch.equal(p1, p2)
    for row in p1:
        assert torch.equal(torch.sort(row).values, torch.arange(257))
    assert not torch.equal(p1[0], p1[1])


def test_ppo_update_rejects_indivisible_batch():
    env = make_two_state_mdp()
    cfg = tppo.PPOConfig(num_envs=3, rollout_steps=3, num_minibatches=4, hidden=(8,))
    state = tppo.init_state(env, cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="minibatches"):
        tppo.make_train_step(env, cfg)(state)


def test_train_step_metrics_and_counters():
    """tests/test_ppo.py's shapes-and-determinism case: the same input state
    gives the same result, the metrics are finite, and one iteration counts
    one update step and epochs × minibatches optimizer steps."""
    env = make_two_state_mdp()
    cfg = tppo.PPOConfig(num_envs=8, rollout_steps=8, epochs=2, num_minibatches=4, hidden=(16,))
    results = []
    for _ in range(2):
        state = tppo.init_state(env, cfg, seed=0, device="cpu")
        state, m = tppo.make_train_step(env, cfg)(state)
        results.append((state, m))
    (s1, m1), (s2, m2) = results
    for (k, a), b in zip(s1.net.named_parameters(), s2.net.parameters()):
        assert torch.equal(a, b), k
    assert np.isfinite(float(m1["approx_kl"])) and 0.0 <= float(m1["clip_frac"]) <= 1.0
    assert (s1.update_step, int(s1.opt_state.count), int(s1.step_counter)) == (1, 8, 1)


def test_ppo_learns_two_state():
    """tests/test_ppo.py's two-state MDP check: E=16, T=16, 4 epochs × 4
    minibatches, lr 3e-3, γ 0.9, 60 iterations on the CPU."""
    env = make_two_state_mdp()
    cfg = tppo.PPOConfig(num_envs=16, rollout_steps=16, epochs=4, num_minibatches=4,
                         lr=3e-3, gamma=0.9, hidden=(32,), entropy_coef=0.001)
    state, _ = tppo.train(env, cfg, num_iterations=60, seed=1, device="cpu")
    with torch.no_grad():
        dist, v = state.net(torch.eye(2))
    p1 = torch.softmax(dist.logits, -1)[:, 1]
    assert float(p1.min()) > 0.9, f"PPO failed to learn: P(a=1)={p1}"
    # The critic's fixed point under the truncation bootstrap is 1/(1-γ) = 10.
    np.testing.assert_allclose(v.numpy(), [10.0, 10.0], rtol=0.15)


def test_train_runs_on_cpu_and_counts_steps():
    cfg = tppo.PPOConfig(num_envs=8, rollout_steps=4, epochs=2, num_minibatches=2, hidden=(8,))
    rows = []
    state, metrics = tppo.train(make_cartpole(), cfg, 3, seed=0, device="cpu",
                                log_fn=lambda it, m: rows.append((it, m)))
    assert [it for it, _ in rows] == [1, 3]
    assert state.update_step == 3 and int(state.opt_state.count) == 12
    assert all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.slow
def test_ppo_learns_cartpole():
    """The exact `ppo_cartpole` preset for 30 iterations on the CPU: the best
    greedy eval over iterations 20/25/30 clears 400 (tests/test_ppo.py's
    bar; the JAX package solves >= 475 in <= 35 iterations)."""
    from actor_critic_tpu_torch.config import PRESETS

    env = make_cartpole()
    cfg = PRESETS["ppo_cartpole"].config
    state = tppo.init_state(env, cfg, seed=0, device="cpu")
    step = tppo.make_train_step(env, cfg)
    eval_fn = tppo.make_eval_fn(env, cfg)
    best = 0.0
    for it in range(1, 31):
        state, _ = step(state)
        if it in (20, 25, 30):
            best = max(best, float(eval_fn(state, torch.Generator().manual_seed(1), 32, 512)))
    assert best >= 400.0, f"CartPole not learned: best greedy eval {best}"


@pytest.mark.slow
def test_ppo_learns_point_mass_continuous():
    env = make_point_mass()
    cfg = tppo.PPOConfig(num_envs=32, rollout_steps=16, epochs=4, num_minibatches=4,
                         lr=3e-3, hidden=(32, 32), entropy_coef=0.0)
    _, metrics = tppo.train(env, cfg, num_iterations=300, seed=2, device="cpu")
    assert float(metrics["avg_return_ema"]) > -0.3
