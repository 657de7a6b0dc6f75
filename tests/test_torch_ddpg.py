"""DDPG / TD3 of the port (`actor_critic_tpu_torch/algos/ddpg.py`) against the
JAX package's (`actor_critic_tpu/algos/ddpg.py`):

- one update equals JAX's `one_update` on the same learner (converted by
  `tests/torch_offpolicy_states.py`) with JAX's draws (the batch's slots
  or window starts and TD3's target noise, reproduced from the learner's
  key), for DDPG, TD3 on an actor step and then on a skipped one, n-step
  TD3, and TD3 on a `mixed` ring: every parameter, target, Adam moment and
  count, the update count and the ring, and the metrics. Tolerance: the
  parameters and targets within 1e-6 (an Adam step moves a parameter by
  ~lr = 1e-3; the gradients are float32 sums taken in another order), the
  moments within 1e-6 relative, the counts exact;
- the mechanics `tests/test_ddpg.py` holds: the warm-up gate blocks
  learning, an update moves both nets, the policy delay, Polyak and not a
  copy, the n-step guard, the fused trainer's accounting and its warm-up;
- the config's fields and defaults, and `td3_config`, are JAX's;
- learning on the point mass at `tests/test_ddpg.py`'s configs, seeds and
  threshold (greedy return > −1.0): DDPG, TD3 and n-step TD3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu import replay as jreplay
from actor_critic_tpu.algos import ddpg as jddpg
from actor_critic_tpu.algos.common import OffPolicyTransition as JTransition
from actor_critic_tpu_torch.algos import ddpg as tddpg
from actor_critic_tpu_torch.algos.common import evaluate
from actor_critic_tpu_torch.envs import make_point_mass
from torch_offpolicy_states import ddpg_draws, learner_tensors, load_learner, max_differences

OBS, ACT = 3, 2


def _small(**kw):
    """tests/test_ddpg.py's `_small_cfg`."""
    base = dict(num_envs=16, steps_per_iter=4, updates_per_iter=2, buffer_capacity=4096,
                batch_size=64, hidden=(32, 32), actor_lr=1e-3, critic_lr=1e-3,
                warmup_steps=128)
    base.update(kw)
    return base


def _jax_learner(cfg_kw, n_items=512, key=0, obs_dim=OBS, act_dim=ACT):
    """tests/test_ddpg.py's `_filled_learner`: a JAX learner whose ring holds
    random transitions (a few terminated), in the config's codecs."""
    cfg = jddpg.DDPGConfig(**cfg_kw)
    k = jax.random.key(key)
    k, lk, dk = jax.random.split(k, 3)
    learner = jddpg.init_learner((obs_dim,), act_dim, cfg, lk)
    ks = jax.random.split(dk, 5)
    batch = JTransition(
        obs=jax.random.normal(ks[0], (n_items, obs_dim)),
        action=jax.random.uniform(ks[1], (n_items, act_dim), minval=-1, maxval=1),
        reward=jax.random.normal(ks[2], (n_items,)),
        next_obs=jax.random.normal(ks[3], (n_items, obs_dim)),
        terminated=(jax.random.uniform(ks[4], (n_items,)) < 0.1).astype(jnp.float32),
        done=(jax.random.uniform(ks[4], (n_items,)) < 0.2).astype(jnp.float32),
    )
    codecs = jreplay.offpolicy_codecs(cfg.replay_dtype)
    return cfg, learner._replace(replay=jreplay.add_batch(learner.replay, batch, codecs))


def _port_learner(cfg_kw, jls, obs_dim=OBS, act_dim=ACT):
    cfg = tddpg.DDPGConfig(**cfg_kw)
    port = tddpg.init_learner((obs_dim,), act_dim, cfg, device="cpu")
    load_learner(port, jls)
    return cfg, port


def _assert_learners_match(port, jls, cfg_kw):
    _, want = _port_learner(cfg_kw, jls)
    diffs = max_differences(learner_tensors(port), learner_tensors(want))
    for name, d in diffs.items():
        if " count" in name or name.endswith(("update_count", "insert_pos", "size")) or (
                "storage" in name):
            assert d == 0.0, (name, d)
        elif " mu " in name or " nu " in name:
            scale = float(learner_tensors(want)[name].abs().max())
            assert d <= 1e-6 * max(scale, 1e-3), (name, d, scale)
        else:
            assert d <= 1e-6, (name, d)
    return diffs


UPDATE_CASES = {
    "ddpg": dict(),
    "td3": dict(twin_q=True, policy_delay=2, target_noise=0.2),
    "td3_nstep": dict(twin_q=True, policy_delay=2, target_noise=0.2, nstep=3, num_envs=1),
    "td3_mixed": dict(twin_q=True, policy_delay=2, target_noise=0.2, replay_dtype="mixed"),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_one_update_equals_jax(case):
    """Two updates in a row from the same learner, each against JAX's
    `one_update` with its draws: the first takes the actor step (update
    count 0), the second skips it under TD3's delay of 2 (count 1)."""
    cfg_kw = _small(updates_per_iter=1, **UPDATE_CASES[case])
    jcfg, jls = _jax_learner(cfg_kw)
    cfg, port = _port_learner(cfg_kw, jls)
    jloop = jax.jit(jddpg.make_update_loop(ACT, jcfg))
    tloop = tddpg.make_update_loop(ACT, cfg)
    for step in range(2):
        idx, eps = ddpg_draws(jls, jcfg, ACT)
        actor_before = {k: v.clone() for k, v in port.actor.state_dict().items()}
        tm = tloop.apply_update(port, torch.tensor(True), tddpg.UpdateDraws(idx, eps))
        jls, jm = jloop(jls, jnp.asarray(True))
        _assert_learners_match(port, jls, cfg_kw)
        for k in ("critic_loss", "actor_loss", "q_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
        actor_moved = any(not torch.equal(v, port.actor.state_dict()[k])
                          for k, v in actor_before.items())
        assert actor_moved == (step % cfg.policy_delay == 0), (case, step)
    assert int(port.update_count) == 2
    assert int(port.actor_opt.count) == (1 if cfg.policy_delay == 2 else 2)


def test_gate_closed_update_equals_jax():
    """do_update false: JAX keeps every parameter, moment and count, and so
    does the port, though both compute the update."""
    cfg_kw = _small(updates_per_iter=1, **UPDATE_CASES["td3"])
    jcfg, jls = _jax_learner(cfg_kw)
    cfg, port = _port_learner(cfg_kw, jls)
    before = learner_tensors(port)
    idx, eps = ddpg_draws(jls, jcfg, ACT)
    tddpg.make_update_loop(ACT, cfg).apply_update(port, torch.tensor(False),
                                                  tddpg.UpdateDraws(idx, eps))
    jls, _ = jax.jit(jddpg.make_update_loop(ACT, jcfg))(jls, jnp.asarray(False))
    assert all(d == 0.0 for d in max_differences(learner_tensors(port), before).values())
    _assert_learners_match(port, jls, cfg_kw)


# ------------------------------------------------------------ mechanics


def _filled_port(cfg, n_items=512, seed=0):
    """A port learner whose ring holds random transitions."""
    port = tddpg.init_learner((1,), 1, cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    batch = tddpg.OffPolicyTransition(
        obs=torch.randn(n_items, 1, generator=g),
        action=torch.rand(n_items, 1, generator=g) * 2 - 1,
        reward=torch.randn(n_items, generator=g),
        next_obs=torch.randn(n_items, 1, generator=g),
        terminated=torch.zeros(n_items), done=torch.zeros(n_items))
    tddpg.replay.add_batch(port.replay, batch, tddpg.replay.offpolicy_codecs(cfg.replay_dtype))
    return port


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_warmup_blocks_learning():
    cfg = tddpg.DDPGConfig(**_small(updates_per_iter=1))
    port = _filled_port(cfg)
    actor, critic = _params(port.actor), _params(port.critic)
    tddpg.make_update_loop(1, cfg)(port, torch.tensor(False), torch.Generator().manual_seed(0))
    assert _equal(actor, _params(port.actor)) and _equal(critic, _params(port.critic))
    assert int(port.update_count) == 0 and int(port.critic_opt.count) == 0


def test_update_changes_params():
    cfg = tddpg.DDPGConfig(**_small(updates_per_iter=1))
    port = _filled_port(cfg)
    actor, critic = _params(port.actor), _params(port.critic)
    m = tddpg.make_update_loop(1, cfg)(port, torch.tensor(True), torch.Generator().manual_seed(0))
    assert not _equal(actor, _params(port.actor)) and not _equal(critic, _params(port.critic))
    assert int(port.update_count) == 1 and np.isfinite(float(m["critic_loss"]))


def test_policy_delay():
    """With delay 2, updates 0, 2, … move the actor and its target; 1, 3, …
    do not."""
    cfg = tddpg.DDPGConfig(**_small(updates_per_iter=1, twin_q=True, policy_delay=2))
    port = _filled_port(cfg)
    loop = tddpg.make_update_loop(1, cfg)
    g = torch.Generator().manual_seed(0)
    a0 = _params(port.actor)
    loop(port, torch.tensor(True), g)
    a1, t1 = _params(port.actor), _params(port.target_actor)
    assert not _equal(a0, a1)
    loop(port, torch.tensor(True), g)
    assert _equal(a1, _params(port.actor)) and _equal(t1, _params(port.target_actor))
    loop(port, torch.tensor(True), g)
    assert not _equal(a1, _params(port.actor))
    assert int(port.actor_opt.count) == 2 and int(port.critic_opt.count) == 3


def test_target_nets_polyak_not_copy():
    cfg = tddpg.DDPGConfig(**_small(updates_per_iter=1, tau=0.005))
    port = _filled_port(cfg)
    target = _params(port.target_critic)
    tddpg.make_update_loop(1, cfg)(port, torch.tensor(True), torch.Generator().manual_seed(0))
    assert not _equal(target, _params(port.target_critic))
    assert not _equal(_params(port.target_critic), _params(port.critic))


def test_twin_q_shapes():
    _, critic = tddpg.make_networks(4, 2, tddpg.DDPGConfig(**_small(twin_q=True)))
    q1, q2 = critic(torch.zeros(3, 4), torch.zeros(3, 2))
    assert q1.shape == q2.shape == (3,)


def test_nstep_requires_single_env():
    with pytest.raises(ValueError, match="num_envs == 1"):
        tddpg.make_update_loop(1, tddpg.DDPGConfig(**_small(nstep=3, num_envs=16)))
    with pytest.raises(ValueError, match="nstep must be >= 1"):
        tddpg.make_update_loop(1, tddpg.DDPGConfig(**_small(nstep=0)))


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jddpg.DDPGConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tddpg.DDPGConfig)]
    assert tf == jf
    assert dataclasses.asdict(tddpg.td3_config(num_envs=3)) == dataclasses.asdict(
        jddpg.td3_config(num_envs=3))


def test_smoke_and_accounting():
    env = make_point_mass()
    cfg = tddpg.DDPGConfig(**_small())
    state, metrics = tddpg.train(env, cfg, num_iterations=3, seed=0, device="cpu")
    assert state.update_step == 3
    assert int(state.env_steps) == 3 * cfg.steps_per_iter * cfg.num_envs
    assert int(state.learner.replay.size) == 3 * cfg.steps_per_iter * cfg.num_envs
    # The gate opened at iteration 2 (128 env steps, 128 ≥ the 64 batch).
    assert int(state.learner.update_count) == 2 * cfg.updates_per_iter
    for v in metrics.values():
        assert np.isfinite(float(v))


def test_warmup_random_actions_fill_replay():
    env = make_point_mass()
    cfg = tddpg.DDPGConfig(**_small(warmup_steps=10_000))
    state, _ = tddpg.train(env, cfg, num_iterations=2, seed=0, device="cpu")
    assert int(state.learner.replay.size) == 2 * cfg.steps_per_iter * cfg.num_envs
    assert int(state.learner.update_count) == 0  # still warming up
    actions = state.learner.replay.storage.action[:128]
    # Uniform in [−1, 1), not the untrained actor's near-zero outputs.
    assert float(actions.abs().mean()) > 0.3


def test_env_steps_saturate():
    from actor_critic_tpu_torch.algos.common import ENV_STEPS_SATURATE

    env = make_point_mass()
    cfg = tddpg.DDPGConfig(**_small())
    state = tddpg.init_state(env, cfg, seed=0, device="cpu")
    state.env_steps.fill_(ENV_STEPS_SATURATE - 10)
    state, _ = tddpg.make_train_step(env, cfg)(state)
    assert int(state.env_steps) == ENV_STEPS_SATURATE


# ------------------------------------------------------------- learning


def _greedy_eval(env, state) -> float:
    """tests/test_ddpg.py's `_greedy_eval`: 32 envs, 16 steps."""
    actor = state.learner.actor
    with torch.no_grad():
        return float(evaluate(env, actor, torch.Generator().manual_seed(99), 32, 16))


def test_ddpg_learns_point_mass():
    env = make_point_mass()
    cfg = tddpg.DDPGConfig(**_small(updates_per_iter=4, exploration_noise=0.2, warmup_steps=256,
                                    buffer_capacity=32768))
    state, _ = tddpg.train(env, cfg, num_iterations=250, seed=1, device="cpu")
    ret = _greedy_eval(env, state)
    assert ret > -1.0, ret


def test_td3_learns_point_mass():
    env = make_point_mass()
    cfg = tddpg.td3_config(
        num_envs=16, steps_per_iter=4, updates_per_iter=4,
        buffer_capacity=32768, batch_size=64, hidden=(32, 32),
        actor_lr=1e-3, critic_lr=1e-3, warmup_steps=256,
        exploration_noise=0.2,
    )
    state, _ = tddpg.train(env, cfg, num_iterations=250, seed=2, device="cpu")
    ret = _greedy_eval(env, state)
    assert ret > -1.0, ret


def test_td3_nstep_learns_point_mass():
    env = make_point_mass()
    cfg = tddpg.td3_config(
        num_envs=1, steps_per_iter=16, updates_per_iter=8, nstep=3,
        buffer_capacity=32768, batch_size=64, hidden=(32, 32),
        actor_lr=1e-3, critic_lr=1e-3, warmup_steps=256,
        exploration_noise=0.2,
    )
    state, metrics = tddpg.train(env, cfg, num_iterations=250, seed=3, device="cpu")
    assert np.isfinite(float(metrics["critic_loss"]))
    ret = _greedy_eval(env, state)
    assert ret > -1.0, ret
