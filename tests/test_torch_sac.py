"""SAC of the port (`actor_critic_tpu_torch/algos/sac.py`) against the JAX
package's (`actor_critic_tpu/algos/sac.py`):

- one update equals JAX's `one_update` on the same learner (converted by
  `tests/torch_offpolicy_states.py`) with JAX's draws (the batch's slots,
  the target's and the actor loss's ε, reproduced from the learner's key),
  with auto-α, with `fixed_alpha`, and on a `mixed` ring: every parameter,
  the target critic, every Adam moment and count, `log_alpha` and its
  Adam state, the update count and the ring, and the metrics, at
  `test_torch_ddpg.py`'s tolerances;
- the mechanics `tests/test_sac.py` holds: the warm-up gate blocks
  learning (α too), an update moves everything and the target only
  slightly, a fixed α stays fixed, α moves against the entropy gap, the
  config's checks, the fused trainer's accounting;
- learning on the point mass at `tests/test_sac.py`'s config, seed and
  threshold (greedy return > −1.0), and, slow-marked, on Pendulum at
  `test_sac_learns_jax_pendulum_fused`'s (best greedy eval ≥ −250).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu import replay as jreplay
from actor_critic_tpu.algos import sac as jsac
from actor_critic_tpu.algos.common import OffPolicyTransition as JTransition
from actor_critic_tpu_torch.algos import sac as tsac
from actor_critic_tpu_torch.algos.common import OffPolicyTransition, evaluate
from actor_critic_tpu_torch.envs import make_pendulum, make_point_mass
from torch_offpolicy_states import learner_tensors, load_learner, max_differences, sac_draws

OBS, ACT = 3, 2


def _small(**kw):
    """tests/test_sac.py's `_small_cfg`."""
    base = dict(num_envs=16, steps_per_iter=4, updates_per_iter=2, buffer_capacity=32768,
                batch_size=64, hidden=(32, 32), actor_lr=1e-3, critic_lr=1e-3, alpha_lr=1e-3,
                warmup_steps=128)
    base.update(kw)
    return base


def _jax_learner(cfg_kw, n_items=512, key=0):
    cfg = jsac.SACConfig(**cfg_kw)
    k = jax.random.key(key)
    k, lk, dk = jax.random.split(k, 3)
    learner = jsac.init_learner((OBS,), ACT, cfg, lk)
    ks = jax.random.split(dk, 5)
    batch = JTransition(
        obs=jax.random.normal(ks[0], (n_items, OBS)),
        action=jax.random.uniform(ks[1], (n_items, ACT), minval=-1, maxval=1),
        reward=jax.random.normal(ks[2], (n_items,)),
        next_obs=jax.random.normal(ks[3], (n_items, OBS)),
        terminated=(jax.random.uniform(ks[4], (n_items,)) < 0.1).astype(jnp.float32),
        done=jnp.zeros((n_items,)),
    )
    codecs = jreplay.offpolicy_codecs(cfg.replay_dtype)
    return cfg, learner._replace(replay=jreplay.add_batch(learner.replay, batch, codecs))


def _port_learner(cfg_kw, jls):
    cfg = tsac.SACConfig(**cfg_kw)
    port = tsac.init_learner((OBS,), ACT, cfg, device="cpu")
    load_learner(port, jls)
    return cfg, port


def _assert_learners_match(port, jls, cfg_kw):
    _, want = _port_learner(cfg_kw, jls)
    want_t = learner_tensors(want)
    for name, d in max_differences(learner_tensors(port), want_t).items():
        if " count" in name or name.endswith(("update_count", "insert_pos", "size")) or (
                "storage" in name):
            assert d == 0.0, (name, d)
        elif " mu " in name or " nu " in name:
            assert d <= 1e-6 * max(float(want_t[name].abs().max()), 1e-3), (name, d)
        else:
            assert d <= 1e-6, (name, d)


UPDATE_CASES = {
    "auto_alpha": dict(),
    "fixed_alpha": dict(fixed_alpha=0.2),
    "mixed": dict(replay_dtype="mixed", init_alpha=0.5),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_one_update_equals_jax(case):
    """Two updates in a row from the same learner, each against JAX's
    `one_update` with its draws."""
    cfg_kw = _small(updates_per_iter=1, **UPDATE_CASES[case])
    jcfg, jls = _jax_learner(cfg_kw)
    cfg, port = _port_learner(cfg_kw, jls)
    jloop = jax.jit(jsac.make_update_loop(ACT, jcfg))
    tloop = tsac.make_update_loop(ACT, cfg)
    for _ in range(2):
        draws = tsac.SACDraws(*sac_draws(jls, jcfg, ACT))
        tm = tloop.apply_update(port, torch.tensor(True), draws)
        jls, jm = jloop(jls, jnp.asarray(True))
        _assert_learners_match(port, jls, cfg_kw)
        for k in ("critic_loss", "actor_loss", "q_mean", "alpha", "entropy_est"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6)
    assert int(port.update_count) == 2
    if cfg.fixed_alpha is None:
        assert int(port.alpha_opt.count) == 2
    else:
        assert int(port.alpha_opt.count) == 0
        np.testing.assert_allclose(float(torch.exp(port.log_alpha)), 0.2, rtol=1e-6)


def test_gate_closed_update_equals_jax():
    cfg_kw = _small(updates_per_iter=1)
    jcfg, jls = _jax_learner(cfg_kw)
    cfg, port = _port_learner(cfg_kw, jls)
    before = learner_tensors(port)
    tsac.make_update_loop(ACT, cfg).apply_update(port, torch.tensor(False),
                                                 tsac.SACDraws(*sac_draws(jls, jcfg, ACT)))
    jls, _ = jax.jit(jsac.make_update_loop(ACT, jcfg))(jls, jnp.asarray(False))
    assert all(d == 0.0 for d in max_differences(learner_tensors(port), before).values())
    _assert_learners_match(port, jls, cfg_kw)


# ------------------------------------------------------------ mechanics


def _filled_port(cfg, n_items=512, seed=0):
    port = tsac.init_learner((1,), 1, cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    batch = OffPolicyTransition(
        obs=torch.randn(n_items, 1, generator=g),
        action=torch.rand(n_items, 1, generator=g) * 2 - 1,
        reward=torch.randn(n_items, generator=g),
        next_obs=torch.randn(n_items, 1, generator=g),
        terminated=torch.zeros(n_items), done=torch.zeros(n_items))
    tsac.replay.add_batch(port.replay, batch, tsac.replay.offpolicy_codecs(cfg.replay_dtype))
    return port


def _params(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_warmup_blocks_learning():
    cfg = tsac.SACConfig(**_small(updates_per_iter=1))
    port = _filled_port(cfg)
    actor, log_alpha = _params(port.actor), port.log_alpha.clone()
    tsac.make_update_loop(1, cfg)(port, torch.tensor(False), torch.Generator().manual_seed(0))
    assert _equal(actor, _params(port.actor))
    assert torch.equal(port.log_alpha, log_alpha) and int(port.update_count) == 0


def test_update_moves_everything():
    cfg = tsac.SACConfig(**_small(updates_per_iter=1))
    port = _filled_port(cfg)
    actor, critic, target = _params(port.actor), _params(port.critic), _params(port.target_critic)
    log_alpha = port.log_alpha.clone()
    m = tsac.make_update_loop(1, cfg)(port, torch.tensor(True), torch.Generator().manual_seed(0))
    assert not _equal(critic, _params(port.critic)) and not _equal(actor, _params(port.actor))
    assert not torch.equal(port.log_alpha, log_alpha)
    # The target critic moved slightly, not copied.
    assert not _equal(target, _params(port.target_critic))
    assert not _equal(_params(port.target_critic), _params(port.critic))
    for v in m.values():
        assert np.isfinite(float(v))


def test_fixed_alpha_stays_fixed():
    cfg = tsac.SACConfig(**_small(updates_per_iter=4, fixed_alpha=0.2))
    port = _filled_port(cfg)
    m = tsac.make_update_loop(1, cfg)(port, torch.tensor(True), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(torch.exp(port.log_alpha)), 0.2, rtol=1e-6)
    np.testing.assert_allclose(float(m["alpha"]), 0.2, rtol=1e-6)


def test_alpha_tunes_toward_target_entropy():
    """α moves against the entropy gap: entropy above the target ⇒ α
    decays, below ⇒ α grows."""
    cfg = tsac.SACConfig(**_small(updates_per_iter=32, init_alpha=1.0, alpha_lr=1e-2))
    port = _filled_port(cfg)
    before = float(port.log_alpha)
    m = tsac.make_update_loop(1, cfg)(port, torch.tensor(True), torch.Generator().manual_seed(0))
    entropy, target = float(m["entropy_est"]), tsac._target_entropy(1, cfg)
    assert abs(entropy - target) > 1e-3, "gap too small to test direction"
    if entropy > target:
        assert float(port.log_alpha) < before
    else:
        assert float(port.log_alpha) > before


def test_config_rejects_nonpositive_alpha_and_matches_jax():
    with pytest.raises(ValueError):
        tsac.SACConfig(init_alpha=0.0)
    with pytest.raises(ValueError):
        tsac.SACConfig(fixed_alpha=-0.1)
    jf = [(f.name, f.default) for f in dataclasses.fields(jsac.SACConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsac.SACConfig)]
    assert tf == jf
    assert tsac._target_entropy(6, tsac.SACConfig()) == jsac._target_entropy(6, jsac.SACConfig())
    assert tsac._target_entropy(6, tsac.SACConfig(target_entropy=-2.5)) == -2.5


def test_smoke_and_accounting():
    env = make_point_mass()
    cfg = tsac.SACConfig(**_small())
    state, metrics = tsac.train(env, cfg, num_iterations=3, seed=0, device="cpu")
    assert state.update_step == 3
    assert int(state.env_steps) == 3 * cfg.steps_per_iter * cfg.num_envs
    for v in metrics.values():
        assert np.isfinite(float(v))


def test_sac_learns_point_mass():
    env = make_point_mass()
    cfg = tsac.SACConfig(**_small(updates_per_iter=4, warmup_steps=256))
    state, _ = tsac.train(env, cfg, num_iterations=250, seed=0, device="cpu")
    actor = state.learner.actor
    with torch.no_grad():
        ret = float(evaluate(env, lambda o: actor(o).mode(), torch.Generator().manual_seed(9),
                             32, 16))
    # Optimal 0; random ≈ −6. The entropy bonus keeps it off the optimum.
    assert ret > -1.0, ret


@pytest.mark.slow
def test_sac_learns_pendulum_fused():
    """`tests/test_sac.py::test_sac_learns_jax_pendulum_fused` on the port:
    E=8, K=J=8, hidden (128, 128), batch 128, warm-up 1,000; 2,000
    iterations, a greedy eval (8 envs, 200 steps) every 500; best ≥ −250."""
    env = make_pendulum()
    cfg = tsac.SACConfig(num_envs=8, steps_per_iter=8, updates_per_iter=8, hidden=(128, 128),
                         batch_size=128, warmup_steps=1000)
    state = tsac.init_state(env, cfg, seed=0, device="cpu")
    step = tsac.make_train_step(env, cfg)
    eval_fn = tsac.make_eval_fn(env, cfg)
    best = -float("inf")
    for it in range(2000):
        state, _ = step(state)
        if (it + 1) % 500 == 0:
            best = max(best, float(eval_fn(state, torch.Generator().manual_seed(1), 8, 200)))
    assert best >= -250.0, f"pendulum not learned: best eval {best}"
