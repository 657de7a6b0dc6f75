"""Checkpoint / resume of the port (`utils/checkpoint.py`, the loop's
`ckpt`/`resume`), the counterparts of `tests/test_checkpoint.py` and of
`tests/test_mixture.py::test_curriculum_checkpoint_resume`, on the CPU:

- a checkpoint holds every carried tensor and the generator's state, and a
  restore into a fresh state gives them back bit for bit;
- N iterations straight equal k iterations plus a resumed N − k, bit for
  bit over every carried tensor and the metrics, for A2C, PPO, IMPALA and
  A3C on Pong, A2C on the mixture fleet, TD3 on a `mixed` ring and SAC
  (the ring, its stats, the targets, log α and every count included);
- the curriculum's stage and weights ride the checkpoint, and a resumed
  run does not re-fire a threshold it has crossed;
- retention keeps the newest, a missing or foreign checkpoint raises, and
  a non-finite state is refused at save.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from actor_critic_tpu_torch.algos import a2c, ddpg, impala, ppo, sac
from actor_critic_tpu_torch.algos.common import carried_tensors
from actor_critic_tpu_torch.algos.loop import fused_train_loop
from actor_critic_tpu_torch.envs import (
    make_cartpole,
    make_mixture,
    make_pendulum,
    make_point_mass,
    make_pong,
    make_two_state_mdp,
)
from actor_critic_tpu_torch.envs import mixture as mx
from actor_critic_tpu_torch.utils.checkpoint import Checkpointer, NonFiniteError

CASES = {
    "a2c": (a2c, a2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(16,), anneal_iters=5,
                               lr_final=0.0, entropy_coef_final=0.0), make_two_state_mdp),
    "ppo": (ppo, ppo.PPOConfig(num_envs=8, rollout_steps=4, epochs=2, num_minibatches=2,
                               anneal_iters=5, lr_final=0.0), make_cartpole),
    "impala_pong": (impala, impala.ImpalaConfig(num_envs=4, rollout_steps=4, actor_refresh_every=2),
                    lambda: make_pong(size=42, max_steps=12)),
    "a3c_pong": (impala, impala.ImpalaConfig(num_envs=4, rollout_steps=4, actor_refresh_every=2,
                                             correction="none", lam=0.95),
                 lambda: make_pong(size=42, max_steps=12)),
    "a2c_mixture": (a2c, a2c.A2CConfig(num_envs=16, rollout_steps=4, hidden=(16,)),
                    lambda: make_mixture(randomize=0.2, redraw_types=True)),
    # The off-policy trainers: the ring (int8 codes and their stats in
    # `mixed`), both targets, both Adam states, log α and its Adam, the
    # update count and the env-step count ride the checkpoint. The gate
    # opens at iteration 1 (16 env steps, a 16-row batch).
    "td3_mixed": (ddpg, ddpg.td3_config(num_envs=4, steps_per_iter=4, updates_per_iter=2,
                                        buffer_capacity=64, batch_size=16, hidden=(16,),
                                        warmup_steps=16, replay_dtype="mixed"),
                  make_point_mass),
    "sac": (sac, sac.SACConfig(num_envs=4, steps_per_iter=4, updates_per_iter=2,
                               buffer_capacity=64, batch_size=16, hidden=(16,), warmup_steps=16),
            make_pendulum),
}


def _setup(name, seed=0):
    mod, cfg, make_env = CASES[name]
    env = make_env()
    return mod, cfg, env, mod.init_state(env, cfg, seed=seed, device="cpu")


def _snapshot(state) -> dict[str, torch.Tensor]:
    out = {k: t.detach().clone() for k, t in carried_tensors(state).items()}
    out["generator"] = state.generator.get_state()
    return out


def _assert_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    diff = [k for k in a if not torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))]
    assert not diff, diff


@pytest.mark.parametrize("name", sorted(CASES))
def test_roundtrip_exact(name, tmp_path):
    mod, cfg, env, state = _setup(name)
    state, _ = mod.make_train_step(env, cfg)(state)
    ck = Checkpointer(tmp_path / "ck")
    ck.save(1, state)
    _, _, _, fresh = _setup(name, seed=1)
    assert ck.restore(fresh) == 1
    _assert_equal(_snapshot(fresh), _snapshot(state))
    # Restored in place: the fresh state's own storage, as a capture saw it.
    assert all(carried_tensors(fresh)[k].data_ptr() == t.data_ptr()
               for k, t in carried_tensors(fresh).items())


@pytest.mark.parametrize("name", ["a2c", "impala_pong"])
def test_kill_resume_matches_uninterrupted(name, tmp_path):
    """3 steps, "die", restore into a fresh state, 3 more == 6 straight."""
    mod, cfg, env, full = _setup(name)
    step = mod.make_train_step(env, cfg)
    for _ in range(6):
        full, full_metrics = step(full)
    _, _, _, half = _setup(name)
    for _ in range(3):
        half, _ = step(half)
    ck = Checkpointer(tmp_path / "ck")
    ck.save(3, half)
    _, _, _, resumed = _setup(name)
    ck.restore(resumed, 3)
    for _ in range(3):
        resumed, resumed_metrics = step(resumed)
    _assert_equal(_snapshot(full), _snapshot(resumed))
    _assert_equal(full_metrics, resumed_metrics)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loop_resumes_bit_for_bit(name, tmp_path):
    """`fused_train_loop`: 6 iterations straight equal 4 (saved every 2, and
    at the end) plus a resumed 2 from a fresh init, over every carried
    tensor, the generator and the last metrics."""
    mod, cfg, env, _ = _setup(name)
    straight, m_straight = fused_train_loop(
        mod.make_train_step, mod.init_state, env, cfg, 6, device="cpu")
    ck = Checkpointer(tmp_path / "ck")
    fused_train_loop(mod.make_train_step, mod.init_state, env, cfg, 4, device="cpu",
                     ckpt=ck, save_every=2)
    assert ck.all_steps() == [2, 4]
    resumed, m_resumed = fused_train_loop(
        mod.make_train_step, mod.init_state, env, cfg, 6, device="cpu",
        ckpt=ck, save_every=2, resume=True)
    assert ck.all_steps() == [2, 4, 6] and resumed.update_step == 6
    _assert_equal(_snapshot(straight), _snapshot(resumed))
    _assert_equal(m_straight, m_resumed)
    saved = ck.restore_metrics(6)
    assert saved == {k: float(v) for k, v in m_resumed.items()}


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    mod, cfg, env, _ = _setup("a2c")
    ref, _ = fused_train_loop(mod.make_train_step, mod.init_state, env, cfg, 3, device="cpu")
    got, _ = fused_train_loop(mod.make_train_step, mod.init_state, env, cfg, 3, device="cpu",
                              ckpt=Checkpointer(tmp_path / "empty"), resume=True)
    _assert_equal(_snapshot(ref), _snapshot(got))


def test_resume_with_nothing_left_reports_the_saved_metrics(tmp_path):
    mod, cfg, env, _ = _setup("a2c")
    ck = Checkpointer(tmp_path / "ck")
    _, metrics = fused_train_loop(mod.make_train_step, mod.init_state, env, cfg, 3,
                                  device="cpu", ckpt=ck)
    state, again = fused_train_loop(mod.make_train_step, mod.init_state, env, cfg, 3,
                                    device="cpu", ckpt=ck, resume=True)
    assert state.update_step == 3
    assert again == {k: float(v) for k, v in metrics.items()}


def test_retention_and_latest(tmp_path):
    mod, cfg, env, state = _setup("a2c")
    step = mod.make_train_step(env, cfg)
    ck = Checkpointer(tmp_path / "ck", max_to_keep=2)
    assert ck.latest_step() is None and ck.all_steps() == []
    for it in (1, 2, 3):
        state, _ = step(state)
        ck.save(it, state, {"loss": float("nan")})
    assert ck.latest_step() == 3 and ck.all_steps() == [2, 3]
    # A non-finite metric is the record of a divergence: kept, as null.
    assert ck.restore_metrics() == {"loss": None}
    with open(tmp_path / "ck" / "3" / "metrics.json") as f:
        assert json.load(f) == {"loss": None}


def test_restore_missing_or_foreign_raises(tmp_path):
    mod, cfg, env, state = _setup("a2c")
    ck = Checkpointer(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        ck.restore(state)
    assert ck.restore_metrics() == {}
    ck.save(1, state)
    wider = a2c.init_state(env, a2c.A2CConfig(num_envs=8, rollout_steps=4, hidden=(32,)),
                           seed=0, device="cpu")
    with pytest.raises(ValueError, match="param"):
        ck.restore(wider)
    _, _, _, other = _setup("ppo")
    with pytest.raises(ValueError, match="not of this state"):
        ck.restore(other)


@pytest.mark.parametrize("where", ["param", "env"])
def test_non_finite_state_is_refused(where, tmp_path):
    """The previous good checkpoint stays the latest (JAX: numguard at
    commit)."""
    mod, cfg, env, state = _setup("a2c_mixture")
    ck = Checkpointer(tmp_path / "ck")
    ck.save(1, state)
    with torch.no_grad():
        if where == "param":
            next(state.net.parameters()).view(-1)[0] = float("nan")
        else:
            state.rollout.env_state.members[1].theta[0] = float("inf")
    with pytest.raises(NonFiniteError, match="non-finite"):
        ck.save(2, state)
    assert ck.all_steps() == [1]


def test_curriculum_checkpoint_resume(tmp_path):
    """The stage and weights ride the checkpoint: leg 1 crosses the
    threshold at its first log and installs stage 1 before the next
    iteration; leg 2 restores, syncs the controller from the fleet and does
    not re-fire the crossed threshold; both legs together equal 8
    iterations straight."""
    env = make_mixture("cartpole,maze", redraw_types=True)
    cfg = a2c.A2CConfig(num_envs=8, rollout_steps=2, hidden=(8,))
    cur = mx.parse_curriculum("-1000:0,1", env.member_names)

    def leg(iters, resume, ckpt):
        ctl = mx.CurriculumController(cur)
        installs, pending, synced = [], [], [False]

        def hook(it, s):
            if not synced[0]:
                ctl.sync(mx.fleet_stage(s.rollout.env_state))
                synced[0] = True
            if pending:
                stage, w = pending.pop()
                mx.set_fleet_weights(s.rollout.env_state, w, stage)

        def log_fn(it, m):
            adv = ctl.update(0.0)  # stands in for the eval return
            if adv is not None:
                pending.append(adv)
                installs.append(adv)

        state, _ = fused_train_loop(a2c.make_train_step, a2c.init_state, env, cfg, iters,
                                    device="cpu", log_fn=log_fn, state_hook=hook,
                                    ckpt=ckpt, save_every=2, resume=resume)
        return state, installs

    ck = Checkpointer(tmp_path / "ck")
    state1, installs1 = leg(4, False, ck)
    assert installs1 == [(1, (0.0, 1.0))]
    assert mx.fleet_stage(state1.rollout.env_state) == 1
    np.testing.assert_array_equal(state1.rollout.env_state.weights[0].numpy(), [0.0, 1.0])
    state2, installs2 = leg(8, True, ck)
    assert installs2 == []
    assert mx.fleet_stage(state2.rollout.env_state) == 1
    straight, _ = leg(8, False, None)
    _assert_equal(_snapshot(straight), _snapshot(state2))


@pytest.mark.parametrize("name", ["td3_mixed", "sac"])
def test_offpolicy_checkpoint_names_every_carried_tensor(name, tmp_path):
    """The checkpoint of an off-policy state names the ring's every leaf,
    cursor and stat, both nets and their targets, every Adam state (SAC's
    log α and its Adam too) and the counts; a state of another ring size
    is refused."""
    mod, cfg, env, state = _setup(name)
    names = set(carried_tensors(state))
    for leaf in ("obs", "action", "reward", "next_obs", "terminated", "done"):
        assert f"learner.replay storage.{leaf}" in names
        assert {f"learner.replay quant.{leaf}.{s}" for s in ("mean", "scale", "count")} <= names
    assert {"learner.replay insert_pos", "learner.replay size", "learner.update_count",
            "env_steps", "step_counter", "learner.critic_opt count",
            "learner.actor_opt count"} <= names
    targets = ("learner.target_actor", "learner.target_critic") if name == "td3_mixed" else (
        "learner.target_critic", "learner.log_alpha", "learner.alpha_opt count")
    assert all(any(n.startswith(t) for n in names) for t in targets)
    ck = Checkpointer(tmp_path / "ck")
    ck.save(1, state)
    other = mod.init_state(env, dataclasses.replace(cfg, buffer_capacity=32), seed=0, device="cpu")
    with pytest.raises(ValueError, match="storage"):
        ck.restore(other)


@pytest.mark.parametrize("name", ["td3_mixed", "sac"])
def test_offpolicy_resume_4_plus_4_equals_8(name, tmp_path):
    """TD3 on a `mixed` ring and SAC: 8 iterations straight equal 4 saved
    and a resumed 4, bit for bit over every carried tensor, the generator
    and the metrics."""
    mod, cfg, env, _ = _setup(name)
    straight, m_straight = fused_train_loop(
        mod.make_train_step, mod.init_state, env, cfg, 8, device="cpu")
    ck = Checkpointer(tmp_path / "ck")
    fused_train_loop(mod.make_train_step, mod.init_state, env, cfg, 4, device="cpu",
                     ckpt=ck, save_every=4)
    resumed, m_resumed = fused_train_loop(
        mod.make_train_step, mod.init_state, env, cfg, 8, device="cpu",
        ckpt=ck, save_every=4, resume=True)
    assert int(resumed.learner.update_count) == 8 * cfg.updates_per_iter
    _assert_equal(_snapshot(straight), _snapshot(resumed))
    _assert_equal(m_straight, m_resumed)
