"""What a CUDA graph of the A2C, PPO and IMPALA/A3C train steps and of the
evals relies on, checked on the CPU, where the same code runs eagerly
(`algos/loop.py`, `algos/common.py::BlockedEval`):

- every tensor the train state carries from one iteration to the next
  keeps its storage across steps (a replay reads and writes the addresses
  its capture saw, so a rebound tensor would be read stale);
- the step-dependent scalars the step reads from the schedule table on the
  device (at Adam's count and at the step counter) equal, bit for bit, the
  host functions the eager code used (`a2c.entropy_coef_at`,
  `linear_schedule`, optax's bias corrections);
- which trainers the loop captures, and that it runs the CPU eagerly;
- the same of the mixture fleet's nested state (`a2c_mixture` at a tiny
  size), and of a `state_hook` that installs curriculum weights;
- IMPALA/A3C on Pong (RMSProp's moments, the actors' copy, which changes
  only on refresh iterations);
- the eval in blocks of `EVAL_CHECK_EVERY` steps over static buffers (what
  the card captures) returns what the plain loop returns, with the same
  draws, for the greedy eval and the mixture's typed evals, at a length
  with a tail block;
- `--chunk`'s loop (k steps a dispatch) equals the per-iteration loop;
- the same of the off-policy steps (DDPG, TD3 on a `mixed` ring, n-step
  TD3, SAC on an `int8` ring): every carried tensor keeps its storage, the
  ring's every leaf, cursor, count and stat among them, across steps that
  wrap the ring, and the warm-up gate opens on the device.
"""

import numpy as np
import pytest
import torch

from actor_critic_tpu_torch.algos import a2c, ddpg, impala, loop, ppo, sac
from actor_critic_tpu_torch.algos.common import (
    EVAL_CHECK_EVERY,
    BlockedEval,
    carried_tensors,
    evaluate,
)
from actor_critic_tpu_torch.envs import (
    make_cartpole,
    make_mixture,
    make_pendulum,
    make_point_mass,
    make_pong,
)
from actor_critic_tpu_torch.envs.mixture import make_typed_eval, set_fleet_weights
from actor_critic_tpu_torch.optim import (
    B1,
    B2,
    AdamState,
    _bias_correction_table,
    linear_schedule,
    scalars_at,
)
from actor_critic_tpu_torch.tree import named_leaves, tree_leaves

TRAINERS = {
    "a2c": (a2c, a2c.A2CConfig(num_envs=8, rollout_steps=4, anneal_iters=5, lr_final=0.0,
                               entropy_coef_final=0.0)),
    "ppo": (ppo, ppo.PPOConfig(num_envs=8, rollout_steps=4, epochs=2, num_minibatches=2,
                               anneal_iters=5, lr_final=0.0, clip_eps_final=0.1,
                               entropy_coef=0.01, entropy_coef_final=0.0)),
    "impala": (impala, impala.ImpalaConfig(num_envs=4, rollout_steps=4, actor_refresh_every=2)),
    "a3c": (impala, impala.ImpalaConfig(num_envs=4, rollout_steps=4, actor_refresh_every=2,
                                        correction="none", lam=0.95)),
}
# The trainers' step on each env: CartPole, A2C on the four-type mixture
# fleet (a nested state: one slot per member type), and IMPALA/A3C on
# Pong's pixels at a tiny size.
STEP_CASES = {
    "a2c": ("a2c", make_cartpole),
    "ppo": ("ppo", make_cartpole),
    "a2c_mixture": ("a2c", lambda: make_mixture(randomize=0.2, redraw_types=True)),
    "impala_pong": ("impala", lambda: make_pong(size=42)),
    "a3c_pong": ("a3c", lambda: make_pong(size=42)),
}


def _carried(state) -> dict[str, torch.Tensor]:
    """Every tensor a train step reads from `state` and writes back."""
    out = {f"param {k}": p for k, p in state.net.named_parameters()}
    if isinstance(state, impala.ImpalaTrainState):
        out.update({f"actor_net {k}": p for k, p in state.actor_net.named_parameters()})
    opt = state.opt_state
    out.update({f"nu {k}": v for k, v in opt.nu.items()})
    if isinstance(opt, AdamState):
        out.update({f"mu {k}": v for k, v in opt.mu.items()})
        out["count"] = opt.count
    out["rollout obs"] = state.rollout.obs
    out.update({f"env {k}": v for k, v in named_leaves(state.rollout.env_state).items()})
    out.update(ep_return=state.ep_return, ep_length=state.ep_length,
               avg_return=state.avg_return, step_counter=state.step_counter)
    return out


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_step_writes_the_state_in_place(name):
    trainer, make_env = STEP_CASES[name]
    mod, cfg = TRAINERS[trainer]
    env = make_env()
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    step = mod.make_train_step(env, cfg)
    before = {k: (t.data_ptr(), t.clone()) for k, t in _carried(state).items()}
    # What a checkpoint holds and the card's graph check compares is this list.
    assert {k: t.data_ptr() for k, t in carried_tensors(state).items()} == {
        k: ptr for k, (ptr, _) in before.items()}
    # Checked after each step: after a rebinding, the first step's new tensor
    # is allocated while the old one is alive, so its address differs.
    for it in (1, 2):
        state, _ = step(state)
        now = _carried(state)
        assert sorted(now) == sorted(before)
        moved = [k for k, (ptr, _) in before.items() if now[k].data_ptr() != ptr]
        assert not moved, f"rebound after step {it}: {moved}"
        if trainer in ("impala", "a3c"):
            # The actors' copy moves only at a refresh (every 2nd step), to
            # the learner's parameters.
            actor = {k: v for k, v in now.items() if k.startswith("actor_net ")}
            if it % cfg.actor_refresh_every:
                assert all(torch.equal(v, before[k][1]) for k, v in actor.items())
            else:
                assert all(torch.equal(v, now[k.replace("actor_net", "param")])
                           for k, v in actor.items())
    # And the step did write them: everything but the Adam moments of
    # parameters without a gradient has new values.
    changed = {k for k, (_, old) in before.items() if not torch.equal(now[k], old)}
    if name == "a2c_mixture":
        env_leaves = tuple(f"env members.{i}.t" for i in range(4)
                           if bool((state.rollout.env_state.type_id == i).any()))
    else:
        env_leaves = ("env ball_x", "env t") if name.endswith("pong") else ("env x", "env t")
    assert env_leaves
    expected = ["rollout obs", "ep_length", "step_counter", "param policy.weight",
                "nu value.bias", *env_leaves]
    if not name.endswith("pong"):  # no point falls in Pong's first 8 steps
        expected.append("ep_return")
    if isinstance(state.opt_state, AdamState):
        expected += ["count", "mu policy.weight"]
    else:
        expected += ["actor_net policy.weight"]
    for k in expected:
        assert k in changed, k
    assert int(state.step_counter) == state.update_step == 2


def test_state_hook_writes_the_fleet_in_place():
    """The curriculum's seam: a `state_hook` installing weights through
    `set_fleet_weights` before iteration 2 keeps every carried tensor's
    storage (a replay would read the new weights), and the fleet follows
    them: the stage reads 1 and the weights are the installed ones."""
    mod, cfg = TRAINERS["a2c"]
    env = STEP_CASES["a2c_mixture"][1]()
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    ptrs = {k: t.data_ptr() for k, t in _carried(state).items()}

    def hook(it, s):
        if it == 1:
            set_fleet_weights(s.rollout.env_state, (0.0, 0.0, 0.0, 1.0), stage=1)

    state, _ = loop.fused_train_loop(mod.make_train_step, mod.init_state, env, cfg, 3,
                                     device="cpu", state=state, state_hook=hook)
    assert {k: t.data_ptr() for k, t in _carried(state).items()} == ptrs
    fleet = state.rollout.env_state
    assert torch.all(fleet.stage == 1)
    assert torch.all(fleet.weights == torch.tensor([0.0, 0.0, 0.0, 1.0]))


def test_init_gives_each_env_field_its_own_storage():
    """Pong's reset returns one tensor for several fields; the carried state
    must not, or writing one field in place would write the others."""
    cfg = impala.ImpalaConfig(num_envs=2, rollout_steps=2)
    state = impala.init_state(make_pong(size=36), cfg, seed=0, device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(state.rollout)]
    assert len(set(ptrs)) == len(ptrs)


def _bias_corrections(count):
    """optax's `1 - b**count` in float32, as the eager step computed it."""
    return (np.float32(1.0) - np.float32(B1) ** np.float32(count),
            np.float32(1.0) - np.float32(B2) ** np.float32(count))


@pytest.mark.parametrize("iteration", [0, 1, 2, 3])
def test_a2c_table_scalars_equal_the_host_functions(iteration):
    cfg = TRAINERS["a2c"][1]
    table = a2c.make_schedule(cfg)
    counter = torch.tensor([iteration])
    # One optimizer step per iteration: Adam's count is the iteration's,
    # read before the step.
    lr, bc1, bc2 = scalars_at(table.optimizer, counter).numpy()
    assert lr == np.float32(linear_schedule(cfg.lr, cfg.lr_final, cfg.anneal_iters)(iteration))
    assert (bc1, bc2) == _bias_corrections(iteration + 1)
    (ent,) = table.coefficients_at(counter).numpy()
    assert ent == np.float32(a2c.entropy_coef_at(cfg, iteration))


@pytest.mark.parametrize("iteration", [0, 1, 2, 3])
def test_ppo_table_scalars_equal_the_host_functions(iteration):
    """Per optimizer step, with the horizon anneal_iters·epochs·minibatches;
    clip-ε and the entropy coefficient per iteration."""
    cfg = TRAINERS["ppo"][1]
    steps = cfg.epochs * cfg.num_minibatches
    table = ppo.make_schedule(cfg)
    counter = torch.tensor([iteration])
    schedule = linear_schedule(cfg.lr, cfg.lr_final, cfg.anneal_iters * steps)
    for j in range(steps):
        count = iteration * steps + j
        lr, bc1, bc2 = scalars_at(table.optimizer, torch.tensor([count])).numpy()
        assert lr == np.float32(schedule(count))
        assert (bc1, bc2) == _bias_corrections(count + 1)
    clip_eps, ent = table.coefficients_at(counter).numpy()
    progress = ppo.anneal_progress(cfg, iteration)
    assert clip_eps == np.float32(ppo.clip_eps_at(cfg, progress))
    assert ent == np.float32(ppo.entropy_coef_at(cfg, progress))


@pytest.mark.parametrize("count", [3199, 3200, 3201, 17319, 17320, 17321, 50_000])
def test_table_lookups_past_its_end_stay_exact(count):
    """The table stops where every column has become constant (the lr at
    its final value, both corrections 1.0) and lookups clamp there: at
    `ppo_cartpole`'s horizon (3,200 steps) and past the last row the values
    are still the host functions'."""
    from actor_critic_tpu_torch.config import PRESETS

    cfg = PRESETS["ppo_cartpole"].config
    opt = ppo.make_optimizer(cfg)
    table = ppo.make_schedule(cfg)
    row = scalars_at(table.optimizer, torch.tensor([count])).numpy()
    assert tuple(row) == tuple(np.float32(x) for x in opt.scalars(count))
    assert table.optimizer.shape[0] == len(_bias_correction_table()) == 17_321
    assert tuple(_bias_correction_table()[-2]) != (1.0, 1.0)


def test_capturable_flags_and_cpu_loop_runs_eagerly():
    assert (a2c.CAPTURABLE, ppo.CAPTURABLE, impala.CAPTURABLE) == (True, True, True)
    assert (ddpg.CAPTURABLE, sac.CAPTURABLE) == (True, True)
    mod, cfg = TRAINERS["ppo"]
    state, metrics = loop.fused_train_loop(
        mod.make_train_step, mod.init_state, make_cartpole(), cfg,
        loop.WARMUP_ITERATIONS + 2, device="cpu", capturable=True)
    assert state.update_step == loop.WARMUP_ITERATIONS + 2
    assert all(np.isfinite(float(v)) for v in metrics.values())


# Eval cases: (env maker, typed-eval member or None, num_steps). CartPole's
# untrained greedy episodes all end in the first block (the early stop);
# the mixture's pinned Pendulum fleet never terminates, so every block and
# the tail run; Pong's pixels go through the CNN.
EVAL_CASES = {
    "cartpole": (make_cartpole, None, 3 * EVAL_CHECK_EVERY + 5),
    "pong": (lambda: make_pong(size=42, max_steps=30), None, 2 * EVAL_CHECK_EVERY + 3),
    **{f"mixture_type{t}": (lambda: make_mixture(randomize=0.2, redraw_types=True), t,
                            2 * EVAL_CHECK_EVERY + 5) for t in range(4)},
}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_blocked_eval_equals_the_plain_loop(name):
    """`BlockedEval`, run eagerly, against `evaluate` from one generator
    state: the same return and the same generator state after, twice over
    the same buffers (a later eval), with the typed reset given its type as
    a tensor, as the CLI passes it on the card."""
    make_env, type_id, num_steps = EVAL_CASES[name]
    env = make_env()
    trainer = "impala" if name == "pong" else "a2c"
    mod, cfg = TRAINERS[trainer]
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    act = lambda obs: state.net(obs)[0].mode()
    reset = env.reset if type_id is None else (
        lambda k, g: env.reset_typed(k, g, torch.tensor(type_id)))
    blocked = BlockedEval(env, act, 6, num_steps)
    assert blocked.blocks[-1] == num_steps % EVAL_CHECK_EVERY
    for seed in (5, 6):
        g_plain, g_blocked = (torch.Generator().manual_seed(seed) for _ in range(2))
        want = evaluate(env, act, g_plain, 6, num_steps, reset)
        got = blocked(g_blocked, reset)
        assert torch.equal(got, want), (float(got), float(want))
        assert torch.equal(g_blocked.get_state(), g_plain.get_state())
    if type_id is not None:
        assert torch.all(blocked.buffers[0].type_id == type_id)
        # The typed eval through the CLI's function gives the same return.
        ev = make_typed_eval(env)(state, torch.Generator().manual_seed(6), torch.tensor(type_id),
                                  6, num_steps)
        assert torch.equal(ev, want)


@pytest.mark.parametrize("trainer", ["a2c", "impala"])
def test_chunked_loop_equals_per_iteration(trainer):
    """`chunk=4` over 10 iterations (two chunks and a tail of 2) equals the
    per-iteration loop, bit for bit, and logs at the chunk boundaries and
    the end."""
    mod, cfg = TRAINERS[trainer]
    env = make_cartpole() if trainer == "a2c" else make_pong(size=42)
    runs = {}
    for chunk in (1, 4):
        logged = []
        state, metrics = loop.fused_train_loop(
            mod.make_train_step, mod.init_state, env, cfg, 10, device="cpu", chunk=chunk,
            log_every=4, log_fn=lambda it, m, logged=logged: logged.append(it))
        runs[chunk] = ({k: t.clone() for k, t in carried_tensors(state).items()},
                       metrics, logged, state.generator.get_state())
    (t1, m1, log1, g1), (t4, m4, log4, g4) = runs[1], runs[4]
    assert all(torch.equal(t1[k], t4[k]) for k in t1)
    assert all(torch.equal(m1[k], m4[k]) for k in m1)
    assert torch.equal(g1, g4)
    assert log1 == [1, 4, 8, 10] and log4 == [4, 8, 10]


# Off-policy steps at a tiny size: a 20-slot ring that 16 inserts an
# iteration wrap at the second step, and a gate that opens at the first
# (warm-up 8 env steps, batch 8).
_OFF = dict(steps_per_iter=4, updates_per_iter=2, buffer_capacity=20, batch_size=8,
            hidden=(8,), warmup_steps=8)
OFFPOLICY_CASES = {
    "ddpg": (ddpg, ddpg.DDPGConfig(num_envs=4, **_OFF), make_point_mass),
    "td3_mixed": (ddpg, ddpg.td3_config(num_envs=4, replay_dtype="mixed", **_OFF), make_pendulum),
    "td3_nstep": (ddpg, ddpg.td3_config(num_envs=1, nstep=3, **{**_OFF, "steps_per_iter": 16}),
                  make_point_mass),
    "sac_int8": (sac, sac.SACConfig(num_envs=4, replay_dtype="int8", **_OFF), make_pendulum),
}


@pytest.mark.parametrize("name", sorted(OFFPOLICY_CASES))
def test_offpolicy_step_writes_the_state_in_place(name):
    mod, cfg, make_env = OFFPOLICY_CASES[name]
    env = make_env()
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    step = mod.make_train_step(env, cfg)
    before = {k: (t.data_ptr(), t.clone()) for k, t in carried_tensors(state).items()}
    assert len({ptr for ptr, _ in before.values()}) == len(before)  # no two share storage
    for it in (1, 2, 3):
        state, metrics = step(state)
        now = carried_tensors(state)
        assert sorted(now) == sorted(before)
        moved = [k for k, (ptr, _) in before.items() if now[k].data_ptr() != ptr]
        assert not moved, f"rebound after step {it}: {moved}"
    assert all(np.isfinite(float(v)) for v in metrics.values())
    changed = {k for k, (_, old) in before.items() if not torch.equal(now[k], old)}
    ring = {k for k in before if k.startswith("learner.replay storage.")}
    assert len(ring) == 6
    # Neither env ends an episode in these 12 steps: the flags stay 0.
    assert {f"learner.replay storage.{k}" for k in ("obs", "action", "reward", "next_obs")} <= (
        changed)
    expected = ["learner.replay insert_pos", "learner.replay size", "learner.update_count",
                "learner.critic_opt count", "learner.actor_opt count", "env_steps",
                "step_counter", "rollout obs",
                # n-step's 16-step iterations end each point-mass episode.
                "avg_return" if name == "td3_nstep" else "ep_length",
                "learner.actor torso.dense_0.weight", "learner.critic_opt mu q1.q.weight"
                if mod is sac or cfg.twin_q else "learner.critic_opt mu q.weight",
                "learner.target_critic " + ("q1.q.bias" if mod is sac or cfg.twin_q else "q.bias")]
    if mod is ddpg:
        expected.append("learner.target_actor action.weight")
    else:
        expected += ["learner.log_alpha", "learner.alpha_opt count"]
    if cfg.replay_dtype != "fp32":
        expected += ["learner.replay quant.obs.mean", "learner.replay quant.reward.scale"]
    for k in expected:
        assert k in changed, k
    assert state.update_step == 3
    assert int(state.learner.update_count) == 3 * cfg.updates_per_iter
    assert int(state.learner.replay.size) == cfg.buffer_capacity


@pytest.mark.parametrize("name", ["td3_mixed", "sac_int8"])
def test_offpolicy_chunked_loop_equals_per_iteration(name):
    mod, cfg, make_env = OFFPOLICY_CASES[name]
    env = make_env()
    runs = {}
    for chunk in (1, 4):
        state, metrics = loop.fused_train_loop(
            mod.make_train_step, mod.init_state, env, cfg, 10, device="cpu", chunk=chunk)
        runs[chunk] = ({k: t.clone() for k, t in carried_tensors(state).items()}, metrics,
                       state.generator.get_state())
    (t1, m1, g1), (t4, m4, g4) = runs[1], runs[4]
    assert all(torch.equal(t1[k], t4[k]) for k in t1)
    assert all(torch.equal(m1[k], m4[k]) for k in m1)
    assert torch.equal(g1, g4)
