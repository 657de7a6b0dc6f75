"""What a CUDA graph of the A2C and PPO train steps relies on, checked on the
CPU, where the same step runs eagerly (`algos/loop.py`):

- every tensor the train state carries from one iteration to the next
  keeps its storage across steps (a replay reads and writes the addresses
  its capture saw, so a rebound tensor would be read stale);
- the step-dependent scalars the step reads from the schedule table on the
  device (at Adam's count and at the step counter) equal, bit for bit, the
  host functions the eager code used (`a2c.entropy_coef_at`,
  `linear_schedule`, optax's bias corrections);
- which trainers the loop captures, and that it runs the CPU eagerly;
- the same of the mixture fleet's nested state (`a2c_mixture` at a tiny
  size), and of a `state_hook` that installs curriculum weights.
"""

import numpy as np
import pytest
import torch

from actor_critic_tpu_torch.algos import a2c, impala, loop, ppo
from actor_critic_tpu_torch.envs import make_cartpole, make_mixture, make_pong
from actor_critic_tpu_torch.envs.mixture import set_fleet_weights
from actor_critic_tpu_torch.optim import (
    B1,
    B2,
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
}
# The trainers' step on each env: CartPole, and A2C on the four-type
# mixture fleet (a nested state: one slot per member type).
STEP_CASES = {
    "a2c": ("a2c", make_cartpole),
    "ppo": ("ppo", make_cartpole),
    "a2c_mixture": ("a2c", lambda: make_mixture(randomize=0.2, redraw_types=True)),
}


def _carried(state) -> dict[str, torch.Tensor]:
    """Every tensor a train step reads from `state` and writes back."""
    out = {f"param {k}": p for k, p in state.net.named_parameters()}
    out.update({f"mu {k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu {k}": v for k, v in state.opt_state.nu.items()})
    out["adam count"] = state.opt_state.count
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
    # Checked after each step: after a rebinding, the first step's new tensor
    # is allocated while the old one is alive, so its address differs.
    for it in (1, 2):
        state, _ = step(state)
        now = _carried(state)
        assert sorted(now) == sorted(before)
        moved = [k for k, (ptr, _) in before.items() if now[k].data_ptr() != ptr]
        assert not moved, f"rebound after step {it}: {moved}"
    # And the step did write them: everything but the Adam moments of
    # parameters without a gradient has new values.
    changed = {k for k, (_, old) in before.items() if not torch.equal(now[k], old)}
    env_leaves = ("env x", "env t") if name != "a2c_mixture" else tuple(
        f"env members.{i}.t" for i in range(4) if bool((state.rollout.env_state.type_id == i).any()))
    assert env_leaves
    for k in ("rollout obs", "ep_return", "ep_length", "step_counter", "adam count",
              "param policy.weight", "mu policy.weight", "nu value.bias", *env_leaves):
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
    assert (a2c.CAPTURABLE, ppo.CAPTURABLE, impala.CAPTURABLE) == (True, True, False)
    mod, cfg = TRAINERS["ppo"]
    state, metrics = loop.fused_train_loop(
        mod.make_train_step, mod.init_state, make_cartpole(), cfg,
        loop.WARMUP_ITERATIONS + 2, device="cpu", capturable=True)
    assert state.update_step == loop.WARMUP_ITERATIONS + 2
    assert all(np.isfinite(float(v)) for v in metrics.values())
