"""The port's scenario-mixture fleet (`envs/mixture.py`) and the
`a2c_mixture` slice against the JAX package's `envs/mixture.py` and A2C.

- Spec, masks, curriculum grammar and controller, eval-matrix fields:
  pure Python in both packages, held equal.
- A T=8 rollout of the 4-type fleet at E=64, from the JAX fleet's states
  (every member slot, converted) with actions made by numpy from a seed:
  each step's obs, reward, done, terminated, pre-reset obs and type, and
  every member slot, agree with JAX's until each instance's first episode
  end, at 1e-6 (atol and rtol, float32 physics through 8 steps).
- The slice as a whole: one A2C update (truncation bootstrap, GAE, loss,
  clipped Adam) on that rollout with converted parameters, against
  `jax.value_and_grad(a2c_loss)` and the optax step: losses 1e-5,
  parameters atol 1e-5·lr + rtol 1e-6 (`tests/test_torch_a2c.py`'s
  tolerances and reasons).
- Draws (types, resets) come from another generator than JAX's: they are
  held by frequency, determinism under one seed and the invariants the
  JAX tests hold (masked lanes, types kept or redrawn by the weights).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import a2c as ja2c
from actor_critic_tpu.algos import common as jcommon
from actor_critic_tpu.envs import make_mixture as make_jax_mixture
from actor_critic_tpu.envs import mixture as jmx
from actor_critic_tpu_torch import config as tconfig
from actor_critic_tpu_torch import train, weights
from actor_critic_tpu_torch.algos import a2c as ta2c
from actor_critic_tpu_torch.algos import common as tcommon
from actor_critic_tpu_torch.envs import make_cartpole, make_mixture, make_pendulum
from actor_critic_tpu_torch.envs import mixture as mx
from actor_critic_tpu_torch.tree import named_leaves, tree_map
from torch_env_states import to_port

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
MEMBERS = "cartpole,pendulum,acrobot,maze"
E, T = 64, 8


def _own(state):
    """A fleet state whose every leaf has storage of its own (as the
    trainer's `init_rollout` makes it), so it can be written in place."""
    return tree_map(lambda x: x.clone(memory_format=torch.contiguous_format), state)


# ---------------------------------------------------------------------------
# Spec and interface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "cartpole*2,pendulum, acrobot", "maze", ["cartpole", "maze*0.5"],
    "cartpole,frogger", "cartpole,cartpole", "cartpole*fast", "cartpole*-1",
    "cartpole*0,maze*0", "",
])
def test_spec_parsing_matches_jax(spec):
    try:
        want = jmx.parse_mixture_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(";")[0][:20]):
            mx.parse_mixture_spec(spec)
    else:
        assert mx.parse_mixture_spec(spec) == want


def test_padded_interface_spec():
    env, jenv = make_mixture(MEMBERS), make_jax_mixture(MEMBERS)
    assert (env.spec.obs_shape, env.spec.action_dim, env.spec.discrete, env.spec.can_truncate,
            env.spec.episode_horizon) == (jenv.spec.obs_shape, jenv.spec.action_dim,
                                          jenv.spec.discrete, jenv.spec.can_truncate,
                                          jenv.spec.episode_horizon) == ((13,), 5, True, True, 500)
    assert env.member_names == jenv.member_names == tuple(MEMBERS.split(","))
    np.testing.assert_array_equal(env.obs_masks.numpy(), np.asarray(jenv.obs_masks))
    np.testing.assert_array_equal(env.obs_masks.numpy().sum(axis=1), [4, 3, 6, 13])
    small = make_mixture("cartpole,maze", member_kwargs={"maze": {"size": 5}})
    assert small.member_specs[1].obs_shape == (13,) and small.member_specs[1].episode_horizon == 40
    with pytest.raises(ValueError, match="non-member"):
        make_mixture("cartpole", member_kwargs={"pendulum": {}})


def test_obs_lanes_masked_and_fleet_seeded():
    env = make_mixture(MEMBERS, randomize=0.2)
    s, obs = env.reset(E, torch.Generator().manual_seed(2))
    s2, obs2 = env.reset(E, torch.Generator().manual_seed(2))
    assert torch.equal(obs, obs2) and torch.equal(s.type_id, s2.type_id)
    assert set(s.type_id.tolist()) == {0, 1, 2, 3}
    out = env.step(s, torch.zeros(E, dtype=torch.int64), torch.Generator().manual_seed(3))
    masks = env.obs_masks[s.type_id]
    for arr in (obs, out.obs, out.info["final_obs"]):
        assert torch.all(arr * (1.0 - masks) == 0.0)


def test_weighted_type_draw():
    env = make_mixture("cartpole*9,maze")
    s, _ = env.reset(4096, torch.Generator().manual_seed(1))
    assert 0.87 < float((s.type_id == 0).float().mean()) < 0.93  # 9:1 weights
    # An all-zero weight row draws uniformly, with no bias to type 0.
    u = torch.rand(40_000, generator=torch.Generator().manual_seed(0))
    counts = torch.bincount(mx._draw_types(torch.zeros(40_000, 4), u), minlength=4)
    np.testing.assert_allclose(counts.numpy() / 40_000, 0.25, atol=0.01)
    # A zero-weight type is never drawn.
    assert not torch.any(mx._draw_types(torch.tensor([[1.0, 0.0, 2.0]]).expand(40_000, 3), u) == 1)


def test_action_adapter_continuous_member():
    """The five discrete actions map onto the pendulum's normalized torque
    levels −1, −½, 0, ½, 1 (JAX's `linspace(−1, 1, 5)`): from one state the
    mixture's pendulum slot steps as the pendulum env does under those
    torques, bit for bit, and the next speeds are ordered by the level."""
    env = make_mixture("pendulum", action_bins=5)
    s, _ = env.reset(5, torch.Generator().manual_seed(6))
    pend = s.members[0]._replace(theta=torch.full((5,), 0.3), theta_dot=torch.zeros(5))
    out = env.step(s._replace(members=(pend,)), torch.arange(5), torch.Generator())
    levels = torch.tensor([[-1.0], [-0.5], [0.0], [0.5], [1.0]])
    want = make_pendulum().step(pend, levels, torch.Generator())
    v = out.state.members[0].theta_dot
    assert torch.equal(v, want.state.theta_dot) and torch.equal(out.reward, want.reward)
    assert torch.all(v.diff() > 0)


def test_type_preserved_across_auto_reset():
    """An episode end re-rolls the member's scenario, never the type."""
    env = make_mixture(MEMBERS, randomize=0.2)
    s, _ = env.reset(E, torch.Generator().manual_seed(3))
    s = s._replace(members=tuple(m._replace(t=torch.full_like(m.t, 10_000)) for m in s.members))
    out = env.step(s, torch.zeros(E, dtype=torch.int64), torch.Generator().manual_seed(4))
    assert torch.all(out.done == 1.0)
    assert torch.equal(out.state.type_id, s.type_id)
    cart = s.type_id == 0
    before = s.members[0].scenario[cart, 2]
    after = out.state.members[0].scenario[cart, 2]
    assert torch.all(before != after)
    # The parked slots (every other type's) did not move.
    for i, m in enumerate(out.state.members):
        parked = s.type_id != i
        for got, old in zip(m, s.members[i]):
            assert torch.equal(got[parked], old[parked])


def test_single_type_mixture_equals_the_homogeneous_fleet():
    """The padded interface is a view, not another simulation: a one-type
    mixture's obs lanes, reward and done equal the CartPole fleet's bit for
    bit, auto-resets included (one generator, drawn in the same order)."""
    menv, cenv = make_mixture("cartpole"), make_cartpole()
    ms, _ = menv.reset(16, torch.Generator().manual_seed(4))
    cs = ms.members[0]
    mg, cg = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    acts = torch.randint(0, 2, (60, 16), generator=torch.Generator().manual_seed(6))
    saw_done = False
    for t in range(60):
        mout, cout = menv.step(ms, acts[t], mg), cenv.step(cs, acts[t], cg)
        assert torch.equal(mout.obs[:, :4], cout.obs) and torch.all(mout.obs[:, 4:] == 0)
        assert torch.equal(mout.reward, cout.reward) and torch.equal(mout.done, cout.done)
        saw_done |= bool(mout.done.any())
        ms, cs = mout.state, cout.state
    assert saw_done


# ---------------------------------------------------------------------------
# A T=8 rollout against JAX, and one A2C update on it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_rollout():
    """The JAX fleet's start and its T=8 steps under numpy actions: the
    first 8 instances start 2 steps from every member's time limit, so
    episode ends fall inside the window."""
    jenv = make_jax_mixture(MEMBERS, randomize=0.2)
    js, jobs = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.key(0), E))
    near = jnp.asarray(np.arange(E) < 8)
    limits = (500, 200, 500, 64)
    js = js._replace(members=tuple(
        m._replace(t=jnp.where(near, lim - 2, m.t).astype(m.t.dtype))
        for m, lim in zip(js.members, limits)))
    actions = np.random.default_rng(0).integers(0, 5, size=(T, E)).astype(np.int32)
    step = jax.jit(jax.vmap(jenv.step))
    outs, states, s = [], [js], js
    for t in range(T):
        out = step(s, jnp.asarray(actions[t]))
        outs.append(out)
        s = out.state
        states.append(s)
    assert set(np.asarray(js.type_id).tolist()) == {0, 1, 2, 3}
    return dict(start=js, start_obs=jobs, actions=actions, outs=outs, states=states)


def test_rollout_matches_jax_until_first_episode_end(jax_rollout):
    env = make_mixture(MEMBERS, randomize=0.2)
    like, _ = env.reset(E, torch.Generator().manual_seed(0))
    state = to_port(jax_rollout["start"], like)
    gen = torch.Generator().manual_seed(1)
    alive = np.ones(E, bool)
    ended = 0
    for t in range(T):
        out = env.step(state, torch.from_numpy(jax_rollout["actions"][t]), gen)
        jout = jax_rollout["outs"][t]
        m = alive
        for got, want in ((out.reward, jout.reward), (out.info["final_obs"], jout.info["final_obs"])):
            np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m], **TOL)
        for got, want in ((out.done, jout.done), (out.info["terminated"], jout.info["terminated"]),
                          (out.info["type_id"], jout.info["type_id"])):
            np.testing.assert_array_equal(got.numpy()[m], np.asarray(want)[m])
        j_done = np.asarray(jout.done) == 1
        cont = m & ~j_done
        np.testing.assert_allclose(out.obs.numpy()[cont], np.asarray(jout.obs)[cont], **TOL)
        # Every member slot of a running instance: the active one stepped,
        # the parked ones untouched, on both sides.
        jstate = to_port(jout.state, like)
        for name, leaf in named_leaves(out.state).items():
            want = named_leaves(jstate)[name]
            np.testing.assert_allclose(leaf.numpy()[cont], want.numpy()[cont], **TOL, err_msg=name)
        ended += int((m & j_done).sum())
        alive = cont
        state = out.state
    assert ended >= 8, ended
    assert alive.sum() > E // 2


def test_a2c_update_on_the_mixture_batch_matches_jax(jax_rollout):
    """The slice as a whole on the 4-type batch: the JAX update as
    `a2c.make_train_step` composes it (values and log-probs from the net,
    truncation bootstrap at the pre-reset obs, GAE, `a2c_loss`'s value and
    grad, the optax step) against the port's `a2c.update` on the same
    Transition and converted parameters."""
    kw = dict(num_envs=E, rollout_steps=T, lr=1e-3, anneal_iters=10, lr_final=0.0,
              entropy_coef=0.01, entropy_coef_final=0.0)
    jcfg, cfg = ja2c.A2CConfig(**kw), ta2c.A2CConfig(**kw)
    jenv, env = make_jax_mixture(MEMBERS, randomize=0.2), make_mixture(MEMBERS, randomize=0.2)
    jnet = ja2c.make_network(jenv, jcfg)
    params = jax.jit(jnet.init)(jax.random.key(3), jnp.zeros((1, 13), jnp.float32))
    apply = jax.jit(jnet.apply)
    outs = jax_rollout["outs"]
    obs = jnp.stack([jax_rollout["start_obs"]] + [o.obs for o in outs[:-1]])
    dist, value = apply(params, obs.reshape(T * E, 13))
    actions = jnp.asarray(jax_rollout["actions"])
    jtraj = jcommon.Transition(
        obs=obs, action=actions,
        log_prob=dist.log_prob(actions.reshape(-1)).reshape(T, E), value=value.reshape(T, E),
        reward=jnp.stack([o.reward for o in outs]), done=jnp.stack([o.done for o in outs]),
        terminated=jnp.stack([o.info["terminated"] for o in outs]),
        final_obs=jnp.stack([o.info["final_obs"] for o in outs]),
    )
    assert float(jnp.sum(jtraj.done)) >= 8 and float(jnp.sum(jtraj.terminated)) < float(jnp.sum(jtraj.done))
    next_obs = outs[-1].obs

    _, boot = apply(params, next_obs)
    _, fv = apply(params, jtraj.final_obs.reshape(T * E, 13))
    rewards = jcommon.truncation_bootstrap_rewards(jtraj, fv.reshape(T, E), jcfg.gamma)
    adv, ret = jcommon.gae_targets(rewards, jtraj.value, jtraj.done, boot, jcfg.gamma, jcfg.gae_lambda)
    coef = ja2c.entropy_coef_at(jcfg, jnp.asarray(0, jnp.int32))
    (_, jmetrics), grads = jax.jit(lambda p: jax.value_and_grad(ja2c.a2c_loss, has_aux=True)(
        p, jnet.apply, jtraj, adv, ret, jcfg, None, coef))(params)
    opt = ja2c.make_optimizer(jcfg)
    updates, _ = jax.jit(lambda g: opt.update(g, opt.init(params), params))(grads)
    new_params = jax.tree.map(lambda p, u: p + u, params, updates)

    tnet = ta2c.make_network(env, cfg)
    tnet.load_state_dict(weights.from_flax(jax.device_get(params)))
    topt = ta2c.make_optimizer(cfg)
    tstate = tcommon.TrainState(
        net=tnet, opt_state=topt.init(dict(tnet.named_parameters())),
        rollout=tcommon.RolloutState(env_state=None, obs=torch.from_numpy(np.array(next_obs))),
        generator=torch.Generator(),
        ep_return=torch.zeros(E), ep_length=torch.zeros(E), avg_return=torch.zeros(()),
        step_counter=torch.zeros(1, dtype=torch.int64), schedule=ta2c.make_schedule(cfg),
    )
    ttraj = tcommon.Transition(*(torch.from_numpy(np.array(x)) for x in jtraj))
    tmetrics = ta2c.update(env, cfg, topt, tstate, ttraj)
    for k in ("loss", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), **GRAD_TOL, err_msg=k)
    # Adam's first step moves a parameter by lr·g/(|g| + 1e-8): where |g| is
    # within 100× that eps (a few elements here, in the torso weights of
    # lanes few types fill), the last bits of g, summed in
    # another order by XLA, move it by a visible share of lr. There the two
    # steps are held to the same direction and to |step| <= lr; elsewhere to
    # atol 1e-5·lr + rtol 1e-6.
    got = dict(tnet.named_parameters())
    jgrads = weights.from_flax(jax.device_get(grads))
    start = weights.from_flax(jax.device_get(params))
    for k, v in weights.from_flax(jax.device_get(new_params)).items():
        p, want, p0 = got[k].detach().numpy(), v.numpy(), start[k].numpy()
        sensitive = np.abs(jgrads[k].numpy()) < 100 * 1e-8
        assert sensitive.mean() < 0.01, k
        np.testing.assert_allclose(p[~sensitive], want[~sensitive], rtol=1e-6,
                                   atol=1e-5 * cfg.lr, err_msg=k)
        step, jstep = (p - p0)[sensitive], (want - p0)[sensitive]
        assert np.all(np.sign(step) == np.sign(jstep)), k
        assert np.all(np.abs(step) <= cfg.lr) and np.all(np.abs(jstep) <= cfg.lr), k
    assert not np.allclose(got["policy.weight"].detach().numpy(),
                           weights.from_flax(jax.device_get(params))["policy.weight"].numpy())


# ---------------------------------------------------------------------------
# Curriculum and per-type eval
# ---------------------------------------------------------------------------

def test_curriculum_parse_matches_jax():
    names = ("cartpole", "maze")
    for spec in ("100:1,2;400:0,1", " -5:0,1 ;", "1e3:2.5,0"):
        got, want = mx.parse_curriculum(spec, names), jmx.parse_curriculum(spec, names)
        assert (got.thresholds, got.stage_weights) == (want.thresholds, want.stage_weights)
    cur = mx.parse_curriculum("100:1,2;400:0,1", names)
    assert (cur.thresholds, cur.stage_weights, cur.n_stages) == (
        (100.0, 400.0), ((1.0, 2.0), (0.0, 1.0)), 3)
    for spec, match in (("100:1,2,3", "weights"), ("100:1,2;50:2,1", "increasing"),
                        (";", "no stages"), ("100", "not 'THRESHOLD"), ("x:1,2", "bad curriculum"),
                        ("5:0,0", "all zero")):
        for parse in (mx.parse_curriculum, jmx.parse_curriculum):
            with pytest.raises(ValueError, match=match):
                parse(spec, names)


def test_curriculum_controller_advances_and_syncs():
    cur = mx.parse_curriculum("10:1,2;20:0,1", ("cartpole", "maze"))
    ctl = mx.CurriculumController(cur)
    assert ctl.update(5.0) is None and ctl.stage == 0
    assert ctl.update(12.0) == (1, (1.0, 2.0))
    ctl2 = mx.CurriculumController(cur)
    assert ctl2.update(25.0) == (2, (0.0, 1.0))  # one jump, several thresholds
    assert ctl2.update(-100.0) is None and ctl2.stage == 2  # never demotes
    ctl3 = mx.CurriculumController(cur)
    ctl3.sync(1)
    assert ctl3.stage == 1 and ctl3.update(12.0) is None
    ctl3.sync(99)
    assert ctl3.stage == 2


def test_redraw_follows_the_weights_written_in_place():
    """`set_fleet_weights` writes weights and stage into the state's own
    storage; with redraw on, episode ends then draw every type from them."""
    env = make_mixture("cartpole,maze", redraw_types=True)
    s, _ = env.reset(32, torch.Generator().manual_seed(7))
    s = _own(s)
    ptrs = (s.weights.data_ptr(), s.stage.data_ptr())
    mx.set_fleet_weights(s, (0.0, 1.0), stage=1)
    assert (s.weights.data_ptr(), s.stage.data_ptr()) == ptrs
    assert torch.all(s.weights == torch.tensor([0.0, 1.0])) and mx.fleet_stage(s) == 1
    with pytest.raises(ValueError, match="types"):
        mx.set_fleet_weights(s, (1.0, 0.0, 0.0), stage=2)
    s = s._replace(members=tuple(m._replace(t=torch.full_like(m.t, 10_000)) for m in s.members))
    out = env.step(s, torch.zeros(32, dtype=torch.int64), torch.Generator().manual_seed(8))
    assert torch.all(out.state.type_id == 1) and mx.fleet_stage(out.state) == 1
    assert mx.type_shares(out.state, 2) == [0.0, 1.0]
    # A changed instance shows the new member's fresh obs: the maze's 13 lanes.
    changed = s.type_id == 0
    assert torch.all(out.obs[changed, 9:11] >= 0) and torch.all(out.state.members[1].t[changed] == 0)


def test_typed_eval_pins_types():
    env = make_mixture("cartpole,maze", redraw_types=True)
    for t in range(2):
        s, _ = env.reset_typed(16, torch.Generator().manual_seed(8), t)
        assert torch.all(s.type_id == t)
    cfg = ta2c.A2CConfig(num_envs=8, rollout_steps=2, hidden=(8,))
    state = ta2c.init_state(env, cfg, seed=0, device="cpu")
    ev = mx.make_typed_eval(env)
    rets = [float(ev(state, torch.Generator().manual_seed(9), t, 4, 16)) for t in range(2)]
    assert all(np.isfinite(r) for r in rets)
    # CartPole pays +1 a step, the maze its step costs.
    assert rets[0] > 0 > rets[1]


@pytest.mark.parametrize("name,ret", [("cartpole", 500.0), ("acrobot", -450.0), ("maze", -0.1234)])
def test_eval_matrix_row_matches_jax(name, ret):
    assert mx.eval_matrix_row(name, ret) == jmx.eval_matrix_row(name, ret)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def small_mixture_preset(monkeypatch):
    """`a2c_mixture` at E=64, T=8, with 32-step evals: the CLI's path at
    a size the CPU runs in seconds."""
    preset = tconfig.PRESETS["a2c_mixture"]
    monkeypatch.setitem(tconfig.PRESETS, "a2c_mixture", dataclasses.replace(
        preset, config=dataclasses.replace(preset.config, num_envs=64, rollout_steps=8)))
    monkeypatch.setattr(tcommon, "default_eval_steps", lambda env: 32)


def _rows(capsys):
    import json
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_cli_drive_with_the_per_type_eval(small_mixture_preset, capsys):
    assert train.main(["--preset", "a2c_mixture", "--iterations", "2", "--eval-every", "2",
                       "--device", "cpu"]) == 0
    rows = _rows(capsys)
    last = rows[-2]
    assert last["iter"] == 2 and rows[-1]["env"] == "mixture:" + MEMBERS
    for name in MEMBERS.split(","):
        assert np.isfinite(last[f"eval_return_{name}"])
        assert 0.0 < last[f"fleet_share_{name}"] < 1.0
    assert last["fleet_stage"] == 0 and "curriculum_stage" not in last


def test_cli_curriculum_installs_weights_before_the_next_iteration(small_mixture_preset, capsys):
    assert train.main(["--preset", "a2c_mixture", "--iterations", "6", "--eval-every", "2",
                       "--curriculum=-1e9:0,0,0,1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "curriculum: eval" in out and "stage 1, weights [0.0, 0.0, 0.0, 1.0]" in out
    import json
    rows = {r["iter"]: r for r in map(json.loads, (l for l in out.splitlines() if l.startswith("{")))
            if "iter" in r}
    assert [rows[i]["curriculum_stage"] for i in (2, 4, 6)] == [1, 1, 1]
    # Iteration 2's row was read before the install, the later ones after.
    assert rows[2]["fleet_stage"] == 0 and rows[4]["fleet_stage"] == rows[6]["fleet_stage"] == 1
    assert rows[6]["fleet_share_maze"] > rows[2]["fleet_share_maze"]


@pytest.mark.parametrize("argv,match", [
    (["--preset", "a2c_cartpole", "--curriculum", "0:1", "--eval-every", "1"], "mixture"),
    (["--preset", "a2c_mixture", "--curriculum", "0:1,1,1,1"], "--eval-every"),
    (["--preset", "a2c_mixture", "--curriculum", "0:1,1", "--eval-every", "1"], "bad --curriculum"),
    (["--preset", "a2c_mixture", "--env-set", "gravity=3"], "unknown kwargs"),
])
def test_cli_argument_errors_exit_before_device_work(argv, match, monkeypatch):
    # Asking for the card here would raise RuntimeError; these exit first.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if "--env-set" in argv:  # the env is made after the device: pass the CPU
        argv = argv + ["--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        train.main(argv)
