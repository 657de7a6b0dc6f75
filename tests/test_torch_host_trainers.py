"""The port's host trainers (`ppo.train_host`, `ddpg.train_host`,
`sac.train_host` over `algos/host_loop.py`) against the JAX package's, on
the CPU:

- the first block, bit for bit: the port's `train_host` from the JAX
  package's initial parameters (converted), seed and pool collects the
  block that the JAX trainer's collection (its mirror, its numpy generator
  seeded `seed + 0x5EED`) collects: obs, actions, log-probs, values,
  rewards, dones, `final_obs`, and for PPO the mirror's truncation and
  rollout bootstraps; for SAC across the end of the warm-up;
- one host update on one block, with the JAX package's draws given to the
  port: PPO's (`make_host_update_fn`, JAX's permutations; with the
  mirror's baselines and without, annealed), within the fused PPO
  update's bound (test_torch_ppo.py: atol 1e-6, rtol 1e-5 on parameters,
  Adam moments and metrics: float32 sums in another order); DDPG's, TD3's
  and SAC's ingest (the ring written bit for bit, the gate) and two
  updates with the draws of JAX's key chain, within the fused updates'
  bounds (test_torch_ddpg.py, test_torch_sac.py: parameters, targets and
  log α within 1e-6, Adam moments within 1e-6 of their scale, counts and
  the ring exact);
- the loop's mechanics: `BlockBuffers`' double buffering and static
  upload buffers, `HostUpdate`'s eager path on the CPU, and the learning
  run on the engine's Acrobot (slow).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import ddpg as jddpg
from actor_critic_tpu.algos import host_loop as jloop
from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu.algos import sac as jsac
from actor_critic_tpu.algos.common import OffPolicyTransition as JTransition
from actor_critic_tpu.envs.host_pool import HostEnvPool as JaxPool
from actor_critic_tpu.models import host_actor as jmirror
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import ddpg as tddpg
from actor_critic_tpu_torch.algos import host_loop
from actor_critic_tpu_torch.algos import ppo as tppo
from actor_critic_tpu_torch.algos import sac as tsac
from actor_critic_tpu_torch.algos.common import OffPolicyTransition
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool
from torch_offpolicy_states import (
    ddpg_draws,
    learner_tensors,
    load_learner,
    max_differences,
    sac_draws,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _first_port_block(train, pool, cfg, **kw):
    blocks = []

    def hook(it, run):
        blocks.append({k: v.copy() for k, v in run.buffers.block().items()})

    train(pool, cfg, 1, seed=0, log_every=0, device="cpu", iteration_hook=hook, **kw)
    return blocks[0]


def _assert_blocks_equal(got, want, fields):
    for k in fields:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


PPO_POOLS = {
    "native-acrobot": ("Acrobot-v1", "native"),
    "native-pendulum": ("Pendulum-v1", "native"),
    "mujoco-halfcheetah": ("HalfCheetah-v5", "gym"),
}


@pytest.mark.parametrize("case", sorted(PPO_POOLS))
def test_ppo_first_block_equals_jax(case, monkeypatch):
    env_id, backend = PPO_POOLS[case]
    if backend == "gym":
        pytest.importorskip("mujoco")
    cfg_kw = dict(num_envs=3, rollout_steps=40, epochs=1, num_minibatches=2, hidden=(16,))
    jcfg, cfg = jppo.PPOConfig(**cfg_kw), tppo.PPOConfig(**cfg_kw)
    jpool = JaxPool(env_id, 3, seed=0, backend=backend)
    # The JAX trainer's collection: its initial parameters, its mirror, its
    # generator.
    _, pkey = jax.random.split(jax.random.key(0))
    params, _ = jppo.init_host_params(jpool.spec, jcfg, pkey)
    params = jax.device_get(params)
    policy = jmirror.make_ppo_host_policy(jpool.spec, jcfg)
    value = jmirror.make_ppo_host_value(jpool.spec, jcfg)
    rng = np.random.default_rng(0 + 0x5EED)

    def act(o):
        a, logp, v = policy(params, o, rng)
        return a, {"log_prob": logp, "value": v}

    obs, want = jloop.host_collect(jpool, jpool.reset(), 40, act, jloop.EpisodeTracker(3))
    fo = want["final_obs"]
    want = dict(want, final_values=value(params, fo.reshape(-1, fo.shape[-1])).reshape(40, 3),
                bootstrap_value=value(params, obs))

    pool = HostEnvPool(env_id, 3, seed=0, backend=backend)
    net = tppo.make_network(pool.spec, cfg)
    net.load_state_dict(weights.from_flax(params))
    opt_state = tppo.make_optimizer(cfg).init(dict(net.named_parameters()))
    monkeypatch.setattr(tppo, "init_host_params", lambda *a: (net, opt_state))
    got = _first_port_block(tppo.train_host, pool, cfg)
    _assert_blocks_equal(got, want, ("obs", "action", "log_prob", "value", "reward", "done",
                                     "terminated", "final_obs", "final_values",
                                     "bootstrap_value"))
    assert sorted(got) == sorted(want)


def test_sac_first_block_equals_jax(monkeypatch):
    """K=8, E=2, warm-up 8 env steps: the block's first 4 steps are the
    uniform warm-up draws, the last 4 the actor's samples."""
    cfg_kw = dict(num_envs=2, steps_per_iter=8, updates_per_iter=1, buffer_capacity=64,
                  batch_size=8, warmup_steps=8, hidden=(16,))
    jcfg, cfg = jsac.SACConfig(**cfg_kw), tsac.SACConfig(**cfg_kw)
    kw = dict(seed=0, backend="native", normalize_obs=False, normalize_reward=False)
    jpool = JaxPool("Pendulum-v1", 2, **kw)
    _, lkey = jax.random.split(jax.random.key(0))
    jls = jsac.init_learner(jpool.spec.obs_shape, 1, jcfg, lkey)
    params = jax.device_get(jls.actor_params)
    explore = jmirror.make_sac_host_explore(jpool.spec, jcfg)
    rng = np.random.default_rng(0 + 0x5EED)
    steps = [0]

    def act(o):
        a = explore(params, o, rng, steps[0])
        steps[0] += 2
        return a, {}

    _, want = jloop.host_collect(jpool, jpool.reset(), 8, act, jloop.EpisodeTracker(2))

    pool = HostEnvPool("Pendulum-v1", 2, **kw)
    port = tsac.init_learner(pool.spec.obs_shape, 1, cfg, device="cpu")
    load_learner(port, jls)
    monkeypatch.setattr(tsac, "init_learner", lambda *a: port)
    got = _first_port_block(tsac.train_host, pool, cfg)
    _assert_blocks_equal(got, want, ("obs", "action", "reward", "done", "terminated",
                                     "final_obs"))
    assert int(got["env_steps"]) == 16
    # The actor acted in the block's second half: not uniform draws.
    assert not np.array_equal(got["action"][4:], np.zeros_like(got["action"][4:]))


# --------------------------------------------------------- one update


def _ppo_block(rng, T, E, discrete):
    obs = rng.normal(size=(T, E, 4)).astype(np.float32)
    if discrete:
        action = rng.integers(0, 3, (T, E))
        log_prob = (np.log(1 / 3) + 0.3 * rng.normal(size=(T, E))).astype(np.float32)
    else:
        action = rng.normal(size=(T, E, 2)).astype(np.float32)
        log_prob = (-2.0 + 0.5 * rng.normal(size=(T, E))).astype(np.float32)
    done = (rng.random((T, E)) < 0.15).astype(np.float32)
    return dict(
        obs=obs, action=action, log_prob=log_prob,
        value=rng.normal(size=(T, E)).astype(np.float32),
        reward=rng.normal(size=(T, E)).astype(np.float32), done=done,
        terminated=(done * (rng.random((T, E)) < 0.5)).astype(np.float32),
        final_obs=(obs + 0.1).astype(np.float32),
        last_obs=rng.normal(size=(E, 4)).astype(np.float32),
        final_values=rng.normal(size=(T, E)).astype(np.float32),
        bootstrap_value=rng.normal(size=(E,)).astype(np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "gaussian"])
@pytest.mark.parametrize("baselines", ["mirror", "recomputed"])
def test_ppo_host_update_equals_jax(discrete, baselines):
    """Two iterations' host update (2 epochs × 4 minibatches, T=16, E=4,
    annealed lr, clip-ε and entropy), iteration 3 and 4 of 5."""
    from actor_critic_tpu.envs.jax_env import EnvSpec as JaxEnvSpec
    from actor_critic_tpu_torch.envs import EnvSpec

    A = 3 if discrete else 2
    jspec = JaxEnvSpec(obs_shape=(4,), action_dim=A, discrete=discrete)
    spec = EnvSpec(obs_shape=(4,), action_dim=A, discrete=discrete)
    kw = dict(num_envs=4, rollout_steps=16, epochs=2, num_minibatches=4, hidden=(16, 16),
              lr=1e-3, entropy_coef=0.01, anneal_iters=5, lr_final=0.0, clip_eps_final=0.1,
              entropy_coef_final=0.0)
    jcfg, cfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    params, jopt_state = jppo.init_host_params(jspec, jcfg, jax.random.key(1))
    net = tppo.make_network(spec, cfg)
    net.load_state_dict(weights.from_flax(jax.device_get(params)))
    opt_state = tppo.make_optimizer(cfg).init(dict(net.named_parameters()))
    schedule = tppo.make_schedule(cfg)
    jupdate = jppo.make_host_update_step(jspec, jcfg)
    tupdate = tppo.make_host_update_fn(spec, cfg)
    rng = np.random.default_rng(7)
    for it in (3, 4):
        b = _ppo_block(rng, 16, 4, discrete)
        extra = ({} if baselines == "recomputed"
                 else dict(final_values=b["final_values"], bootstrap_value=b["bootstrap_value"]))
        key = jax.random.key(30 + it)
        jb = {k: jnp.asarray(v.astype(np.int32) if k == "action" and discrete else v)
              for k, v in b.items()}
        params, jopt_state, jm = jupdate(
            params, jopt_state, jb["obs"], jb["action"], jb["log_prob"], jb["value"],
            jb["reward"], jb["done"], jb["terminated"], jb["final_obs"], jb["last_obs"], key,
            **{k: jb[k] for k in extra},
            progress=jnp.asarray(min(it / jcfg.anneal_iters, 1.0), jnp.float32))
        perms = torch.from_numpy(np.stack([
            np.asarray(jax.random.permutation(k, 64)) for k in jax.random.split(key, 2)]))
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        tm = tupdate(net, opt_state, schedule, tb["obs"], tb["action"], tb["log_prob"],
                     tb["value"], tb["reward"], tb["done"], tb["terminated"], tb["final_obs"],
                     tb["last_obs"], perms, **{k: tb[k] for k in extra},
                     iteration=torch.tensor([it]))
        got = {k: p.detach().numpy() for k, p in net.named_parameters()}
        for k, v in _flat(jax.device_get(params)["params"]).items():
            name = k.replace(".kernel", ".weight")
            np.testing.assert_allclose(got[name], v.T if v.ndim == 2 else v, **TOL,
                                       err_msg=f"iteration {it} {k}")
        conv = weights.adam_state_from_optax(jax.device_get(jopt_state))
        assert int(conv.count) == int(opt_state.count)
        for k in conv.mu:
            np.testing.assert_allclose(opt_state.mu[k].numpy(), conv.mu[k].numpy(), **TOL)
            np.testing.assert_allclose(opt_state.nu[k].numpy(), conv.nu[k].numpy(), **TOL)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)


OFFPOLICY = {
    "ddpg": (jddpg.DDPGConfig, tddpg.DDPGConfig, dict()),
    "td3": (jddpg.DDPGConfig, tddpg.DDPGConfig, dict(twin_q=True, policy_delay=2,
                                                     target_noise=0.2)),
    "td3_mixed": (jddpg.DDPGConfig, tddpg.DDPGConfig, dict(twin_q=True, policy_delay=2,
                                                           target_noise=0.2,
                                                           replay_dtype="mixed")),
    "sac": (jsac.SACConfig, tsac.SACConfig, dict()),
}


def _offpolicy_block(rng, K, E, obs_dim, act_dim):
    obs = rng.normal(size=(K, E, obs_dim)).astype(np.float32)
    done = (rng.random((K, E)) < 0.2).astype(np.float32)
    return dict(obs=obs, action=rng.uniform(-1, 1, (K, E, act_dim)).astype(np.float32),
                reward=rng.normal(size=(K, E)).astype(np.float32),
                final_obs=(obs + 0.05 * rng.normal(size=obs.shape)).astype(np.float32),
                terminated=(done * (rng.random((K, E)) < 0.5)).astype(np.float32), done=done)


@pytest.mark.parametrize("case", sorted(OFFPOLICY))
def test_offpolicy_ingest_update_equals_jax(case):
    """One host ingest+update (K=8, E=4 into an empty ring; the gate open:
    32 ≥ batch 16 and env steps past the warm-up), J=2 updates with the
    draws JAX's key chain gives; then a second block with the gate shut by
    the env-step count."""
    jconfig, tconfig, extra = OFFPOLICY[case]
    jmod, tmod = (jsac, tsac) if case == "sac" else (jddpg, tddpg)
    OBS, ACT = 3, 2
    kw = dict(num_envs=4, steps_per_iter=8, updates_per_iter=2, buffer_capacity=128,
              batch_size=16, hidden=(16, 16), actor_lr=1e-3, critic_lr=1e-3, warmup_steps=32,
              **extra)
    jcfg, cfg = jconfig(**kw), tconfig(**kw)
    jls = jmod.init_learner((OBS,), ACT, jcfg, jax.random.key(3))
    port = tmod.init_learner((OBS,), ACT, cfg, device="cpu")
    load_learner(port, jls)
    jingest = jmod.make_host_ingest_update(ACT, jcfg)
    tingest = tmod.make_host_ingest_update(ACT, cfg)
    rng = np.random.default_rng(11)
    for env_steps, opened in ((32, True), (31, False)):
        b = _offpolicy_block(rng, 8, 4, OBS, ACT)
        traj = JTransition(obs=jnp.asarray(b["obs"]), action=jnp.asarray(b["action"]),
                           reward=jnp.asarray(b["reward"]), next_obs=jnp.asarray(b["final_obs"]),
                           terminated=jnp.asarray(b["terminated"]), done=jnp.asarray(b["done"]))
        # The draws of the J updates: JAX's key chain on the ring after the ingest.
        from actor_critic_tpu import replay as jreplay

        filled = jls._replace(replay=jreplay.add_batch(
            jls.replay, jax.tree.map(lambda x: x.reshape(-1, *x.shape[2:]), traj),
            jreplay.offpolicy_codecs(jcfg.replay_dtype)))
        draws, k = [], filled.key
        for _ in range(cfg.updates_per_iter):
            cur = filled._replace(key=k)
            if case == "sac":
                draws.append(tsac.SACDraws(*sac_draws(cur, jcfg, ACT)))
                k = jax.random.split(k, 4)[0]
            else:
                draws.append(tddpg.UpdateDraws(*ddpg_draws(cur, jcfg, ACT)))
                k = jax.random.split(k, 3)[0]
        jls, jm = jax.jit(jingest)(jls, traj, jnp.asarray(env_steps, jnp.int32))
        assert np.array_equal(jax.random.key_data(jls.key), jax.random.key_data(k))

        ttraj = OffPolicyTransition(
            obs=torch.from_numpy(b["obs"]), action=torch.from_numpy(b["action"]),
            reward=torch.from_numpy(b["reward"]), next_obs=torch.from_numpy(b["final_obs"]),
            terminated=torch.from_numpy(b["terminated"]), done=torch.from_numpy(b["done"]))
        do_update = tingest.ingest(port, ttraj, torch.tensor(env_steps))
        assert bool(do_update) == opened
        for d in draws:
            tm = tingest.update_loop.apply_update(port, do_update, d)
        for name in tm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), **TOL, err_msg=name)
        want = tmod.init_learner((OBS,), ACT, cfg, device="cpu")
        load_learner(want, jls)
        got_t, want_t = learner_tensors(port), learner_tensors(want)
        for name, d in max_differences(got_t, want_t).items():
            if " count" in name or name.endswith(("update_count", "insert_pos", "size")) or (
                    "storage" in name):
                assert d == 0.0, (name, d)
            elif " mu " in name or " nu " in name:
                scale = float(want_t[name].abs().max())
                assert d <= 1e-6 * max(scale, 1e-3), (name, d, scale)
            else:
                assert d <= 1e-6, (name, d)
    assert int(port.update_count) == cfg.updates_per_iter


# --------------------------------------------------------- mechanics


def test_block_buffers_double_buffer_and_static_upload():
    buf = host_loop.BlockBuffers(3)
    tensors = []
    for block in range(4):
        buf.begin_block()
        for t in range(3):
            buf.record(t, "obs", np.full((2, 5), 10 * block + t, np.float32))
        buf.put("env_steps", np.asarray(block, np.int64))
        if block == 2:
            buf.record(0, "extra", np.zeros(2, np.float32))
        host = buf.block()
        static = buf.upload()
        tensors.append({k: v for k, v in static.items()})
        assert sorted(host) == (["env_steps", "extra", "obs"] if block == 2
                                else ["env_steps", "obs"])
        np.testing.assert_array_equal(static["obs"].numpy(), host["obs"])
        assert int(static["env_steps"]) == block
    # One set of static buffers for every block (a graph reads them), two
    # host sets taking turns.
    assert all(t["obs"] is tensors[0]["obs"] for t in tensors)
    first = buf.block()["obs"]
    buf.begin_block()
    buf.record(0, "obs", np.zeros((2, 5), np.float32))
    assert buf.block()["obs"] is not first
    buf.begin_block()
    assert buf._bufs[buf._active]["obs"][1] is first
    with pytest.raises(ValueError, match="changed"):
        buf.put("env_steps", np.zeros(2, np.int64))
        buf.upload()
    with pytest.raises(ValueError, match="num_steps"):
        host_loop.BlockBuffers(0)


def test_host_update_runs_eagerly_on_cpu():
    calls = []
    update = host_loop.HostUpdate(lambda: calls.append(1) or {"x": torch.ones(())},
                                  torch.Generator())
    for _ in range(4):
        assert float(update()["x"]) == 1.0
    assert len(calls) == 4 and update.captured is None and update.stream is None


def test_clock_and_row_keys():
    pool = HostEnvPool("Pendulum-v1", 2, seed=0, backend="native")
    cfg = tppo.PPOConfig(num_envs=2, rollout_steps=8, epochs=1, num_minibatches=1,
                         hidden=(8,))
    _, _, history = tppo.train_host(pool, cfg, 2, log_every=1, device="cpu")
    for _, row in history:
        assert {"collect_s", "wait_s", "dispatch_s", "env_steps"} <= set(row)
        assert "update_ms" not in row  # device times only on the card


@pytest.mark.slow
def test_ppo_learns_native_acrobot():
    """tests/test_native_pool.py's learning check through the port: host
    PPO on the engine's Acrobot (E=16, T=128) reaches greedy eval >= -100
    within 150 iterations."""
    pool = HostEnvPool("Acrobot-v1", num_envs=16, seed=0, backend="native")
    cfg = tppo.PPOConfig(num_envs=16, rollout_steps=128, epochs=4, num_minibatches=8,
                         anneal_iters=300, lr_final=0.0)
    _, _, history = tppo.train_host(pool, cfg, 150, seed=0, log_every=0, eval_every=50,
                                    eval_envs=8, eval_steps=500, device="cpu")
    best = max(m["eval_return"] for _, m in history if "eval_return" in m)
    assert best >= -100.0, f"native Acrobot not learned: best eval {best}"


def test_episode_trackers():
    a, b = host_loop.EpisodeTracker(2), host_loop.EpisodeTracker(1)
    assert np.isnan(a.report()["recent_return"])
    a.update(np.array([1.0, 2.0]), np.array([0.0, 1.0]))
    a.update(np.array([3.0, 4.0]), np.array([1.0, 0.0]))
    b.update(np.array([10.0]), np.array([1.0]))
    assert a.finished == [2.0, 4.0] and a.report() == {"recent_return": 3.0, "episodes": 2.0}
    assert host_loop.MergedEpisodeTracker([a, b]).report(window=1) == {
        "recent_return": 7.0, "episodes": 3.0}
