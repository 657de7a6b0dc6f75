"""The port's async actor-learner (`algos/traj_queue.py`,
`ppo.train_host_async`, `host_loop.off_policy_train_host_async`) on the
CPU, against the JAX package's (tests/test_async_host.py):

- an `ActorService` block, from JAX's parameters (through the port's net
  and its mirror) and seed, equals JAX's `ActorService` block bit for bit,
  on the C++ engine's Pendulum and gym CartPole;
- one async V-trace update from JAX's parameters and block, with JAX's
  minibatch permutations, within the fused PPO update's bound (atol 1e-6,
  rtol 1e-5): every parameter, both Adam moments and `mean_rho`;
- strict lockstep: one actor, queue depth 1, one update a block and
  correction none equal the port's own `train_host` bit for bit
  (parameters and Adam state), on the host and the device data plane;
- JAX's behaviour tests: the straggler, actor death, back-pressure, the
  correction's on-policy reduction, V-trace recovering the target policy's
  return under staleness, async DDPG and SAC, sleep-pad CartPole being
  CartPole;
- the CUDA-graph counterpart of JAX's zero-recompile tests: with a stub
  capture, a learner captures once (in "thread_local" mode) and replays
  for every later block, on both planes, its actors' gate set again after
  every block.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu.algos import traj_queue as jq
from actor_critic_tpu.algos.common import corrected_advantages as jcorrected
from actor_critic_tpu.envs.host_pool import HostEnvPool as JaxPool
from actor_critic_tpu.models import host_actor as jmirror
from actor_critic_tpu_torch import weights
from actor_critic_tpu_torch.algos import ddpg, host_loop, loop, ppo, sac
from actor_critic_tpu_torch.algos import traj_queue as tq
from actor_critic_tpu_torch.algos.common import corrected_advantages
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool
from actor_critic_tpu_torch.models import host_actor

gym = pytest.importorskip("gymnasium")

from actor_critic_tpu_torch.envs.sleep_pad import (  # noqa: E402
    QUALIFIED_CARTPOLE_ID,
    QUALIFIED_ENV_ID,
)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def cpu_learner():
    """One intra-op thread (the learner's ops beside the actor threads would
    otherwise oversubscribe the cores) and a 0.1 ms GIL switch interval: an
    actor's Python loop holds the GIL up to the interval (5 ms by default)
    each time a learner op releases it, and at 5 ms the CPU learner's
    thousands of ops a block take minutes. On the card an update is one
    graph replay, a single call."""
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-4)
    yield
    sys.setswitchinterval(interval)
    torch.set_num_threads(threads)


def _equal_state(net_a, opt_a, net_b, opt_b) -> bool:
    return (all(torch.equal(a, b) for a, b in zip(net_a.parameters(), net_b.parameters()))
            and all(torch.equal(opt_a.mu[k], opt_b.mu[k]) and torch.equal(opt_a.nu[k], opt_b.nu[k])
                    for k in opt_a.mu)
            and torch.equal(opt_a.count, opt_b.count))


# ------------------------------------------------------------ actor block

ACTOR_POOLS = {"native-pendulum": ("Pendulum-v1", "native"), "gym-cartpole": ("CartPole-v1", "gym")}


def _first_blocks(service_cls, queue, pool, publisher, make_act_fn, rng, extras, n=2):
    stop = threading.Event()
    actor = service_cls(1, pool, queue, publisher, 16, make_act_fn, rng=rng, stop=stop,
                        block_extras=extras)
    actor.start()
    blocks = []
    try:
        for _ in range(n):
            b = queue.get(timeout=30.0)
            assert b is not None, actor.error
            blocks.append({k: v.copy() for k, v in b.arrays.items()})
            queue.release(b)
    finally:
        stop.set()
        actor.join(timeout=30.0)
    return blocks


@pytest.mark.parametrize("case", sorted(ACTOR_POOLS))
def test_actor_service_block_equals_jax(case):
    env_id, backend = ACTOR_POOLS[case]
    kw = dict(num_envs=3, rollout_steps=16, epochs=1, num_minibatches=1, hidden=(16,))
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    jpool = JaxPool(env_id, 3, seed=100003, backend=backend)
    pool = HostEnvPool(env_id, 3, seed=100003, backend=backend)
    params, _ = jppo.init_host_params(jpool.spec, jcfg, jax.random.key(4))
    params = jax.device_get(params)
    # The port's acting parameters: JAX's, through the port's net and mirror.
    net = ppo.make_network(pool.spec, cfg)
    net.load_state_dict(weights.from_flax(params))
    port_params = host_actor.mirror_params(net)
    seed, i = 0, 1
    blocks = {}
    for name, mod, svc, mirror, p, tree in (
            ("jax", jq, jq.ActorService, jmirror, jpool, params),
            ("port", tq, tq.ActorService, host_actor, pool, port_params)):
        policy = mirror.make_ppo_host_policy(p.spec, cfg)
        value = mirror.make_ppo_host_value(p.spec, cfg)

        def make_act_fn(actor_params, rng, policy=policy):
            def act(o):
                a, logp, v = policy(actor_params, o, rng)
                return a, {"log_prob": logp, "value": v}

            return act

        def extras(actor_params, last_obs, block, value=value):
            fo = block["final_obs"]
            return {"final_values": value(actor_params, fo.reshape(-1, *fo.shape[2:])).reshape(
                        block["reward"].shape),
                    "bootstrap_value": value(actor_params, last_obs)}

        queue = (mod.TrajQueue(depth=1, policy="block", register_gauge=False) if name == "jax"
                 else mod.TrajQueue(depth=1, policy="block"))
        publisher = mod.PolicyPublisher(tree, version=0)
        blocks[name] = _first_blocks(svc, queue, p, publisher, make_act_fn,
                                     np.random.default_rng(seed + 0x5EED + i * 7919), extras)
    for b, (got, want) in enumerate(zip(blocks["port"], blocks["jax"])):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, (b, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"block {b} {k}")
    jpool.close()
    pool.close()


# ------------------------------------------------------ one V-trace update


def _ppo_block(rng, T, E, discrete):
    obs = rng.normal(size=(T, E, 4)).astype(np.float32)
    if discrete:
        action = rng.integers(0, 3, (T, E))
        log_prob = (np.log(1 / 3) + 0.3 * rng.normal(size=(T, E))).astype(np.float32)
    else:
        action = rng.normal(size=(T, E, 2)).astype(np.float32)
        log_prob = (-2.0 + 0.5 * rng.normal(size=(T, E))).astype(np.float32)
    done = (rng.random((T, E)) < 0.15).astype(np.float32)
    return dict(obs=obs, action=action, log_prob=log_prob,
                value=rng.normal(size=(T, E)).astype(np.float32),
                reward=rng.normal(size=(T, E)).astype(np.float32), done=done,
                terminated=(done * (rng.random((T, E)) < 0.5)).astype(np.float32),
                final_obs=(obs + 0.1).astype(np.float32),
                last_obs=rng.normal(size=(E, 4)).astype(np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "gaussian"])
def test_async_vtrace_update_equals_jax(discrete):
    """Two blocks' async V-trace updates (2 epochs × 4 minibatches, T=16,
    E=4, annealed), from JAX's parameters, blocks and permutations."""
    from actor_critic_tpu.envs.jax_env import EnvSpec as JaxEnvSpec
    from actor_critic_tpu_torch.envs import EnvSpec

    A = 3 if discrete else 2
    jspec = JaxEnvSpec(obs_shape=(4,), action_dim=A, discrete=discrete)
    spec = EnvSpec(obs_shape=(4,), action_dim=A, discrete=discrete)
    kw = dict(num_envs=4, rollout_steps=16, epochs=2, num_minibatches=4, hidden=(16, 16),
              lr=1e-3, entropy_coef=0.01, anneal_iters=5, lr_final=0.0, clip_eps_final=0.1,
              entropy_coef_final=0.0)
    jcfg, cfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    params, jopt_state = jppo.init_host_params(jspec, jcfg, jax.random.key(1))
    net = ppo.make_network(spec, cfg)
    net.load_state_dict(weights.from_flax(jax.device_get(params)))
    opt_state = ppo.make_optimizer(cfg).init(dict(net.named_parameters()))
    schedule = ppo.make_schedule(cfg)
    jupdate = jppo.make_async_update_step(jspec, jcfg, rho_bar=1.0, c_bar=1.0)
    tupdate = ppo.make_async_update_fn(spec, cfg)
    rng = np.random.default_rng(9)
    for it in (2, 3):
        b = _ppo_block(rng, 16, 4, discrete)
        key = jax.random.key(40 + it)
        jb = {k: jnp.asarray(v.astype(np.int32) if k == "action" and discrete else v)
              for k, v in b.items()}
        params, jopt_state, jm = jupdate(
            params, jopt_state, jb["obs"], jb["action"], jb["log_prob"], jb["value"],
            jb["reward"], jb["done"], jb["terminated"], jb["final_obs"], jb["last_obs"], key,
            progress=jnp.asarray(min(it / jcfg.anneal_iters, 1.0), jnp.float32))
        perms = torch.from_numpy(np.stack([
            np.asarray(jax.random.permutation(k, 64)) for k in jax.random.split(key, 2)]))
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        tm = tupdate(net, opt_state, schedule, tb["obs"], tb["action"], tb["log_prob"],
                     tb["value"], tb["reward"], tb["done"], tb["terminated"], tb["final_obs"],
                     tb["last_obs"], perms, iteration=torch.tensor([it]))
        got = {k: p.detach().numpy() for k, p in net.named_parameters()}
        for k, v in _flat(jax.device_get(params)["params"]).items():
            name = k.replace(".kernel", ".weight")
            np.testing.assert_allclose(got[name], v.T if v.ndim == 2 else v, **TOL,
                                       err_msg=f"block {it} {k}")
        conv = weights.adam_state_from_optax(jax.device_get(jopt_state))
        assert int(conv.count) == int(opt_state.count)
        for k in conv.mu:
            np.testing.assert_allclose(opt_state.mu[k].numpy(), conv.mu[k].numpy(), **TOL)
            np.testing.assert_allclose(opt_state.nu[k].numpy(), conv.nu[k].numpy(), **TOL)
        assert sorted(tm) == sorted(jm) and "mean_rho" in tm
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)


def test_async_update_step_none_is_the_host_update():
    from actor_critic_tpu_torch.envs import EnvSpec

    spec = EnvSpec(obs_shape=(4,), action_dim=2, discrete=True)
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, hidden=(8,))
    step = ppo.make_async_update_step(spec, cfg, correction="none")
    assert step.__qualname__ == ppo.make_host_update_step(spec, cfg).__qualname__
    with pytest.raises(ValueError, match="unknown correction"):
        ppo.make_async_update_fn(spec, cfg, correction="gae")


# ------------------------------------------------------- strict lockstep


@pytest.mark.parametrize("data_plane", ["host", "device"], ids=["host_plane", "device_plane"])
@pytest.mark.parametrize("epochs,minibatches", [(2, 2), (1, 1)], ids=["ppo_shaped", "a2c_shaped"])
def test_async_depth1_is_bitwise_lockstep(epochs, minibatches, data_plane):
    """One actor, depth 1, one update a block and correction none: the async
    run is `train_host` bit for bit (parameters and Adam state), the block
    round-tripping the device ring (fp32 codec) on the device plane."""
    cfg = ppo.PPOConfig(num_envs=4, rollout_steps=8, epochs=epochs,
                        num_minibatches=minibatches, hidden=(16,))
    pool = HostEnvPool("CartPole-v1", num_envs=4, seed=0)
    try:
        p_lock, o_lock, _ = ppo.train_host(pool, cfg, 3, seed=0, log_every=0, device="cpu")
    finally:
        pool.close()
    pool = HostEnvPool("CartPole-v1", num_envs=4, seed=0)
    try:
        p_async, o_async, hist = ppo.train_host_async(
            [pool], cfg, 3, seed=0, log_every=1, updates_per_block=1, queue_depth=1,
            correction="none", strict_lockstep=True, data_plane=data_plane,
            plane_codec="fp32", device="cpu")
    finally:
        pool.close()
    assert _equal_state(p_lock, o_lock, p_async, o_async)
    assert [it for it, _ in hist] == [1, 2, 3]
    assert [m["block_staleness"] for _, m in hist] == [0, 1, 1]  # one update stale


# ----------------------------------------------------- straggler / drops


def test_straggler_actor_does_not_stall_learner():
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, epochs=1, num_minibatches=1, hidden=(8,))
    iters, pad = 8, 0.3
    lockstep_bound = iters * cfg.rollout_steps * 2 * pad  # 19.2 s
    pools = [
        HostEnvPool(QUALIFIED_ENV_ID, 2, seed=0, normalize_obs=False, normalize_reward=False,
                    env_kwargs={"sleep_s": pad}),
        HostEnvPool(QUALIFIED_ENV_ID, 2, seed=100003, normalize_obs=False,
                    normalize_reward=False, env_kwargs={"sleep_s": 0.0}),
    ]
    try:
        t0 = time.perf_counter()
        _, _, hist = ppo.train_host_async(pools, cfg, iters, seed=0, log_every=1, queue_depth=2,
                                          max_staleness=None, correction="vtrace", device="cpu")
        wall = time.perf_counter() - t0
    finally:
        for p in pools:
            p.close()
    assert len(hist) == iters
    assert wall < lockstep_bound * 0.6, (wall, lockstep_bound)
    last = hist[-1][1]
    assert np.isfinite(last["loss"]) and np.isfinite(last["mean_rho"])
    from_fast = sum(1 for _, m in hist if m["block_actor"] == 1)
    assert from_fast >= iters // 2, [m["block_actor"] for _, m in hist]


def test_actor_death_surfaces_while_queue_is_fed():
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, epochs=1, num_minibatches=1, hidden=(8,))
    pools = [
        HostEnvPool(QUALIFIED_ENV_ID, 2, seed=0, normalize_obs=False, normalize_reward=False,
                    env_kwargs={"crash_at_step": 3}),
        HostEnvPool(QUALIFIED_ENV_ID, 2, seed=100003, normalize_obs=False,
                    normalize_reward=False),
    ]
    try:
        with pytest.raises(RuntimeError, match="actor 0 died"):
            ppo.train_host_async(pools, cfg, 200, seed=0, log_every=0, queue_depth=2,
                                 correction="vtrace", device="cpu")
    finally:
        for p in pools:
            p.close()


@pytest.mark.parametrize("data_plane", ["host", "device"])
def test_backpressure_drops_oldest_through_the_learner(data_plane):
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, epochs=2, num_minibatches=2, hidden=(16,))
    pool = HostEnvPool("CartPole-v1", 2, seed=0)
    # Two slots: on the device plane the learner's block holds one slot's
    # lease until after the hook, and with one slot the actor could put
    # nothing meanwhile.
    depth = 2

    def actor_runs_ahead(it, run):
        # A learner slower than the actor by construction, whatever the load
        # on the host: after each block's updates the learner waits (with a
        # deadline) until the actor has offered one block more past the
        # consumed ones than the queue can hold while the learner leases
        # (depth - leased: the device plane's block is still leased here,
        # the host plane's was released at staging), so a block was dropped.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            stats = run.queue.stats()
            if stats["puts"] - stats["gets"] >= depth - stats["leased"] + 1:
                return
            time.sleep(0.001)

    try:
        _, _, hist = ppo.train_host_async([pool], cfg, 6, seed=0, log_every=1,
                                          updates_per_block=4, queue_depth=depth,
                                          max_staleness=None, correction="vtrace",
                                          data_plane=data_plane, device="cpu",
                                          iteration_hook=actor_runs_ahead)
    finally:
        pool.close()
    last = hist[-1][1]
    assert last["queue_drops_full"] > 0  # the actor ran ahead; nothing blocked
    assert last["env_steps"] >= last["consumed_env_steps"] == 6 * 8


# ------------------------------------------------------- V-trace correction


def test_corrected_advantages_on_policy_reduction():
    """With π == μ the V-trace value targets equal the GAE returns for any λ,
    and the pg advantages coincide at λ = 1; each side equals JAX's."""
    rng = np.random.default_rng(0)
    T, E = 12, 6
    arrays = dict(lp=rng.normal(size=(T, E)) * 0.3, rewards=rng.normal(size=(T, E)),
                  values=rng.normal(size=(T, E)), dones=rng.random((T, E)) < 0.1,
                  boot=rng.normal(size=(E,)))
    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()}
    j = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    for lam in (1.0, 0.9):
        out = {}
        for corr in ("vtrace", "none"):
            out[corr] = corrected_advantages(t["lp"], t["lp"], t["rewards"], t["values"],
                                             t["dones"], t["boot"], 0.99, lam, correction=corr)
            want = jcorrected(j["lp"], j["lp"], j["rewards"], j["values"], j["dones"],
                              j["boot"], 0.99, lam, correction=corr)
            for g, w in zip(out[corr], want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        (adv_v, ret_v, rho), (adv_g, ret_g, _) = out["vtrace"], out["none"]
        np.testing.assert_allclose(ret_v.numpy(), ret_g.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(rho), 1.0, rtol=1e-6)
        if lam == 1.0:
            np.testing.assert_allclose(adv_v.numpy(), adv_g.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unknown correction"):
        corrected_advantages(t["lp"], t["lp"], t["rewards"], t["values"], t["dones"], t["boot"],
                             0.99, 1.0, correction="retrace")


def test_vtrace_correction_recovers_on_policy_return_under_staleness():
    """Trajectories SAMPLED under a behaviour policy, corrected toward a
    target: with wide clips V-trace is per-decision importance sampling and
    recovers the target's analytic return; with ρ̄ = c̄ = 1 on a zero
    baseline its expectation is known in closed form."""
    rng = np.random.default_rng(1)
    T, E, gamma = 8, 8192, 0.9
    p_b, p_t = 0.5, 0.8
    actions = (rng.random((T, E)) < p_b).astype(np.float32)
    behavior_lp = np.where(actions == 1.0, np.log(p_b), np.log(1 - p_b))
    target_lp = np.where(actions == 1.0, np.log(p_t), np.log(1 - p_t))
    zeros = torch.zeros((T, E))

    def estimate(rho_bar, c_bar):
        _, vs, _ = corrected_advantages(
            torch.tensor(target_lp, dtype=torch.float32),
            torch.tensor(behavior_lp, dtype=torch.float32), torch.from_numpy(actions), zeros,
            zeros, torch.zeros(E), gamma, 1.0, rho_bar=rho_bar, c_bar=c_bar)
        return float(vs[0].mean())

    on_policy = p_t * (1 - gamma**T) / (1 - gamma)
    unclipped = estimate(1e9, 1e9)
    assert abs(unclipped - on_policy) / on_policy < 0.05, (unclipped, on_policy)
    clipped_expect = 0.5 * sum((gamma * 0.7) ** t for t in range(T))
    clipped = estimate(1.0, 1.0)
    assert abs(clipped - clipped_expect) / clipped_expect < 0.05, (clipped, clipped_expect)
    assert clipped < unclipped


def test_sleep_pad_cartpole_is_real_cartpole():
    env = gym.make(QUALIFIED_CARTPOLE_ID, sleep_s=0.0)
    obs, _ = env.reset(seed=0)
    ref = gym.make("CartPole-v1")
    ref_obs, _ = ref.reset(seed=0)
    assert obs.shape == (4,)
    np.testing.assert_array_equal(obs, ref_obs)
    for a in (0, 1, 1, 0):
        np.testing.assert_array_equal(env.step(a)[0], ref.step(a)[0])
    env.close()
    ref.close()
    pad = gym.make(QUALIFIED_ENV_ID, crash_at_step=2)
    pad.reset(seed=0)
    pad.step(1)
    with pytest.raises(RuntimeError, match="injected crash"):
        pad.step(1)


# ----------------------------------------------- off-policy actor services


@pytest.mark.parametrize("data_plane", ["host", "device"])
def test_offpolicy_async_ddpg_trains_and_accounts_steps(data_plane):
    cfg = ddpg.DDPGConfig(num_envs=2, steps_per_iter=4, updates_per_iter=1, buffer_capacity=256,
                          batch_size=8, warmup_steps=16, hidden=(16,))
    kw = dict(backend="native", normalize_obs=False, normalize_reward=False)
    pools = [HostEnvPool("Pendulum-v1", 1, seed=0, **kw),
             HostEnvPool("Pendulum-v1", 1, seed=100003, **kw)]
    try:
        learner, hist = ddpg.train_host_async(pools, cfg, 12, seed=0, log_every=1, eval_every=6,
                                              eval_steps=50, data_plane=data_plane,
                                              plane_codec="int8", device="cpu")
    finally:
        for p in pools:
            p.close()
    rows = dict(hist)
    assert sorted(rows) == list(range(1, 13))
    last = rows[12]
    assert np.isfinite(last["critic_loss"]) and np.isfinite(last["q_mean"])
    assert last["env_steps"] >= last["consumed_env_steps"] == 12 * 4
    assert int(learner.replay.size) == 12 * 4
    assert int(learner.update_count) > 0
    assert "eval_return" in rows[6] and np.isfinite(rows[6]["eval_return"])


def test_offpolicy_async_sac_smoke():
    cfg = sac.SACConfig(num_envs=1, steps_per_iter=4, updates_per_iter=1, buffer_capacity=128,
                        batch_size=8, warmup_steps=8, hidden=(16,))
    pool = HostEnvPool("Pendulum-v1", 1, seed=0, backend="native", normalize_obs=False,
                       normalize_reward=False)
    try:
        learner, hist = sac.train_host_async([pool], cfg, 6, seed=0, log_every=1, device="cpu")
    finally:
        pool.close()
    assert len(hist) == 6
    assert np.isfinite(hist[-1][1]["critic_loss"])
    assert int(learner.replay.size) == 6 * 4


def test_async_needs_a_mirror_and_valid_arguments():
    pool = HostEnvPool("Pendulum-v1", 2, seed=0, backend="native")
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, hidden=(8,))
    try:
        for kwargs, match in ((dict(updates_per_block=0), "updates_per_block"),
                              (dict(correction="retrace"), "unknown correction"),
                              (dict(data_plane="disk"), "data_plane")):
            with pytest.raises(ValueError, match=match):
                ppo.train_host_async([pool], cfg, 1, device="cpu", **kwargs)
        with pytest.raises(ValueError, match="share one env spec"):
            ppo.train_host_async([pool, HostEnvPool("Pendulum-v1", 1, seed=0, backend="native")],
                                 cfg, 1, device="cpu")
    finally:
        pool.close()


# ------------------------------------- the graph counterpart of zero recompiles


class _StubCapture:
    """Stands in for `loop.CapturedStep` on the CPU: counts captures and
    replays, and a replay runs the step."""

    made: list = []

    def __init__(self, step, state, iterations=1, capture_error_mode="global"):
        self.step, self.state, self.mode, self.replays = step, state, capture_error_mode, 0
        _StubCapture.made.append(self)

    def replay(self):
        self.replays += 1
        return self.step(self.state)[1]


@pytest.fixture
def stub_graph(monkeypatch):
    """HostUpdate as on the card: two eager calls on a "side stream", then one
    capture and replays (stubbed)."""
    _StubCapture.made = []
    init = host_loop.HostUpdate.__init__

    def card_like_init(self, body, generator, capture_error_mode="global", **kwargs):
        init(self, body, generator, capture_error_mode, **kwargs)
        self.stream, self.eager_left = "side stream", loop.WARMUP_ITERATIONS

    monkeypatch.setattr(host_loop.HostUpdate, "__init__", card_like_init)
    monkeypatch.setattr(loop, "CapturedStep", _StubCapture)
    monkeypatch.setattr(loop, "eager_step", lambda step, state, stream=None: step(state))
    return _StubCapture


@pytest.mark.parametrize("algo,data_plane", [("ppo", "host"), ("ppo", "device"),
                                             ("sac", "host"), ("sac", "device")])
def test_learner_captures_once_and_replays_every_later_block(stub_graph, algo, data_plane):
    n = 6
    gates = []

    def hook(it, run):
        gates.append((run.update.captured is not None, run.gate.is_set()))

    if algo == "ppo":
        cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, epochs=1, num_minibatches=1, hidden=(8,))
        pools = [HostEnvPool("Pendulum-v1", 1, seed=0, backend="native"),
                 HostEnvPool("Pendulum-v1", 1, seed=100003, backend="native")]
        train = lambda: ppo.train_host_async(  # noqa: E731
            pools, cfg, n, seed=0, log_every=0, updates_per_block=2, data_plane=data_plane,
            plane_codec="int8", device="cpu", iteration_hook=hook)
    else:
        cfg = sac.SACConfig(num_envs=1, steps_per_iter=4, updates_per_iter=1,
                            buffer_capacity=64, batch_size=4, warmup_steps=4, hidden=(8,))
        pools = [HostEnvPool("Pendulum-v1", 1, seed=0, backend="native",
                             normalize_obs=False, normalize_reward=False)]
        train = lambda: sac.train_host_async(  # noqa: E731
            pools, cfg, n, seed=0, log_every=0, data_plane=data_plane, device="cpu",
            iteration_hook=hook)
    try:
        train()
    finally:
        for p in pools:
            p.close()
    upb = 2 if algo == "ppo" else 1
    (captured,) = stub_graph.made
    assert captured.mode == "thread_local"
    # Warm-up and capture in the first blocks; every later update a replay.
    assert captured.replays == n * upb - loop.WARMUP_ITERATIONS
    assert [c for c, _ in gates] == [i + 1 > loop.WARMUP_ITERATIONS // upb for i in range(n)]
    assert all(g for _, g in gates)  # the actors' gate is set again after each block
