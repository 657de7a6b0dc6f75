"""The port's sharded host pool (`actor_critic_tpu_torch/envs/shard_pool.py`
behind `HostEnvPool(workers=W)`) against the JAX package's, with the cases
of `tests/test_shard_pool.py`.

- obs, reward, done, terminated and final_obs of the port's pool at
  `workers=W` equal the JAX pool's at `workers=1` and at `workers=W`, and
  the port's own `workers=1`, bitwise over 200 steps at fixed seeds
  (CartPole-v1 with uneven shards, Pendulum-v1 with clipped continuous
  actions), the normalizers' state equal too: the pool is numpy, so the
  tolerance is 0;
- a worker that raises or is killed surfaces as a `RuntimeError`, not a
  hang, and `close()` returns after it;
- `drain_telemetry` and `worker_stats` count what JAX's count;
- `train.main --workers 2` reaches the pool and trains with the rows of
  `--workers 1`;
- a pool spawned from a test function closes in under 30 s with no child
  process left (spawn re-imports the parent's `__main__`).
"""

import json
import multiprocessing as mp
import os
import signal
import time

import numpy as np
import pytest

gym = pytest.importorskip("gymnasium")

from actor_critic_tpu.envs.host_pool import HostEnvPool as JaxPool  # noqa: E402
from actor_critic_tpu.envs.shard_pool import shard_bounds as jax_shard_bounds  # noqa: E402
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool  # noqa: E402
from actor_critic_tpu_torch.envs.shard_pool import shard_bounds  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401 (an autouse fixture)

SLEEP_PAD = "actor_critic_tpu_torch.envs.sleep_pad:SleepPad-v0"
FIELDS = ("obs", "reward", "done", "terminated", "final_obs", "raw_reward")


def _rollout(pool, steps: int, seed: int, discrete: bool):
    rng = np.random.default_rng(seed)
    frames = [pool.reset()]
    for _ in range(steps):
        if discrete:
            acts = rng.integers(0, 2, pool.num_envs).astype(np.int64)
        else:
            acts = (rng.normal(size=(pool.num_envs, 1)) * 2.5).astype(np.float32)
        out = pool.step(acts)
        frames.append(tuple(getattr(out, k) for k in FIELDS))
    return frames


def _assert_pools_equal(a, b, fa, fb):
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert u.dtype == v.dtype and u.shape == v.shape
            assert u.tobytes() == v.tobytes()
    for rms in ("obs_rms", "ret_rms"):
        ra, rb = getattr(a, rms), getattr(b, rms)
        assert ra.mean.tobytes() == rb.mean.tobytes()
        assert ra.var.tobytes() == rb.var.tobytes()
        assert ra.count == rb.count
    assert a.get_state()["returns"].tobytes() == b.get_state()["returns"].tobytes()


def _no_shard_children():
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = [p for p in mp.active_children() if p.name.startswith("env-shard")]
        if not left:
            return []
        time.sleep(0.1)
    return left


def test_shard_bounds_equal_jax():
    for e, w in ((8, 4), (5, 2), (3, 3), (200, 7), (1, 1)):
        assert shard_bounds(e, w) == jax_shard_bounds(e, w)
    assert shard_bounds(5, 2) == [(0, 3), (3, 5)]


@pytest.mark.parametrize("kwargs,match", [
    ({"num_envs": 2, "workers": 0}, "workers must be >= 1"),
    ({"num_envs": 2, "workers": 3}, "exceeds num_envs"),
    ({"num_envs": 2, "backend": "native", "workers": 2}, "gym backend only"),
    ({"num_envs": 2, "worker_env_kwargs": [None]}, "worker_env_kwargs needs"),
    ({"num_envs": 2, "workers": 2, "worker_env_kwargs": [None]}, "1 entries"),
])
def test_workers_validation_as_jax(kwargs, match):
    env_id = "Pendulum-v1" if kwargs.get("backend") == "native" else "CartPole-v1"
    with pytest.raises(ValueError, match=match):
        HostEnvPool(env_id, **kwargs)
    with pytest.raises(ValueError, match=match):
        JaxPool(env_id, **kwargs)
    assert _no_shard_children() == []


@pytest.mark.parametrize("env_id,E,W", [("CartPole-v1", 5, 2), ("Pendulum-v1", 6, 3)])
def test_sharded_equals_jax_and_one_process(env_id, E, W):
    """200 steps at fixed seeds: the port at W workers = the port at 1 = JAX
    at 1 = JAX at W, trajectories and normalizer state, bitwise."""
    discrete = env_id == "CartPole-v1"
    pools = {("port", W): HostEnvPool(env_id, E, seed=3, workers=W),
             ("port", 1): HostEnvPool(env_id, E, seed=3),
             ("jax", 1): JaxPool(env_id, E, seed=3),
             ("jax", W): JaxPool(env_id, E, seed=3, workers=W)}
    try:
        frames = {k: _rollout(p, 200, seed=7, discrete=discrete) for k, p in pools.items()}
        ref = ("port", W)
        for k in pools:
            if k != ref:
                _assert_pools_equal(pools[ref], pools[k], frames[ref], frames[k])
        # Episodes ended inside the run, so final_obs differed from obs.
        done = np.stack([f[2] for f in frames[ref][1:]])
        assert done.sum() > 0
        counted = [[(s["worker"], s["envs"], s["env_steps"]) for s in pools[k].worker_stats()]
                   for k in (ref, ("jax", W))]
        assert counted[0] == counted[1]
        assert pools[("port", 1)].worker_stats() is None
        assert [s["env_steps"] for s in pools[ref].worker_stats()] == [
            200 * (hi - lo) for lo, hi in shard_bounds(E, W)]
    finally:
        for p in pools.values():
            p.close()
    assert _no_shard_children() == []


def test_eval_pool_inherits_sharding_and_frozen_stats():
    pool = HostEnvPool("CartPole-v1", 4, seed=0, workers=2)
    ev = pool.eval_pool(num_envs=3, seed=9)
    try:
        assert ev._workers == 2 and ev._frozen_stats and ev.obs_rms is pool.obs_rms
        assert len(ev.worker_stats()) == 2
        ev1 = pool.eval_pool(num_envs=1)
        assert ev1._workers == 1 and ev1.worker_stats() is None
        ev1.close()
    finally:
        ev.close()
        pool.close()


def test_worker_exception_raises_not_hangs():
    pool = HostEnvPool(SLEEP_PAD, 4, seed=0, workers=2, normalize_obs=False,
                       normalize_reward=False, env_kwargs={"crash_at_step": 3})
    pool.reset()
    with pytest.raises(RuntimeError, match="env worker .* crashed"):
        for _ in range(10):
            pool.step(np.zeros(4, np.int64))
    t0 = time.monotonic()
    pool.close()
    assert time.monotonic() - t0 < 30
    assert _no_shard_children() == []


def test_killed_worker_raises_not_hangs():
    pool = HostEnvPool("CartPole-v1", 4, seed=0, workers=2)
    pool.reset()
    pool.step(np.zeros(4, np.int64))
    os.kill(pool._envs._procs[1].pid, signal.SIGKILL)
    pool._envs._procs[1].join(timeout=10)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="env worker 1 died"):
        pool.step(np.zeros(4, np.int64))
    assert time.monotonic() - t0 < 30
    pool.close()
    assert _no_shard_children() == []


def test_validation_failure_closes_workers():
    from actor_critic_tpu_torch.telemetry.sampler import sample_row

    with pytest.raises(ValueError, match="finite continuous"):
        HostEnvPool("CartPole-v1", num_envs=2, workers=2, scale_actions=True)
    assert not any(k.startswith("host_pool") for k in sample_row())
    assert _no_shard_children() == []


def test_spawned_pool_closes_in_time_with_no_child_left():
    """Built inside a function (spawn re-imports the parent's `__main__`,
    which must not build pools at import): the workers are up, step, and
    are gone within 30 s of the start."""
    t0 = time.monotonic()
    pool = HostEnvPool("CartPole-v1", 3, seed=1, workers=3)
    pids = [p.pid for p in pool._envs._procs]
    assert len(set(pids)) == 3 and os.getpid() not in pids
    pool.reset()
    pool.step(np.ones(3, np.int64))
    pool.close()
    assert _no_shard_children() == []
    assert time.monotonic() - t0 < 30
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _telemetry_run(tmp_path, package: str):
    """One 2-iteration host PPO run through `package`'s trainer on a
    2-worker CartPole pool with a telemetry session: the pool gauge, the
    relayed spans and the workers' stats."""
    if package == "port":
        from actor_critic_tpu_torch import telemetry
        from actor_critic_tpu_torch.algos import ppo
        from actor_critic_tpu_torch.telemetry.sampler import sample_row

        pool = HostEnvPool("CartPole-v1", num_envs=2, seed=0, workers=2)
        kw = {"device": "cpu"}
    else:
        from actor_critic_tpu import telemetry
        from actor_critic_tpu.algos import ppo
        from actor_critic_tpu.telemetry.sampler import sample_row

        pool = JaxPool("CartPole-v1", num_envs=2, seed=0, workers=2)
        kw = {}
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, epochs=1, num_minibatches=1, hidden=(16,))
    try:
        with telemetry.TelemetrySession(tmp_path, sample_resources=False):
            ppo.train_host(pool, cfg, num_iterations=2, seed=0, log_every=0, **kw)
            gauge = sample_row().get("host_pool")
        stats = pool.worker_stats()
    finally:
        pool.close()
    assert "host_pool" not in sample_row()
    with open(tmp_path / "spans.jsonl") as f:
        events = [json.loads(line) for line in f if line.strip()]
    return gauge, stats, events


def test_drain_telemetry_and_worker_stats_count_as_jax(tmp_path):
    out = {pkg: _telemetry_run(tmp_path / pkg, pkg) for pkg in ("port", "jax")}
    counts = {}
    for pkg, (gauge, stats, events) in out.items():
        assert gauge["workers"] == 2 and gauge["num_envs"] == 2
        assert 0.0 <= gauge["utilization"] <= 1.0
        spans = [e for e in events if e.get("name") == "env_step_worker" and e["ph"] == "X"]
        pids = {e["pid"] for e in spans}
        assert len(pids) == 2 and os.getpid() not in pids
        labels = {e["pid"]: e["args"]["name"] for e in events
                  if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert {labels.get(p) for p in pids} == {"env-shard-0", "env-shard-1"}
        assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
        counts[pkg] = (
            len(spans), sorted((e["args"]["worker"], e["args"]["envs"]) for e in spans),
            gauge["env_steps"], [(s["worker"], s["envs"], s["env_steps"]) for s in stats])
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] > 0


def test_train_cli_workers_reach_the_pool_and_equal_one_process(tmp_path, monkeypatch):
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.envs import host_pool

    seen = []
    orig = host_pool.HostEnvPool.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("workers", 1))
        orig(self, *a, **kw)

    monkeypatch.setattr(train.HostEnvPool, "__init__", spy)
    rows = {}
    for w in (1, 2):
        path = tmp_path / f"w{w}.jsonl"
        train.main(["--preset", "ppo_halfcheetah", "--env", "host:Pendulum-v1", "--workers",
                    str(w), "--iterations", "2", "--set", "num_envs=4", "--set",
                    "rollout_steps=16", "--set", "epochs=1", "--set", "num_minibatches=2",
                    "--set", "hidden=8", "--device", "cpu", "--quiet", "--metrics", str(path)])
        with open(path) as f:
            rows[w] = [json.loads(line) for line in f if line.strip()]
    assert 2 in seen and seen[0] == 1
    timing = ("wall_s", "collect_s", "wait_s", "dispatch_s", "sps", "env_steps_per_s")

    def strip(rs):
        return [{k: v for k, v in r.items() if k not in timing and not k.endswith("_s")}
                for r in rs]

    assert rows[1] and strip(rows[1]) == strip(rows[2])
