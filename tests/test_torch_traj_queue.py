"""The port's `TrajQueue`, `PolicyPublisher` and `ActorService` helpers
(`actor_critic_tpu_torch/algos/traj_queue.py`) against the JAX package's
unit contracts (tests/test_traj_queue.py: FIFO with slot recycling,
drop-oldest back-pressure, staleness-bounded consumption, the publisher's
versioned wait, the merged episode tracker), the same calls run on both
queues where both have them; plus the port's own cases: the frozen
snapshot, the non-finite publish refused with the last good tree kept, and
`consume_block` surfacing a dead actor. The gauge and run_report cases are
telemetry (not ported yet)."""

import threading
import time

import numpy as np
import pytest

from actor_critic_tpu.algos import traj_queue as jq
from actor_critic_tpu_torch.algos import host_loop
from actor_critic_tpu_torch.algos import traj_queue as tq
from actor_critic_tpu_torch.utils.checkpoint import NonFiniteError


def _block(v: float, shape=(4, 2)) -> dict:
    return {"obs": np.full(shape, v, np.float32), "reward": np.full(shape[:1], v, np.float32)}


def _queues(**kw):
    return [tq.TrajQueue(**kw), jq.TrajQueue(register_gauge=False, **kw)]


@pytest.mark.parametrize("which", ["port", "jax"])
def test_fifo_and_copy_semantics(which):
    q = _queues(depth=3)[which == "jax"]
    src = _block(1.0)
    assert q.put(src, version=0)
    src["obs"][:] = 99.0  # the queue must have copied
    assert q.put(_block(2.0), version=1)
    b1 = q.get(timeout=1.0)
    assert b1 is not None and b1.version == 0 and b1.seq == 0
    np.testing.assert_array_equal(b1.arrays["obs"], 1.0)
    q.release(b1)
    b2 = q.get(timeout=1.0)
    assert b2.version == 1
    np.testing.assert_array_equal(b2.arrays["obs"], 2.0)
    q.release(b2)
    assert q.get(timeout=0.05) is None  # empty: a timeout, not a hang


def test_slot_recycling_reuses_storage():
    q = tq.TrajQueue(depth=2)
    q.put(_block(1.0), version=0)
    b = q.get(timeout=1.0)
    storage = b.arrays["obs"]
    q.release(b)
    q.put(_block(2.0), version=1)
    b2 = q.get(timeout=1.0)
    assert b2.arrays["obs"] is storage
    np.testing.assert_array_equal(b2.arrays["obs"], 2.0)
    q.release(b2)


def test_drop_oldest_when_full_as_jax():
    rows = []
    for q in _queues(depth=2):
        for v in range(4):  # capacity 2: blocks 0 and 1 recycled
            q.put(_block(float(v)), version=v)
        got = [q.get(timeout=1.0), q.get(timeout=1.0)]
        rows.append(([b.version for b in got], q.stats()["drops_full"]))
        for b in got:
            q.release(b)
    assert rows[0] == rows[1] == ([2, 3], 2)


def test_staleness_drop_at_get_as_jax():
    rows = []
    for q in _queues(depth=4, max_staleness=2):
        for v in range(3):
            q.put(_block(float(v)), version=v)
        q.set_consumer_version(4)  # lags 4, 3, 2
        b = q.get(timeout=1.0)
        st = q.stats()
        rows.append((b.version, st["drops_stale"], st["observe_staleness"]))
        q.release(b)
    assert rows[0] == rows[1] == (2, 2, 2)


def test_stats_rows_have_jax_keys():
    port, jax_q = _queues(depth=2)
    for q in (port, jax_q):
        q.put(_block(1.0), version=0)
        q.set_consumer_version(1)
        q.release(q.get(timeout=1.0))
    assert sorted(port.stats()) == sorted(jax_q.stats())
    strip = lambda r: {k: v for k, v in r.items() if k != "learner_idle_s"}  # noqa: E731
    assert strip(port.stats()) == strip(jax_q.stats())
    jax_q.close()


def test_block_policy_put_waits_for_free_slot():
    q = tq.TrajQueue(depth=1, policy="block")
    assert q.put(_block(0.0), version=0)
    assert not q.put(_block(1.0), version=1, timeout=0.05)  # full: a timeout

    def consume():
        b = q.get(timeout=5.0)
        time.sleep(0.05)
        q.release(b)

    t = threading.Thread(target=consume)
    t.start()
    try:
        assert q.put(_block(1.0), version=1, timeout=5.0)  # slot freed mid-wait
    finally:
        t.join(timeout=10.0)
    assert q.stats()["drops_full"] == 0


@pytest.mark.parametrize("kw,match", [
    (dict(depth=0), "depth"), (dict(depth=2, policy="lifo"), "policy"),
    (dict(depth=2, max_staleness=-1), "max_staleness")])
def test_bad_queue_arguments_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        tq.TrajQueue(**kw)


def test_publisher_versioned_wait():
    pub = tq.PolicyPublisher({"w": np.zeros(2)}, version=0)
    assert pub.wait_for(0, timeout=0.1)
    assert not pub.wait_for(2, timeout=0.05)
    stop = threading.Event()
    stop.set()
    assert not pub.wait_for(2, stop=stop)  # stop wins over the wait
    pub.publish({"w": np.ones(2)}, version=2)
    assert pub.wait_for(2, timeout=0.1)
    version, params = pub.get()
    assert version == 2
    np.testing.assert_array_equal(params["w"], 1.0)


def test_publisher_snapshot_is_frozen_and_private():
    """The published tree is a read-only copy: a write into it raises, and a
    later write into the caller's arrays does not reach it."""
    src = {"params": {"dense_0": {"kernel": np.ones((2, 3), np.float32)}}, "log_std": [np.zeros(1)]}
    pub = tq.PolicyPublisher({"params": {}}, version=0)
    pub.publish(src, version=1)
    _, tree = pub.get()
    kernel = tree["params"]["dense_0"]["kernel"]
    with pytest.raises(ValueError, match="read-only"):
        kernel[0, 0] = 5.0
    with pytest.raises(ValueError, match="read-only"):
        tree["log_std"][0][0] = 1.0
    src["params"]["dense_0"]["kernel"][:] = 7.0
    np.testing.assert_array_equal(kernel, 1.0)
    # The JAX publisher's snapshot is frozen the same way.
    assert not jq._snapshot_frozen({"k": np.ones(2)})["k"].flags.writeable


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_nonfinite_publish_refused_last_good_kept(bad):
    pub = tq.PolicyPublisher({"w": np.zeros(3, np.float32)}, version=0)
    pub.publish({"w": np.full(3, 2.0, np.float32)}, version=1)
    poisoned = {"w": np.array([1.0, bad, 1.0], np.float32), "b": (np.ones(1),)}
    with pytest.raises(NonFiniteError, match=r"params\['w'\]\[1\]"):
        pub.publish(poisoned, version=2)
    version, params = pub.get()
    assert version == 1
    np.testing.assert_array_equal(params["w"], 2.0)
    # Integer leaves are never refused.
    pub.publish({"w": np.zeros(3, np.float32), "steps": np.array([3])}, version=3)
    assert pub.get()[0] == 3


class _DeadActor:
    def __init__(self, actor_id, error=None, alive=True):
        self.actor_id, self.error, self.alive = actor_id, error, alive


def test_consume_block_surfaces_a_dead_actor():
    q = tq.TrajQueue(depth=2)
    boom = RuntimeError("env exploded")
    with pytest.raises(RuntimeError, match="host 3 actor 1 died") as info:
        tq.consume_block(q, [_DeadActor(0), _DeadActor(1, boom)], timeout=0.01, context="host 3 ")
    assert info.value.__cause__ is boom
    with pytest.raises(RuntimeError, match="every actor thread exited"):
        tq.consume_block(q, [_DeadActor(0, alive=False)], timeout=0.01)
    q.put(_block(1.0), version=0)
    # A pending block is consumed even while an actor is dead.
    assert tq.consume_block(q, [_DeadActor(0, boom)], timeout=0.01).version == 0


def test_validate_pools():
    class P:
        def __init__(self, spec, n):
            self.spec, self.num_envs = spec, n

    assert tq.validate_pools([P("a", 2), P("a", 2)]) == ("a", 2)
    with pytest.raises(ValueError, match="at least one"):
        tq.validate_pools([])
    with pytest.raises(ValueError, match="share one env spec"):
        tq.validate_pools([P("a", 2), P("a", 3)])


def test_merged_episode_tracker_report():
    a, b = host_loop.EpisodeTracker(2), host_loop.EpisodeTracker(2)
    a.finished.extend([10.0, 20.0])
    b.finished.extend([30.0])
    rep = host_loop.MergedEpisodeTracker([a, b]).report()
    assert rep["episodes"] == 3.0 and rep["recent_return"] == 20.0
    assert np.isnan(host_loop.MergedEpisodeTracker([]).report()["recent_return"])
