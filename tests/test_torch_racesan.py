"""The port's race sanitizer (`actor_critic_tpu_torch/analysis/racesan.py`)
against the JAX package's (`actor_critic_tpu/analysis/racesan.py`), with the
cases of `tests/test_racesan.py`, on the CPU.

Held to JAX, per seed, exactly (a report is a dict of counts): the quick
profile, and each of the queue, publisher, mailbox and batcher exercisers'
reports (consumed, produced, reads, deposits, takes, responses, swaps,
scrapes, the schedule's trace length). The schedule draws are Python's
`random.Random` on both sides and the port's `TrajQueue`, `PolicyPublisher`,
`ParamMailbox`, `MicroBatcher` and `PolicyStore` take their locks as JAX's
do, so each seed gives the same interleaving.

Not held to JAX: the device ring's schedules. The port's
`DeviceTrajRing.put` takes the ring's lock three times (calibrate, claim,
publish the lease), JAX's twice, so the yield points and the
interleavings of a seed differ; the ring is held to its own contract
(clean sweeps, replay per seed, every revert caught).

Every reverted mode is caught on every schedule where it can show, as in
JAX's tests (the ring's `buggy_writer` on every schedule where a put meets a
held lease).
"""

import numpy as np
import pytest

from actor_critic_tpu.analysis import racesan as jracesan
from actor_critic_tpu_torch.algos.traj_queue import PolicyPublisher, TrajQueue
from actor_critic_tpu_torch.analysis import racesan
from actor_critic_tpu_torch.analysis.racesan import CoopScheduler, RacesanError


# ---------------------------------------------------------------- held to JAX


def test_quick_profile_sweeps_clean_and_equals_jax():
    out = racesan.quick_profile(schedules=100)
    assert out == jracesan.quick_profile(schedules=100)
    assert out["schedules"] == 100 and out["races"] == 0
    assert out["queue"]["consumed"] > 0
    assert out["publisher"]["reads"] > 0 and out["publisher"]["published"] > 0
    assert out["mailbox"]["deposits"] > 0 and out["mailbox"]["takes"] > 0
    assert out["batcher"]["responses"] > 0 and out["batcher"]["swaps"] > 0
    assert out["batcher"]["scrapes"] > 0


@pytest.mark.parametrize("unit", ["queue", "publisher", "mailbox", "batcher"])
@pytest.mark.parametrize("seed", [0, 7, 23])
def test_unit_report_equals_jax_per_seed(unit, seed):
    fn = f"exercise_{unit}"
    assert getattr(racesan, fn)(seed) == getattr(jracesan, fn)(seed)


def test_scheduler_trace_equals_jax():
    def trace_of(mod, seed):
        sched = mod.CoopScheduler(seed)

        def worker(sched=sched):
            for i in range(4):
                sched.yield_point(f"s{i}")

        for n in ("a", "b", "c"):
            sched.spawn(n, worker)
        return sched.run()

    for seed in range(6):
        assert trace_of(racesan, seed) == trace_of(jracesan, seed)


# ---------------------------------------------------------- scheduler mechanics


def test_seeded_schedule_replays_bit_identically():
    traces, orders = [], []
    for _ in range(2):
        sched = CoopScheduler(seed=11)
        order = []

        def worker(name, sched=sched, order=order):
            for i in range(3):
                order.append((name, i))
                sched.yield_point(f"step-{i}")

        for n in ("a", "b", "c"):
            sched.spawn(n, lambda n=n: worker(n))
        traces.append(sched.run())
        orders.append(order)
    assert traces[0] == traces[1] and orders[0] == orders[1]


def test_racy_toy_class_is_caught_within_n_schedules():
    class Counter:
        n = 0

    def lost_update(seed, incrs=3):
        sched = CoopScheduler(seed)
        c = Counter()

        def worker():
            for _ in range(incrs):
                v = c.n
                sched.yield_point("between-read-and-write")
                c.n = v + 1

        for n in ("t0", "t1"):
            sched.spawn(n, worker)
        sched.run()
        return c.n < 2 * incrs

    hits = [s for s in range(20) if lost_update(s)]
    assert hits and lost_update(hits[0]) and lost_update(hits[0])


def test_blocked_participant_trips_the_deadline_not_a_hang():
    import threading

    sched = CoopScheduler(seed=0)
    ev = threading.Event()
    sched.spawn("blocker", ev.wait)
    with pytest.raises(RacesanError, match="no progress"):
        sched.run(timeout_s=0.5)
    ev.set()


# ------------------------------------------------------------ poisoner tripwires


def test_freeze_on_publish_crashes_producer_write_at_the_write_site():
    pub = PolicyPublisher({"w": np.zeros((2, 2), np.float32)})
    racesan.freeze_on_publish(pub)
    retained = {"w": np.ones((2, 2), np.float32)}
    pub.publish(retained, version=1)
    with pytest.raises(ValueError, match="read-only"):
        retained["w"][...] = 2.0


def test_queue_poisoner_freezes_leases_and_scribbles_releases():
    q = TrajQueue(depth=2, register_gauge=False)
    racesan.attach_queue_poisoner(q)
    q.put({"x": np.full((3,), 5.0, np.float32)}, version=0)
    block = q.get(timeout=0)
    with pytest.raises(ValueError, match="read-only"):
        block.arrays["x"][0] = 1.0
    stale = np.asarray(block.arrays["x"])
    q.release(block)
    assert float(stale[0]) == float(np.finfo(np.float32).min)
    q.close()


# --------------------------------------------------- reverted modes: always caught


@pytest.mark.parametrize("seed", range(5))
def test_reverted_copy_on_transfer_consumer_is_detected(seed):
    with pytest.raises(RacesanError, match="corrupted"):
        racesan.exercise_queue(seed, consumer="alias", poison=True)


def test_buggy_producer_is_detected():
    for seed in range(3):
        with pytest.raises(ValueError, match="read-only"):
            racesan.exercise_publisher(seed, buggy_producer=True)


@pytest.mark.parametrize("mode", ["alias_submit", "buggy_swapper"])
def test_batcher_reverts_are_detected_at_the_write_site(mode):
    for seed in range(3):
        with pytest.raises(ValueError, match="read-only"):
            racesan.exercise_batcher(seed, poison=True, **{mode: True})


def test_buggy_depositor_is_detected_at_the_write_site():
    for seed in range(3):
        with pytest.raises(ValueError, match="read-only"):
            racesan.exercise_mailbox(seed, buggy_depositor=True)


# ------------------------------------------------------------ the device ring


def test_device_ring_sweeps_clean_with_poison():
    out = racesan.exercise_sweep(
        range(8), lambda s: racesan.exercise_device_ring(s, poison=True, device="cpu"))
    assert out["races"] == 0 and out["consumed"] > 0


def test_device_ring_replays_bit_identically():
    a = racesan.exercise_device_ring(5, poison=True, device="cpu")
    b = racesan.exercise_device_ring(5, poison=True, device="cpu")
    assert a == b


def test_device_ring_buggy_writer_is_caught_wherever_a_writer_meets_a_lease(monkeypatch):
    """The reverted lease protection is caught at the claim on every
    schedule where a put finds the ring full with a lease held (JAX's
    exerciser too has schedules where no put meets a lease: seeds 18, 21
    and 44 of its first 60). A spy on the claim counts the meetings."""
    from actor_critic_tpu_torch.data_plane import ring as dp_ring

    met = []
    orig = dp_ring.DeviceTrajRing._claim_slot_locked

    def spy(self):
        slot = orig(self)
        if slot is None and self._leased:
            met.append(1)
        return slot

    monkeypatch.setattr(dp_ring.DeviceTrajRing, "_claim_slot_locked", spy)
    caught = 0
    for seed in range(12):
        met.clear()
        try:
            racesan.exercise_device_ring(seed, poison=True, buggy_writer=True, device="cpu")
        except RacesanError as e:
            assert "LEASED slot" in str(e)
            caught += 1
            continue
        assert not met, f"seed {seed}: a writer met a held lease and was not caught"
    assert caught >= 10


def test_device_ring_release_before_read_is_detected():
    detected = None
    for seed in range(16):
        try:
            racesan.exercise_device_ring(seed, poison=True, consumer="released",
                                         blocks_per_producer=4, depth=1, device="cpu")
        except RacesanError:
            detected = seed
            break
    assert detected is not None, "no schedule exposed the stale read"
    with pytest.raises(RacesanError):
        racesan.exercise_device_ring(detected, poison=True, consumer="released",
                                     blocks_per_producer=4, depth=1, device="cpu")


def test_ring_poisoner_wraps_the_claim_of_the_port_ring():
    from actor_critic_tpu_torch.data_plane import ring as dp_ring

    ring = dp_ring.DeviceTrajRing(1, {"x": dp_ring.array_spec((2,), np.float32)},
                                  register_gauge=False, device="cpu")
    racesan.attach_ring_poisoner(ring)
    assert ring.put({"x": np.ones(2, np.float32)}, 1, timeout=0)
    lease = ring.get(timeout=0)
    ring._leased.discard(lease.slot)
    ring._free.append(lease.slot)
    ring._leased.add(lease.slot)  # a slot both free and leased: the claim must refuse it
    with pytest.raises(RacesanError, match="LEASED slot"):
        ring.put({"x": np.ones(2, np.float32)}, 2, timeout=0)
    ring.close()


# -------------------------------------------------------------------- the CLI


@pytest.mark.parametrize("argv,rc", [
    (["--schedules", "8"], 0),
    (["--scenario", "queue", "--consumer", "alias", "--schedules", "2"], 1),
    (["--scenario", "publisher", "--schedules", "4"], 0),
    (["--scenario", "batcher", "--submit", "alias", "--schedules", "2"], 1),
    (["--scenario", "device_ring", "--writer", "buggy", "--schedules", "2", "--device", "cpu"],
     1),
    (["--scenario", "device_ring", "--schedules", "3", "--device", "cpu"], 0),
    (["--scenario", "mailbox", "--schedules", "0", "--json"], 0),
], ids=["quick", "alias", "publisher", "alias-submit", "buggy-writer", "ring", "json"])
def test_cli_exit_codes(argv, rc, capsys):
    assert racesan.main(argv) == rc
    capsys.readouterr()


def test_cli_usage_error_exits_two():
    with pytest.raises(SystemExit) as e:
        racesan.main(["--scenario", "nope"])
    assert e.value.code == 2
