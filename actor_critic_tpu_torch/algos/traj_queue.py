"""Bounded, fixed-shape trajectory queue between actor and learner
threads (counterpart of `actor_critic_tpu/algos/traj_queue.py`).

The synchronous host loops (`host_loop.py`) collect and update in one
thread: one slow collection block stalls every update. This module
decouples them (IMPACT, arxiv 1912.00167; GA3C, arxiv 1611.06256):

- `ActorService`: one thread per actor. It steps its own host env pool,
  acts through the numpy mirror (`models/host_actor.py`) with behaviour
  parameters refreshed from the `PolicyPublisher` once a block, and pushes
  fixed-shape `[K, E, ...]` numpy blocks tagged with the behaviour
  parameters' VERSION. A straggler slows only its own contribution.
- `TrajQueue`: a bounded ring of recycled block slots. `put` copies the
  actor's arrays into a slot (the actor's buffers are reusable at once),
  and a full queue DROPS THE OLDEST block rather than blocking the
  producer (counted). `get` also drops blocks whose version lags the
  consumer's by more than `max_staleness`. `policy="block"` is the strict
  mode of the lockstep-equivalence tests.
- `PolicyPublisher`: a versioned store of frozen numpy behaviour
  parameters. The learner publishes each update's INPUT parameters with
  version = blocks consumed; actors read the latest at each block
  boundary. A non-finite tree is refused and the last good one kept.

The learners live with their algorithms (`ppo.train_host_async`,
`host_loop.off_policy_train_host_async`). The device data plane
(`data_plane/ring.py`) speaks the same producer/consumer protocol.

Telemetry: every queue registers its `stats()` row as a sampler gauge
(`telemetry/sampler.py register_gauge`, key `traj_queue` by default) so
depth, staleness, drops and learner idle time ride `resources.jsonl` and
`/metrics`; `close()` unregisters it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

from actor_critic_tpu_torch.utils import numguard
from actor_critic_tpu_torch.utils.numguard import NonFiniteError


class TrajBlock(NamedTuple):
    """One queued trajectory block: fixed-shape numpy arrays plus the
    behaviour-parameter version they were collected under."""

    arrays: dict[str, np.ndarray]
    version: int   # PolicyPublisher version the actor acted with
    actor_id: int
    seq: int       # global put order (monotonic; diagnostics)


class TrajQueue:
    """Bounded FIFO of fixed-shape trajectory blocks with drop-oldest
    back-pressure and staleness-bounded consumption.

    Storage is a recycled slot pool: `put` copies into a free (or
    reclaimed-oldest) slot dict, `get` leases the slot to the consumer,
    `release` returns it. After the first few blocks the queue allocates
    nothing.

    `policy="drop_oldest"` (default): a full queue reclaims its oldest
    pending block for the incoming one. `policy="block"`: `put` waits for
    a free slot. `max_staleness`: blocks whose `consumer_version - version`
    exceeds the bound at `get` are dropped (`drops_stale`); None disables
    the bound."""

    def __init__(self, depth: int, max_staleness: Optional[int] = None,
                 policy: str = "drop_oldest", gauge_name: str = "traj_queue",
                 register_gauge: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if policy not in ("drop_oldest", "block"):
            raise ValueError(f"unknown policy {policy!r}")
        if max_staleness is not None and max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 or None")
        self.depth = int(depth)
        self.max_staleness = max_staleness
        self.policy = policy
        self._cv = threading.Condition()
        self._pending: deque[TrajBlock] = deque()
        self._free: list[dict[str, np.ndarray]] = []
        self._leased = 0
        self._seq = 0
        self._consumer_version = 0
        self._puts = 0
        self._gets = 0
        self._drops_full = 0
        self._drops_stale = 0
        self._last_staleness = 0
        self._max_staleness_seen = 0
        self._idle_s = 0.0
        self._closed = False
        self._gauge_key: Optional[str] = None
        if register_gauge:
            from actor_critic_tpu_torch.telemetry import sampler

            self._gauge_key = sampler.register_gauge(gauge_name, self.stats)

    # -- producer ----------------------------------------------------------
    def put(self, arrays: dict[str, np.ndarray], version: int, actor_id: int = 0,
            timeout: Optional[float] = None) -> bool:
        """Copy `arrays` into a queue slot. True once enqueued; False only
        under `policy="block"` when no slot freed within `timeout`."""
        with self._cv:
            if self.policy == "block":
                deadline = None if timeout is None else time.monotonic() + timeout
                while self._in_flight() >= self.depth:
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return False
                    self._cv.wait(0.1 if remaining is None else min(0.1, remaining))
            elif len(self._pending) and self._in_flight() >= self.depth:
                old = self._pending.popleft()
                self._free.append(old.arrays)
                self._drops_full += 1
            slot = self._free.pop() if self._free else {}
            for name, value in arrays.items():
                dst = slot.get(name)
                if dst is None or dst.shape != value.shape or dst.dtype != value.dtype:
                    slot[name] = value.copy()
                else:
                    np.copyto(dst, value)
            self._pending.append(TrajBlock(slot, int(version), int(actor_id), self._seq))
            self._seq += 1
            self._puts += 1
            self._cv.notify_all()
            return True

    def _in_flight(self) -> int:
        return len(self._pending) + self._leased

    # -- consumer ----------------------------------------------------------
    def set_consumer_version(self, version: int) -> None:
        """The learner's current version: the staleness bound's reference."""
        with self._cv:
            self._consumer_version = int(version)

    def get(self, timeout: Optional[float] = None) -> Optional[TrajBlock]:
        """The oldest fresh-enough block (leased until `release`), or None
        after `timeout` with nothing consumable. Time spent waiting adds up
        in `learner_idle_s`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.monotonic()
        with self._cv:
            try:
                while True:
                    while self._pending:
                        block = self._pending.popleft()
                        lag = self._consumer_version - block.version
                        if self.max_staleness is not None and lag > self.max_staleness:
                            self._free.append(block.arrays)
                            self._drops_stale += 1
                            self._cv.notify_all()
                            continue
                        self._leased += 1
                        self._gets += 1
                        self._last_staleness = max(lag, 0)
                        self._max_staleness_seen = max(self._max_staleness_seen,
                                                       self._last_staleness)
                        return block
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return None
                    self._cv.wait(0.1 if remaining is None else min(0.1, remaining))
            finally:
                self._idle_s += time.monotonic() - t0

    def release(self, block: TrajBlock) -> None:
        """Return a leased block's storage to the slot pool. Call it once
        the learner holds its own copy of the block (later puts rewrite the
        arrays)."""
        with self._cv:
            self._free.append(block.arrays)
            self._leased -= 1
            self._cv.notify_all()

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        with self._cv:
            return len(self._pending)

    def stats(self) -> dict:
        """Depth, drop counters, the version lag of the last consumed block
        (`observe_staleness`) and the learner's cumulative idle seconds."""
        with self._cv:
            return {
                "capacity": self.depth,
                "depth": len(self._pending),
                "leased": self._leased,
                "puts": self._puts,
                "gets": self._gets,
                "drops_full": self._drops_full,
                "drops_stale": self._drops_stale,
                "observe_staleness": self._last_staleness,
                "staleness_max": self._max_staleness_seen,
                "learner_idle_s": round(self._idle_s, 3),
            }

    def close(self) -> None:
        """Unregister the queue's gauge (idempotent: a second close, from a
        teardown racing an error path, is a no-op)."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            gauge_key, self._gauge_key = self._gauge_key, None
        if gauge_key is not None:
            from actor_critic_tpu_torch.telemetry import sampler

            sampler.unregister_gauge(gauge_key)


def validate_pools(pools) -> tuple:
    """(shared spec, per-actor env count) of an actor fleet: the learner
    runs ONE [K, E_a] update, so every pool must share one spec and
    width."""
    if not pools:
        raise ValueError("need at least one actor pool")
    spec = pools[0].spec
    E_a = pools[0].num_envs
    for p in pools[1:]:
        if p.spec != spec or p.num_envs != E_a:
            raise ValueError(
                "actor pools must share one env spec and num_envs (the learner runs ONE "
                "[K, E_a] update)")
    return spec, E_a


def consume_block(queue, actors: list, timeout: float = 0.5, context: str = ""):
    """Take ONE block for a learner loop, surfacing actor failures while
    waiting: a dead actor's exception is re-raised (`context` prefixes the
    message), and a fleet that has exited with nothing pending raises
    instead of spinning forever."""
    while True:
        block = queue.get(timeout=timeout)
        if block is not None:
            return block
        for a in actors:
            if a.error is not None:
                raise RuntimeError(f"{context}actor {a.actor_id} died") from a.error
        if not any(a.alive for a in actors):
            raise RuntimeError("every actor thread exited with no blocks pending")


def snapshot_frozen(tree: Any) -> Any:
    """A copy of every numpy leaf of a dict/list/tuple tree, each marked
    read-only: the publisher keeps THESE, so no caller holds a writable
    alias of what actors read, and an actor that writes into behaviour
    parameters fails at the write."""
    if isinstance(tree, np.ndarray):
        out = tree.copy()
        out.flags.writeable = False
        return out
    if isinstance(tree, dict):
        return {k: snapshot_frozen(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [snapshot_frozen(v) for v in tree]
        return type(tree)(*vals) if hasattr(type(tree), "_fields") else tuple(vals)
    if isinstance(tree, list):
        return [snapshot_frozen(v) for v in tree]
    return tree


class PolicyPublisher:
    """Thread-safe versioned store of numpy behaviour parameters.

    The learner `publish`es each update's INPUT parameters with version =
    blocks consumed so far; actors `get` the latest at block boundaries.
    `wait_for` is the strict mode's hook. Stored trees are frozen copies
    (`snapshot_frozen`). A tree with a NaN or an inf is refused
    (`NonFiniteError`, out of the learner's loop) and never installed: the
    actors keep acting with the last good one."""

    def __init__(self, params: Any, version: int = 0):
        self._cv = threading.Condition()
        self._params = snapshot_frozen(params)
        self._version = int(version)

    def publish(self, params: Any, version: int) -> None:
        numguard.check_finite(params, "behavior-params publish", name="params")
        snapshot = snapshot_frozen(params)  # copy OUTSIDE the lock
        with self._cv:
            self._params = snapshot
            self._version = int(version)
            self._cv.notify_all()

    def get(self) -> tuple[int, Any]:
        with self._cv:
            return self._version, self._params

    def wait_for(self, version: int, stop: Optional[threading.Event] = None,
                 timeout: Optional[float] = None) -> bool:
        """Block until the published version reaches `version` (True), or
        `stop` is set / `timeout` elapses (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._version < version:
                if stop is not None and stop.is_set():
                    return False
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(0.1 if remaining is None else min(0.1, remaining))
            return True


class ActorService:
    """One collection thread: refresh the behaviour parameters, collect a
    `[K, E, ...]` block through `host_loop.host_collect`, push it.

    `make_act_fn(np_params, rng) -> act_fn(obs) -> (action, extras)` builds
    the block's acting closure (PPO wires the numpy policy mirror here);
    `block_extras(np_params, last_obs, block) -> dict` appends arrays
    computed under the SAME behaviour parameters (PPO's mirror-computed
    truncation and rollout bootstraps). Every block also carries
    `last_obs`, the observation after its final step.

    `strict=True` reproduces the lockstep trainers' one-update-stale
    schedule: blocks 0 and 1 act under the initial parameters, block
    i >= 2 under version i-1. The actor's own work is numpy; the queue's
    `put` is its one hand-off (the device ring's enqueues the block's copy
    to the card there). `collect_s` adds up the thread's seconds in
    collection.

    `gate` (an Event, set when collection may go on) holds the actor at a
    block boundary while it is clear: the learners clear it while their
    update runs eagerly or is being captured on the card (the first three
    blocks), since each of the ~10^5 eager ops needs the GIL that an
    actor's numpy loop holds for up to the switch interval."""

    def __init__(self, actor_id: int, pool, queue, publisher: PolicyPublisher, num_steps: int,
                 make_act_fn: Callable[[Any, np.random.Generator], Callable],
                 rng: np.random.Generator, stop: threading.Event,
                 block_extras: Optional[Callable[[Any, np.ndarray, dict], dict]] = None,
                 strict: bool = False, gate: Optional[threading.Event] = None):
        from actor_critic_tpu_torch.algos.host_loop import BlockBuffers, EpisodeTracker

        self.actor_id = int(actor_id)
        self.pool = pool
        self.tracker = EpisodeTracker(pool.num_envs)
        # torchlint: thread-owned=actor (single writer: this service's own
        # thread bumps the progress counters; the learner only reads them for
        # its log rows and tolerates a read one block stale)
        self.steps_collected = 0
        # torchlint: thread-owned=actor (the same single-writer contract)
        self.blocks_pushed = 0
        # torchlint: thread-owned=actor (the same single-writer contract)
        self.collect_s = 0.0
        self.error: Optional[BaseException] = None
        self._queue = queue
        self._publisher = publisher
        self._num_steps = int(num_steps)
        self._make_act_fn = make_act_fn
        self._rng = rng
        self._stop = stop
        self._block_extras = block_extras
        self._strict = strict
        self._gate = gate
        self._buffers = BlockBuffers(num_steps)
        self._thread = threading.Thread(target=self._run, name=f"actor-{actor_id}", daemon=True)

    def start(self) -> "ActorService":
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread.ident is None:
            return  # never started (a resume that found the run done)
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _run(self) -> None:
        from actor_critic_tpu_torch.algos.host_loop import host_collect

        try:
            obs = self.pool.reset()
            i = 0
            while not self._stop.is_set():
                if self._gate is not None and not self._gate.wait(0.25):
                    continue
                if self._strict and i >= 2:
                    # The lockstep schedule: block i acts under version i-1.
                    if not self._publisher.wait_for(i - 1, stop=self._stop):
                        return
                version, params = self._publisher.get()
                t0 = time.perf_counter()
                act_fn = self._make_act_fn(params, self._rng)
                obs, block = host_collect(self.pool, obs, self._num_steps, act_fn, self.tracker,
                                          buffers=self._buffers)
                arrays = dict(block)
                arrays["last_obs"] = obs
                if self._block_extras is not None:
                    arrays.update(self._block_extras(params, obs, block))
                self.collect_s += time.perf_counter() - t0
                while not self._stop.is_set():
                    if self._queue.put(arrays, version=version, actor_id=self.actor_id,
                                       timeout=0.25):
                        self.blocks_pushed += 1
                        self.steps_collected += self._num_steps * self.pool.num_envs
                        break
                i += 1
        except BaseException as e:  # surfaced by the learner's consume_block
            self.error = e
