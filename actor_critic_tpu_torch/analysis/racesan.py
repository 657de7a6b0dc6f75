"""racesan: deterministic race sanitizer for the async actor–learner and
serving stack (counterpart of `actor_critic_tpu/analysis/racesan.py`).

Two tools, composable:

1. **Cooperative scheduler** (`CoopScheduler`): real threads, but at most
   ONE runs at a time. Every thread parks at yield points and a seeded
   `random.Random` picks who proceeds, so a seed replays its interleaving
   exactly (`trace` records it). Yield points come from `instrument()`
   (method boundaries) and `trace_locks()` (around lock acquire and
   release, never while holding, so a parked thread never holds a lock the
   running one needs). Participants must not block for real: exercisers
   use `policy="drop_oldest"` queues and `get(timeout=0)` retries, and a
   hung schedule trips `run()`'s deadline with a `RacesanError`.

2. **Write-after-publish poisoners**: `flags.writeable = False` on numpy
   blocks at the handoff, so a racing WRITE fails at its own site instead
   of corrupting quietly: `freeze_on_publish`, `freeze_on_deposit` and
   `freeze_on_swap` freeze the producer's retained tree, and
   `attach_queue_poisoner` freezes leased queue slots and scribbles a
   sentinel over released ones (a consumer that kept a zero-copy alias
   past `release` reads deterministic garbage). The device trajectory
   ring's blocks live on the card, out of the freeze's reach, so
   `attach_ring_poisoner` wraps the one choke point of every overwrite,
   `DeviceTrajRing._claim_slot_locked`: a claim of a leased slot raises.

The exercisers run the port's own objects: `TrajQueue`, `PolicyPublisher`,
`ParamMailbox`, `MicroBatcher` + `PolicyStore`, and `DeviceTrajRing`,
whose storage is on the card unless `device="cpu"`. Each has JAX's
reverted modes under JAX's parameter names (`consumer="alias"`,
`buggy_producer`, `buggy_depositor`, `alias_submit`, `buggy_swapper`,
`buggy_writer`, `consumer="released"`), every one caught. The schedule
draws are Python's, so a seed gives the JAX exerciser's interleaving
wherever the two objects take their locks alike.

    python -m actor_critic_tpu_torch.analysis.racesan              # quick profile
    python -m actor_critic_tpu_torch.analysis.racesan --scenario device_ring --device cuda

Exit codes: 0 clean, 1 race detected (or a poisoned write), 2 crash or
usage error.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np


class RacesanError(RuntimeError):
    """A detected race, or a schedule that stopped making progress."""


# ---------------------------------------------------------------------------
# cooperative scheduler
# ---------------------------------------------------------------------------


class CoopScheduler:
    """Seeded cooperative scheduler: spawned threads run one at a time,
    handing control over only at yield points, where the seeded RNG
    picks the next runnable thread. Candidate order is sorted by thread
    name before each pick, so OS arrival order cannot perturb replay."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._cv = threading.Condition()
        self._local = threading.local()
        # Written by spawn() only, before run() starts any participant
        # (guarded by _started); run() only reads.
        # torchlint: thread-owned=main (participants are registered by the
        # test's thread before run() starts any of them)
        self._threads: dict[str, threading.Thread] = {}
        self._runnable: set[str] = set()
        self._live: set[str] = set()
        self._current: Optional[str] = None
        self._aborted = False
        self._started = False
        # Start barrier: no picks until EVERY participant has parked at
        # its "start" yield — otherwise the first thread the OS happens
        # to run would schedule itself to completion before the others
        # even register, collapsing every seed onto one interleaving.
        self._open = False
        self.trace: list[tuple[str, str]] = []  # (thread, yield tag)
        self.errors: list[tuple[str, BaseException]] = []

    # -- registration ------------------------------------------------------

    def spawn(self, name: str, fn: Callable[[], None]) -> None:
        """Register a participant; threads start inside run()."""
        if self._started:
            raise RacesanError("spawn() after run() started")
        if name in self._threads:
            raise RacesanError(f"duplicate participant name {name!r}")

        def body() -> None:
            self._local.name = name
            try:
                self._park_until_scheduled("start")
                fn()
            except _Aborted:
                pass
            except BaseException as e:
                with self._cv:
                    self.errors.append((name, e))
                    # A dead participant ends the schedule: abort so
                    # the survivors unwind instead of yielding against
                    # a version/progress that will never arrive.
                    self._aborted = True
            finally:
                with self._cv:
                    self._live.discard(name)
                    self._runnable.discard(name)
                    if self._current == name:
                        self._pick_next_locked()
                    self._cv.notify_all()

        self._threads[name] = threading.Thread(
            target=body, name=f"racesan-{name}", daemon=True
        )

    # -- scheduling core ---------------------------------------------------

    def yield_point(self, tag: str = "") -> None:
        """Hand control back to the scheduler. No-op on threads the
        scheduler does not manage (the main thread driving setup)."""
        name = getattr(self._local, "name", None)
        if name is None:
            return
        self._park_until_scheduled(tag)

    def _park_until_scheduled(self, tag: str) -> None:
        name = self._local.name
        with self._cv:
            if self._aborted:
                # Checked at ENTRY too: a thread the scheduler picks
                # straight back (sole survivor ping-pong) never sits in
                # the wait loop below, and must still unwind.
                raise _Aborted()
            self._runnable.add(name)
            if self._open and (
                self._current == name or self._current is None
            ):
                self._pick_next_locked()
            self._cv.notify_all()
            while self._current != name:
                if self._aborted:
                    raise _Aborted()
                self._cv.wait(0.05)
            # Record on RESUMPTION, not on park: park order at the
            # start barrier is OS arrival order, but the sequence of
            # scheduling decisions is seed-deterministic — that is the
            # replayable trace.
            self.trace.append((name, tag))

    def _pick_next_locked(self) -> None:
        candidates = sorted(self._runnable)
        if not candidates:
            self._current = None
            return
        self._current = candidates[self._rng.randrange(len(candidates))]
        self._runnable.discard(self._current)

    # -- driving -----------------------------------------------------------

    def run(self, timeout_s: float = 10.0) -> list[tuple[str, str]]:
        """Start every participant, drive the schedule to completion,
        and return the trace. Raises the first participant error, or
        RacesanError if the schedule stops making progress before
        `timeout_s` (a real blocking wait inside a scheduled region)."""
        self._started = True
        with self._cv:
            self._live = set(self._threads)
        for t in self._threads.values():
            t.start()
        deadline = time.monotonic() + timeout_s
        with self._cv:
            # Start barrier: open the schedule only once every
            # participant is parked, then make the first (seeded) pick.
            while len(self._runnable) < len(self._live):
                if time.monotonic() > deadline:
                    break
                self._cv.wait(0.05)
            self._open = True
            if self._current is None:
                self._pick_next_locked()
            self._cv.notify_all()
            while self._live:
                if time.monotonic() > deadline:
                    self._aborted = True
                    self._cv.notify_all()
                    break
                self._cv.wait(0.05)
        for t in self._threads.values():
            t.join(timeout=1.0)
        if self.errors:
            name, err = self.errors[0]
            raise err
        with self._cv:
            if self._aborted:
                raise RacesanError(
                    f"schedule (seed={self.seed}) made no progress for "
                    f"{timeout_s:.0f}s — a participant blocked outside "
                    "the scheduler (real lock wait / full blocking "
                    "queue); racesan participants must stay non-blocking"
                )
            return list(self.trace)

    # -- instrumentation ---------------------------------------------------

    def instrument(self, obj: Any, *methods: str) -> Any:
        """Wrap bound methods with enter/exit yield points (in place)."""
        for m in methods:
            orig = getattr(obj, m)

            def wrapped(*a, __orig=orig, __m=m, **kw):
                self.yield_point(f"{__m}:enter")
                try:
                    return __orig(*a, **kw)
                finally:
                    self.yield_point(f"{__m}:exit")

            setattr(obj, m, wrapped)
        return obj

    def trace_locks(self, obj: Any, *attrs: str) -> Any:
        """Replace lock/condition attributes (default `_cv`) with traced
        proxies that yield BEFORE acquire and AFTER release — the
        boundaries where interleavings differ — never while holding."""
        for attr in attrs or ("_cv",):
            setattr(
                obj, attr, _TracedLock(getattr(obj, attr), self, attr)
            )
        return obj


class _Aborted(BaseException):
    """Internal: unwinds a parked thread when the schedule aborts."""


class _TracedLock:
    """Condition/Lock proxy adding scheduler yields around the `with`
    boundary. Everything else delegates, so `notify_all`/`wait` inside
    the wrapped object keep working."""

    def __init__(self, inner: Any, sched: CoopScheduler, tag: str):
        self._inner = inner
        self._sched = sched
        self._tag = tag

    def __enter__(self):
        self._sched.yield_point(f"{self._tag}:acquire")
        return self._inner.__enter__()

    def __exit__(self, *exc):
        out = self._inner.__exit__(*exc)
        self._sched.yield_point(f"{self._tag}:release")
        return out

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# write-after-publish poisoner
# ---------------------------------------------------------------------------


def iter_array_leaves(tree: Any):
    """Yield every ndarray in a dict/list/tuple-structured tree."""
    if isinstance(tree, np.ndarray):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_array_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_array_leaves(v)


def freeze_leaves(tree: Any) -> Any:
    """writeable=False on every leaf IN PLACE: the write-after-publish
    tripwire — a racing in-place write now raises ValueError at its own
    site. Returns the tree for chaining."""
    for a in iter_array_leaves(tree):
        a.flags.writeable = False
    return tree


def thaw_leaves(tree: Any) -> Any:
    for a in iter_array_leaves(tree):
        if a.base is None:  # views regain writability through their base
            a.flags.writeable = True
    return tree


def _scribble_value(dtype: np.dtype):
    if np.issubdtype(dtype, np.floating):
        return np.finfo(dtype).min
    if np.issubdtype(dtype, np.bool_):
        return True
    if np.issubdtype(dtype, np.integer):
        return np.iinfo(dtype).min
    return 0


def scribble_leaves(tree: Any) -> Any:
    """Overwrite every leaf with its dtype's sentinel — the quarantine
    fill that turns a stale zero-copy alias into deterministic garbage
    instead of a schedule-dependent corruption."""
    for a in iter_array_leaves(tree):
        a.fill(_scribble_value(a.dtype))
    return tree


def freeze_on_publish(publisher: Any) -> Any:
    """Wrap `publisher.publish` so the PRODUCER'S RETAINED view of every
    published params tree is frozen at the publish boundary: mutating it
    in place afterwards crashes at the write site. (The hardened
    `PolicyPublisher` additionally snapshots+freezes what it STORES; the
    poisoner covers the producer's own copy, and any publisher-shaped
    object that still stores by reference.)"""
    orig = publisher.publish

    def publish(params: Any, version: int) -> None:
        freeze_leaves(params)
        return orig(params, version)

    publisher.publish = publish
    return publisher


def freeze_on_deposit(mailbox: Any) -> Any:
    """Wrap `mailbox.deposit` so the DEPOSITOR'S retained view of every
    deposited params tree is frozen at the deposit boundary — the
    mailbox-writer mirror of `freeze_on_publish`: an in-place refresh
    of a tree the learner may still be consuming crashes at the write
    site. (The hardened `ParamMailbox` additionally snapshots+freezes
    what it STORES — same contract as `PolicyPublisher.publish`.)"""
    orig = mailbox.deposit

    def deposit(params: Any, version: int, peer: int) -> bool:
        freeze_leaves(params)
        return orig(params, version, peer)

    mailbox.deposit = deposit
    return mailbox


def attach_queue_poisoner(queue: Any, scribble: bool = True) -> Any:
    """Poison a TrajQueue-shaped object (get/release protocol):

    - `get` freezes the leased block's slot arrays — any producer-side
      write into a slot the consumer still holds (a recycle-under-the-
      learner race) raises at the write site;
    - `release` thaws, then (with `scribble`) sentinel-fills the slot
      BEFORE it re-enters the pool — a consumer alias held past release
      reads the sentinel deterministically."""
    orig_get = queue.get
    orig_release = queue.release

    def get(timeout: Optional[float] = None):
        block = orig_get(timeout)
        if block is not None:
            freeze_leaves(block.arrays)
        return block

    def release(block) -> None:
        thaw_leaves(block.arrays)
        if scribble:
            scribble_leaves(block.arrays)
        orig_release(block)

    queue.get = get
    queue.release = release
    return queue


# ---------------------------------------------------------------------------
# exercisers
# ---------------------------------------------------------------------------


def _fill_value(producer: int, block: int) -> float:
    return float(producer * 1000 + block + 1)


def exercise_queue(
    seed: int,
    producers: int = 2,
    blocks_per_producer: int = 4,
    depth: int = 2,
    shape: tuple[int, ...] = (4, 3),
    poison: bool = True,
    consumer: str = "snapshot",
    timeout_s: float = 10.0,
) -> dict:
    """One seeded schedule over a TrajQueue: P producers refill a
    preallocated buffer and put(); one consumer drains with
    `get(timeout=0)` retries and verifies every consumed block is a
    uniform fill (torn or recycled storage shows mixed values).

    `consumer="snapshot"` is the correct consumer (np.array before
    release); `consumer="alias"` reproduces the reverted copy-on-
    transfer bug (np.asarray view read after release) — under the
    poisoner's scribble it is detected on EVERY schedule. Returns a
    report dict; detection raises RacesanError via run()."""
    from actor_critic_tpu_torch.algos.traj_queue import TrajQueue

    if consumer not in ("snapshot", "alias"):
        raise ValueError(f"unknown consumer mode {consumer!r}")
    queue = TrajQueue(
        depth=depth, policy="drop_oldest", register_gauge=False
    )
    sched = CoopScheduler(seed)
    sched.trace_locks(queue, "_cv")
    if poison:
        attach_queue_poisoner(queue)
    report = {
        "seed": seed, "consumed": 0, "produced": 0,
        "race_detected": False, "consumer": consumer,
    }
    done = {"producers": 0}

    def producer(p: int) -> None:
        buf = np.zeros(shape, np.float32)
        for b in range(blocks_per_producer):
            buf.fill(_fill_value(p, b))
            sched.yield_point("filled")
            # Deliberate reuse of the fill buffer: TrajQueue.put copies
            # into its own pool, the producer contract under test.
            # torchlint: disable=publish-aliasing (the contract under test)
            queue.put({"x": buf}, version=b, actor_id=p)
        # Participants are serialized by the scheduler (one runs at a
        # time), so the shared progress dict needs no lock here.
        done["producers"] += 1

    def consume() -> None:
        expect = producers * blocks_per_producer
        while True:
            all_done = done["producers"] >= producers
            block = queue.get(timeout=0)
            if block is None:
                if all_done and len(queue) == 0:
                    return
                sched.yield_point("idle")
                continue
            if consumer == "snapshot":
                view = {k: np.array(v) for k, v in block.arrays.items()}
                queue.release(block)
            else:
                # The reverted copy-on-transfer consumer: a zero-copy
                # view, released before the read completes (the bug the
                # poisoner must catch).
                # torchlint: disable=publish-aliasing (the revert under test)
                view = {k: np.asarray(v) for k, v in block.arrays.items()}
                queue.release(block)
                sched.yield_point("post-release")
            x = view["x"]
            uniform = bool(np.all(x == x.flat[0]))
            expected = {
                _fill_value(p, b)
                for p in range(producers)
                for b in range(blocks_per_producer)
            }
            if not uniform or float(x.flat[0]) not in expected:
                report["race_detected"] = True
                raise RacesanError(
                    f"consumed block corrupted under seed {seed}: "
                    f"uniform={uniform}, value={float(x.flat[0])!r} — "
                    "slot storage was recycled/scribbled while a view "
                    "was still live (zero-copy alias class)"
                )
            report["consumed"] += 1
            if report["consumed"] >= expect:
                return

    for p in range(producers):
        sched.spawn(f"producer-{p}", lambda p=p: producer(p))
    sched.spawn("consumer", consume)
    try:
        sched.run(timeout_s=timeout_s)
    finally:
        report["produced"] = queue.stats()["puts"]
        report["trace_len"] = len(sched.trace)
        queue.close()
    return report


def exercise_publisher(
    seed: int,
    versions: int = 6,
    actors: int = 2,
    shape: tuple[int, ...] = (3, 2),
    poison: bool = True,
    buggy_producer: bool = False,
    timeout_s: float = 10.0,
) -> dict:
    """One seeded schedule over a PolicyPublisher: a learner publishes
    uniform-fill params trees, actor threads read and verify uniformity.
    `buggy_producer=True` mutates the producer's RETAINED tree in place
    after publishing — the write-after-publish poisoner turns that into
    a ValueError at the mutation site on every schedule."""
    from actor_critic_tpu_torch.algos.traj_queue import PolicyPublisher

    sched = CoopScheduler(seed)
    params0 = {"w": np.full(shape, 0.5, np.float32)}
    publisher = PolicyPublisher(params0, version=0)
    if poison:
        freeze_on_publish(publisher)
    report = {
        "seed": seed, "published": 0, "reads": 0, "race_detected": False,
    }

    def learner() -> None:
        retained = {"w": np.full(shape, 0.5, np.float32)}
        for v in range(1, versions + 1):
            if buggy_producer:
                # In-place refresh of the SAME tree that was published
                # last round — the write-after-publish hazard the poisoner
                # freezes: crashes here, at the write.
                retained["w"][...] = float(v)
            else:
                retained = {"w": np.full(shape, float(v), np.float32)}
            sched.yield_point("pre-publish")
            publisher.publish(retained, version=v)
            report["published"] = v
            sched.yield_point("published")

    def actor(i: int) -> None:
        # Read (and verify) until the final version is observed — the
        # learner always publishes it, so every schedule terminates.
        while True:
            version, params = publisher.get()
            w = params["w"]
            if not bool(np.all(w == w.flat[0])):
                report["race_detected"] = True
                raise RacesanError(
                    f"actor {i} read torn params at version {version} "
                    f"under seed {seed}"
                )
            report["reads"] += 1
            if version >= versions:
                return
            sched.yield_point("read")

    sched.spawn("learner", learner)
    for i in range(actors):
        sched.spawn(f"actor-{i}", lambda i=i: actor(i))
    sched.run(timeout_s=timeout_s)
    return report


def exercise_mailbox(
    seed: int,
    versions: int = 6,
    consumers: int = 2,
    shape: tuple[int, ...] = (3, 2),
    poison: bool = True,
    buggy_depositor: bool = False,
    timeout_s: float = 10.0,
) -> dict:
    """One seeded schedule over the multihost `ParamMailbox`:
    a writer-role thread deposits uniform-fill peer-param trees with
    increasing versions; consumer threads `take`/`peek` and verify
    uniformity (torn storage shows mixed values) and strict version
    monotonicity across takes (latest-wins must never hand a consumer
    an older tree than one it already took). `buggy_depositor=True`
    refreshes the depositor's RETAINED tree in place after depositing —
    under the poisoner that crashes at the write site on every
    schedule, the same frozen-snapshot contract
    `PolicyPublisher.publish` carries."""
    from actor_critic_tpu_torch.parallel.multihost import ParamMailbox

    sched = CoopScheduler(seed)
    mailbox = ParamMailbox()
    sched.trace_locks(mailbox, "_lock")
    if poison:
        freeze_on_deposit(mailbox)
    report = {
        "seed": seed, "deposits": 0, "takes": 0, "reads": 0,
        "race_detected": False,
    }

    def writer() -> None:
        retained = {"w": np.full(shape, 0.0, np.float32)}
        for v in range(1, versions + 1):
            if buggy_depositor:
                # In-place refresh of the tree deposited last round —
                # the hazard the freeze turns into a write-site crash.
                retained["w"][...] = float(v)
            else:
                retained = {"w": np.full(shape, float(v), np.float32)}
            sched.yield_point("pre-deposit")
            mailbox.deposit(retained, version=v, peer=0)
            report["deposits"] = v
            sched.yield_point("deposited")

    def consumer(i: int) -> None:
        last_taken = -1
        while True:
            out = mailbox.take()
            if out is not None:
                version, _, params = out
                w = params["w"]
                if not bool(np.all(w == w.flat[0])):
                    report["race_detected"] = True
                    raise RacesanError(
                        f"consumer {i} took torn mailbox params at "
                        f"version {version} under seed {seed}"
                    )
                if version <= last_taken:
                    report["race_detected"] = True
                    raise RacesanError(
                        f"mailbox handed consumer {i} version {version} "
                        f"after {last_taken} under seed {seed} — "
                        "latest-wins violated"
                    )
                last_taken = version
                report["takes"] += 1
            peeked = mailbox.peek()
            report["reads"] += 1
            if peeked is not None and peeked[0] >= versions:
                return
            sched.yield_point("idle")

    sched.spawn("mailbox-writer", writer)
    for i in range(consumers):
        sched.spawn(f"consumer-{i}", lambda i=i: consumer(i))
    sched.run(timeout_s=timeout_s)
    return report


def attach_batcher_poisoner(batcher: Any) -> Any:
    """Freeze every enqueued payload at the submit boundary (the
    serving MicroBatcher's handoff): with the correct
    copy-on-submit the frozen array is the batcher's OWN copy — nobody
    may write an enqueued payload — while with `copy=False` (the
    aliasing submit `exercise_batcher(alias_submit=True)` drives) the
    frozen array IS the client's buffer, so the client's next in-place
    refill crashes at the write site on every schedule. One poisoner,
    both contracts — the queue-slot freeze logic pointed at the
    serving handoff."""
    orig = batcher.submit

    def submit(obs, policy_id=None, copy=True):
        req = orig(obs, policy_id=policy_id, copy=copy)
        freeze_leaves(req.obs)
        return req

    batcher.submit = submit
    return batcher


def freeze_on_swap(store: Any) -> Any:
    """Wrap `store.swap` so the SWAPPER'S retained view of every
    installed params tree is frozen at the swap boundary — the
    policy-store mirror of `freeze_on_publish`: an in-place refresh of
    a tree whose copy a flush may still be serving crashes at the write
    site. (The store's install path additionally snapshots what it
    STORES via the engine's prepare_params.)"""
    orig = store.swap

    def swap(policy_id, params, version=None, prepare=True):
        freeze_leaves(params)
        return orig(policy_id, params, version=version, prepare=prepare)

    store.swap = swap
    return store


class _StubServingEngine:
    """Device-free engine stand-in for the batcher exerciser: action =
    obs[:, 0] * params['scale'][0], so every response is checkable
    against the version it claims (scale == version + 1). Carries the
    frozen-snapshot install contract the real engine's prepare_params
    provides (`DeviceParams`: device tensors nothing writes after)."""

    max_rows = 8

    def prepare_params(self, params: Any) -> Any:
        return freeze_leaves({k: np.array(v) for k, v in params.items()})

    def act(self, params: Any, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs)[:, 0] * params["scale"][0]


def exercise_batcher(
    seed: int,
    clients: int = 2,
    requests_per_client: int = 4,
    swaps: int = 3,
    poison: bool = True,
    alias_submit: bool = False,
    buggy_swapper: bool = False,
    timeout_s: float = 10.0,
) -> dict:
    """One seeded schedule over the serving MicroBatcher + PolicyStore
    client threads submit uniform-fill obs batches of mixed
    row counts, a swapper thread hot-swaps the resident policy between
    flushes, and the dispatcher runs as an explicit participant
    (`start=False` + `_flush_once(block=False)`). Every response must
    equal fill * (version + 1) for the VERSION IT CLAIMS (a flush that
    mixes params across a swap, or tears a payload, breaks this), and
    per-client versions must be non-decreasing (FIFO flush order).

    `alias_submit=True` reproduces the payload-aliasing submit
    (`copy=False` + client buffer reuse) — under the poisoner the
    client's refill crashes at the write site on every schedule.
    `buggy_swapper=True` mutates the swapper's RETAINED params tree in
    place after installing it — `freeze_on_swap` turns that into a
    ValueError at the mutation site."""
    from actor_critic_tpu_torch.serving.batcher import MicroBatcher
    from actor_critic_tpu_torch.serving.policy_store import PolicyStore

    obs_dim = 2
    sched = CoopScheduler(seed)
    store = PolicyStore()
    engine = _StubServingEngine()
    store.register("default", engine, {"scale": np.ones(1, np.float32)})
    batcher = MicroBatcher(
        store, max_wait_us=0.0, queue_limit=64, start=False
    )
    sched.trace_locks(batcher, "_cv")
    sched.trace_locks(store, "_lock")
    if poison:
        attach_batcher_poisoner(batcher)
        freeze_on_swap(store)
    report = {
        "seed": seed, "responses": 0, "swaps": 0, "scrapes": 0,
        "race_detected": False, "alias_submit": alias_submit,
    }
    progress = {"clients_done": 0, "swapper_done": False}

    def _fill(c: int, i: int) -> float:
        return float(100 * c + i + 1)

    def client(c: int) -> None:
        rows = (c % 3) + 1
        buf = np.zeros((rows, obs_dim), np.float32)
        reqs = []
        for i in range(requests_per_client):
            if alias_submit:
                # Refill the SAME buffer the previous submit aliased —
                # under the poisoner's freeze this write (i > 0) is the
                # crash site; without it, value checks catch the tear
                # on schedules that flush after the refill.
                buf.fill(_fill(c, i))
                req = batcher.submit(buf, copy=False)
            else:
                buf = np.full((rows, obs_dim), _fill(c, i), np.float32)
                req = batcher.submit(buf, copy=True)
            reqs.append((i, req))
            sched.yield_point("submitted")
        last_version = -1
        for i, req in reqs:
            while not req.done.is_set():
                sched.yield_point("awaiting")
            if req.error is not None:
                raise req.error
            actions, version = req.result
            expect = _fill(c, i) * (version + 1.0)
            ok = actions.shape == (rows,) and bool(
                np.all(actions == expect)
            )
            if not ok or version < last_version:
                report["race_detected"] = True
                raise RacesanError(
                    f"client {c} request {i}: got {actions!r} under "
                    f"version {version} (after {last_version}), expected "
                    f"uniform {expect} under seed {seed} — torn payload "
                    "or cross-version flush"
                )
            last_version = version
            report["responses"] += 1
        # Serialized by the scheduler; no lock needed (exercise_queue's
        # progress-dict convention).
        progress["clients_done"] += 1

    def swapper() -> None:
        retained = {"scale": np.ones(1, np.float32)}
        for v in range(1, swaps + 1):
            if buggy_swapper:
                # In-place refresh of the tree installed last round —
                # the frozen-snapshot install crashes this write.
                retained["scale"][...] = float(v + 1)
            else:
                retained = {"scale": np.full(1, float(v + 1), np.float32)}
            sched.yield_point("pre-swap")
            store.swap("default", retained, version=v)
            report["swaps"] = v
            sched.yield_point("swapped")
        progress["swapper_done"] = True

    def dispatcher() -> None:
        while True:
            drained = (
                progress["clients_done"] >= clients
                and progress["swapper_done"]
                and batcher.queue_depth() == 0
            )
            if drained:
                return
            batcher._flush_once(block=False)
            sched.yield_point("flushed")

    def scraper() -> None:
        # A /metrics scrape as a schedule participant: the
        # exporter's reads — gauge() + per-policy histogram snapshots —
        # interleave with hot-swaps and flushes on every seeded
        # schedule. A scrape must never see a torn histogram (cumulative
        # buckets non-monotone, or +Inf bucket != count) and its
        # counters must never run backwards between scrapes.
        from actor_critic_tpu_torch.telemetry import histo

        last_count: dict = {}
        while not (
            progress["clients_done"] >= clients
            and progress["swapper_done"]
        ):
            row = batcher.gauge()
            report["scrapes"] += 1
            for k, v in row.items():
                if not histo.is_snapshot(v):
                    continue
                cum = v["buckets"]
                if any(b < a for b, a in zip(cum[1:], cum)) or (
                    cum[-1] != v["count"]
                ):
                    report["race_detected"] = True
                    raise RacesanError(
                        f"scrape saw torn histogram {k}: buckets {cum} "
                        f"count {v['count']} under seed {seed}"
                    )
                if v["count"] < last_count.get(k, 0):
                    report["race_detected"] = True
                    raise RacesanError(
                        f"scrape saw histogram {k} count run backwards "
                        f"({last_count[k]} -> {v['count']}) under "
                        f"seed {seed}"
                    )
                last_count[k] = v["count"]
            sched.yield_point("scraped")

    for c in range(clients):
        sched.spawn(f"client-{c}", lambda c=c: client(c))
    sched.spawn("swapper", swapper)
    sched.spawn("dispatcher", dispatcher)
    sched.spawn("scraper", scraper)
    try:
        sched.run(timeout_s=timeout_s)
    finally:
        report["queue_depth"] = batcher.queue_depth()
        batcher.close(timeout=0.1)
    return report


def attach_ring_poisoner(ring: Any) -> Any:
    """Leased-slot write tripwire for the device trajectory ring
    (`data_plane/ring.py::DeviceTrajRing`). Its blocks live on the card, out
    of the numpy freeze's reach, but every overwrite passes through one
    choke point, the slot claim: wrap `_claim_slot_locked` so a put that
    claims a slot the learner still holds LEASED fails at the claim. The
    correct ring never trips it (leased slots are never free or reclaimed);
    the `buggy_writer` revert of `exercise_device_ring` (drop-oldest
    reclaiming a lease as if it were pending) trips it on every schedule
    where the writer meets a held lease."""
    orig = ring._claim_slot_locked

    def claim():
        slot = orig()
        if slot is not None and slot in ring._leased:
            raise RacesanError(
                f"device-ring enqueue claimed LEASED slot {slot} — the "
                "learner's in-flight gather would read the overwrite "
                "(write-after-publish, device-plane class)"
            )
        return slot

    ring._claim_slot_locked = claim
    return ring


def exercise_device_ring(
    seed: int,
    producers: int = 2,
    blocks_per_producer: int = 3,
    depth: int = 2,
    poison: bool = True,
    consumer: str = "leased",
    buggy_writer: bool = False,
    timeout_s: float = 30.0,
    device: str = "cuda",
) -> dict:
    """One seeded schedule over the REAL `DeviceTrajRing` on `device`:
    producer threads enqueue uniform-fill blocks (encoded on the host,
    copied into the slot's storage on the slot's stream), a consumer leases
    slots, reads each back from the card after `select` (the wait on the
    slot's enqueue), and checks it is the uniform fill its lease's version
    promises: actor-enqueue against learner-gather interleavings, one
    thread at a time.

    `consumer="released"` is the alias-class bug: the consumer RELEASES the
    slot before reading it, so a drop-oldest overwrite of the freed slot
    lands under its read; the value check catches it on the schedules
    where the writer runs inside the window. `buggy_writer=True` reverts
    the lease protection (drop-oldest may reclaim a LEASED slot as if it
    were pending); the poisoner's claim check catches it on every schedule
    where a full ring meets a held lease."""
    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.data_plane import ring as dp_ring

    if consumer not in ("leased", "released"):
        raise ValueError(f"unknown consumer mode {consumer!r}")
    if buggy_writer:
        # Depth 1 makes the hazard unconditional: while the consumer holds
        # the one slot's lease, every put finds free and pending empty and
        # the reverted claim reaches for the leased slot.
        depth = 1
    block_spec = {"x": dp_ring.array_spec((2, 2), np.float32)}
    ring = dp_ring.DeviceTrajRing(
        depth=depth, block_spec=block_spec, codec="fp32",
        policy="drop_oldest", register_gauge=False, device=resolve_device(device),
    )
    if buggy_writer:
        # Reverted lease protection: a leased slot treated like a pending one.
        orig_claim = ring._claim_slot_locked

        def claim_ignoring_leases():
            slot = orig_claim()
            if slot is None and ring._leased:
                slot = next(iter(sorted(ring._leased)))
                ring._drops_full += 1
            return slot

        ring._claim_slot_locked = claim_ignoring_leases
    sched = CoopScheduler(seed)
    sched.trace_locks(ring, "_cv")
    if poison:
        attach_ring_poisoner(ring)
    report = {
        "seed": seed, "consumed": 0, "race_detected": False,
        "consumer": consumer,
    }
    done = {"producers": 0}
    expect = {
        float(_fill_value(p, b))
        for p in range(producers)
        for b in range(blocks_per_producer)
    }

    def producer(p: int) -> None:
        buf = np.zeros((2, 2), np.float32)
        payload = {"x": buf}
        for b in range(blocks_per_producer):
            fill = _fill_value(p, b)
            buf.fill(fill)
            sched.yield_point("filled")
            while True:
                # Deliberate reuse of the fill buffer: put encodes (copies)
                # the arrays on the host before the copy to the card.
                if ring.put(payload, int(fill), p, timeout=0):
                    break
                sched.yield_point("put-retry")
        done["producers"] += 1  # serialized by the scheduler

    def consume() -> None:
        total = producers * blocks_per_producer
        while True:
            all_done = done["producers"] >= producers
            lease = ring.get(timeout=0)
            if lease is None:
                if all_done and len(ring) == 0:
                    return
                sched.yield_point("idle")
                continue
            # A yield while the lease is held: the port's put claims a slot
            # and publishes its lease in two locked sections with the copy
            # between (JAX's claims, writes and publishes in one), so
            # without it fewer schedules let a writer meet a held lease.
            sched.yield_point("leased")
            if consumer == "released":
                # The bug: the slot re-enters the writable pool while this
                # thread still means to read it.
                ring.release(lease)
                sched.yield_point("post-release")
            ring.select(lease)
            x = ring.state.storage["x"][lease.slot].cpu().numpy()
            uniform = bool(np.all(x == x.flat[0]))
            value = float(x.flat[0])
            if not uniform or value != float(lease.version) or (
                value not in expect
            ):
                report["race_detected"] = True
                raise RacesanError(
                    f"device-ring block corrupted under seed {seed}: "
                    f"uniform={uniform}, value={value!r}, lease version "
                    f"{lease.version} — a slot was overwritten under a "
                    "live read (device-plane zero-copy class)"
                )
            if consumer == "leased":
                ring.release(lease)
            report["consumed"] += 1
            if report["consumed"] >= total:
                return

    for p in range(producers):
        sched.spawn(f"producer-{p}", lambda p=p: producer(p))
    sched.spawn("consumer", consume)
    try:
        sched.run(timeout_s=timeout_s)
    finally:
        report["produced"] = ring.stats()["puts"]
        report["trace_len"] = len(sched.trace)
        ring.close()
    return report


def exercise_sweep(
    seeds: Iterable[int],
    scenario: Callable[[int], dict],
) -> dict:
    """Run `scenario(seed)` across seeds; aggregate. Detection raises — a
    clean sweep returns counts a caller can assert on."""
    reports = []
    for seed in seeds:
        reports.append(scenario(seed))
    return {
        "schedules": len(reports),
        "consumed": sum(r.get("consumed", 0) for r in reports),
        "reads": sum(r.get("reads", 0) for r in reports),
        "published": sum(r.get("published", 0) for r in reports),
        "deposits": sum(r.get("deposits", 0) for r in reports),
        "takes": sum(r.get("takes", 0) for r in reports),
        "responses": sum(r.get("responses", 0) for r in reports),
        "swaps": sum(r.get("swaps", 0) for r in reports),
        "scrapes": sum(r.get("scrapes", 0) for r in reports),
        "races": sum(1 for r in reports if r.get("race_detected")),
    }


def quick_profile(schedules: int = 100, seed0: int = 0) -> dict:
    """The fast profile: `schedules` seeded interleavings split across the
    queue (snapshot consumer, poisoned), publisher (correct producer,
    poisoned), param-mailbox (correct depositor, poisoned) and serving
    micro-batcher (copy-on-submit, poisoned, request/flush/hot-swap
    interleavings) units; every schedule must sweep clean. JAX's split:
    the device ring runs only when asked for (`--scenario device_ring`)."""
    quarter = max(schedules // 4, 1)
    q = exercise_sweep(
        range(seed0, seed0 + quarter),
        lambda s: exercise_queue(s, poison=True, consumer="snapshot"),
    )
    p = exercise_sweep(
        range(seed0, seed0 + quarter),
        lambda s: exercise_publisher(s, poison=True),
    )
    m = exercise_sweep(
        range(seed0, seed0 + quarter),
        lambda s: exercise_mailbox(s, poison=True),
    )
    b = exercise_sweep(
        range(seed0, seed0 + (schedules - 3 * quarter)),
        lambda s: exercise_batcher(s, poison=True),
    )
    return {
        "schedules": (
            q["schedules"] + p["schedules"] + m["schedules"]
            + b["schedules"]
        ),
        "queue": q,
        "publisher": p,
        "mailbox": m,
        "batcher": b,
        "races": q["races"] + p["races"] + m["races"] + b["races"],
    }


def main(argv=None) -> int:
    """The CLI (JAX's `scripts/racesan.py`, with `--device`)."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(
        prog="python -m actor_critic_tpu_torch.analysis.racesan",
        description="deterministic-schedule race exerciser for the async actor–learner stack")
    p.add_argument("--schedules", type=int, default=100,
                   help="seeded interleavings to sweep (default 100, the quick profile)")
    p.add_argument("--seed0", type=int, default=0,
                   help="first seed of the sweep (default 0: fixed seeds keep runs deterministic)")
    p.add_argument("--scenario",
                   choices=("all", "queue", "publisher", "mailbox", "batcher", "device_ring"),
                   default="all",
                   help="which unit to exercise (default: the four host units, split evenly; "
                   "device_ring drives the device trajectory ring's enqueue-vs-gather "
                   "interleavings, on --device, only when asked for)")
    p.add_argument("--consumer", choices=("snapshot", "alias"), default="snapshot",
                   help="queue consumer mode: 'alias' reproduces the reverted copy-on-transfer "
                   "consumer (expected exit 1). For --scenario device_ring, 'alias' maps to the "
                   "release-before-read consumer (same bug class; expected exit 1)")
    p.add_argument("--writer", choices=("correct", "buggy"), default="correct",
                   help="device_ring writer mode: 'buggy' reverts the leased-slot protection "
                   "(drop-oldest reclaims a slot the learner still holds); the ring poisoner "
                   "catches it at the claim site (expected exit 1)")
    p.add_argument("--submit", choices=("copy", "alias"), default="copy",
                   help="batcher submit mode: 'alias' reproduces a zero-copy payload submit "
                   "under client buffer reuse (expected exit 1)")
    p.add_argument("--no-poison", action="store_true",
                   help="disable the write-after-publish poisoner (schedule permutation only)")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the device ring's storage lives (default: the card)")
    args = p.parse_args(argv)

    poison = not args.no_poison
    seeds = range(args.seed0, args.seed0 + args.schedules)
    try:
        if args.scenario == "all":
            out = quick_profile(schedules=args.schedules, seed0=args.seed0)
        elif args.scenario == "queue":
            out = exercise_sweep(
                seeds, lambda s: exercise_queue(s, poison=poison, consumer=args.consumer))
        elif args.scenario == "mailbox":
            out = exercise_sweep(seeds, lambda s: exercise_mailbox(s, poison=poison))
        elif args.scenario == "device_ring":
            out = exercise_sweep(seeds, lambda s: exercise_device_ring(
                s, poison=poison,
                consumer="released" if args.consumer == "alias" else "leased",
                buggy_writer=args.writer == "buggy", device=args.device))
        elif args.scenario == "batcher":
            out = exercise_sweep(seeds, lambda s: exercise_batcher(
                s, poison=poison, alias_submit=args.submit == "alias"))
        else:
            out = exercise_sweep(seeds, lambda s: exercise_publisher(s, poison=poison))
    except RacesanError as e:
        # A detected race names its seed: rerun that seed to replay it.
        print(f"racesan: RACE DETECTED: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        if "read-only" not in str(e):
            # Only numpy's read-only write error is a detection; any other
            # ValueError is a broken exerciser.
            print(f"racesan: error: {type(e).__name__}: {e}", file=sys.stderr)
            return 2
        print(f"racesan: RACE DETECTED (poisoned write): {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"racesan: error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(out, indent=2))
    else:
        print(f"racesan: {out.get('schedules', 0)} schedule(s) clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
