"""GA3C-style micro-batcher for the serving gateway (counterpart of
`actor_critic_tpu/serving/batcher.py`; arxiv 1611.06256).

Concurrent `POST /v1/act` handler threads enqueue requests into ONE
bounded queue; a single dispatcher thread drains it, groups rows by
policy id, and flushes each group through the policy's bucketed act
program, so N concurrent batch-1 requests cost one graph replay at
bucket(N), not N of them. The `max_wait_us` knob is the p99/occupancy
trade: the dispatcher holds the first request of a flush at most that
long while more rows accumulate.

Threading model:

- client (HTTP handler) threads: `submit` appends under `_cv`, then
  block on the request's own `done` event;
- the single `serve-dispatcher` thread: drains `_pending` under `_cv`,
  dispatches OUTSIDE the lock (a flush must not block enqueues),
  completes requests — or, with `max_inflight > 1`, hands each packed
  flush to one of `max_inflight` `serve-flight-*` worker threads through
  a 1-deep handoff queue, so flush N+1 PACKS while flush N is on the card
  (the engine gives each concurrent flush a lane of its own);
- metrics readers: `ServingMetrics.snapshot()` / `health()`, which lock
  or read GIL-atomic values only.

Admission control: alongside the queue-capacity reject (`QueueFull`), a
burn-rate-aware shed path — when the queue is saturated past
`shed_queue_frac` of its capacity AND the target policy's SLO burn rate
is at/over `shed_burn_threshold`, `submit` raises `Overloaded` (503)
instead of queueing a request that would blow its SLO anyway. Only
SLO-classed policies shed at admission; sheds count on `record_shed`,
rejects on `record_reject`, so the two 503 flavors stay apart.

Requests are COPIED at submit (`np.array`) so the batcher owns every
payload: a client reusing its obs buffer after submit() cannot tear a
flush.

Tracing: with a telemetry session (the gateway's, through
`session_resolver`, else the process's current one) every flush emits a
`serve_dispatch` span and, per traced request, a `serve_queue_wait` span
and a flow step that links it to the request's gateway-thread track
(`_emit_flush_trace`). Host-side JSON only: nothing here touches the
card. Without a session nothing is emitted.
"""

from __future__ import annotations

import itertools
import math
import queue as _queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from actor_critic_tpu_torch.serving.policy_store import PolicyStore
from actor_critic_tpu_torch.telemetry import histo
from actor_critic_tpu_torch.telemetry.session import current as _telemetry_current
from actor_critic_tpu_torch.telemetry.spans import flow_id_of


class QueueFull(RuntimeError):
    """The bounded request queue is at capacity (gateway: HTTP 503)."""


class DispatcherDown(RuntimeError):
    """The dispatcher thread is not running (gateway: HTTP 503)."""


class Overloaded(RuntimeError):
    """Shed at admission (gateway: HTTP 503): the queue is saturated
    and the target policy is already burning its SLO error budget, so
    queueing would only manufacture another violation. Distinct from
    `QueueFull` — the queue still has room; the POLICY has no latency
    budget left (counted on the shed counter, not the reject one)."""


def _percentile(sorted_vals: list, p: float) -> float:
    """Linearly-interpolated percentile of an already-sorted list (0 if
    empty). Nearest-rank was fine at the full 2048-sample window but on
    a tiny cold-start window it degenerates — p99 of 10 samples IS the
    max, and one outlier becomes the reported truth. Interpolating between the straddling ranks matches
    numpy's default 'linear' method; callers report the window size
    alongside so small-n rows read as what they are."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_vals[0])
    rank = (p / 100.0) * (n - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return float(sorted_vals[lo]) * (1.0 - frac) + float(sorted_vals[hi]) * frac


# Per-policy SLO burn window: the burn-rate gauge is the violation
# fraction of the last this-many requests over the error budget — long
# enough to smooth single-flush noise, short enough that a regression
# moves the gauge within seconds at serving rates.
SLO_BURN_WINDOW = 512
# Error budget fraction an SLO class tolerates: burn 1.0 = violating at
# exactly budget rate; burn >> 1 = eating future budget (the alerting
# convention from the SRE workbook's multiwindow burn alerts).
SLO_ERROR_BUDGET = 0.01


class ServingMetrics:
    """Lock-guarded serving counters + windowed latency/throughput view
    (the `/metrics` serving gauge)."""

    def __init__(self, latency_window: int = 2048):
        self._lock = threading.Lock()
        self._lat_ms: deque = deque(maxlen=latency_window)
        self._recent: deque = deque(maxlen=latency_window)  # (t_done, rows)
        self._occupancy: deque = deque(maxlen=256)
        self._requests = 0
        self._actions = 0
        self._flushes = 0
        self._rejected = 0
        self._shed = 0
        self._errors = 0
        self._per_policy: dict[str, int] = {}
        # SLO layer: per-policy cumulative latency histograms (mergeable
        # across ranks — telemetry/histo.py), declared SLO
        # class, cumulative violation counters, and the burn window of
        # recent over-SLO flags the burn-rate gauge derives from.
        self._hist: dict[str, histo.Histogram] = {}
        self._slo_ms: dict[str, float] = {}
        self._slo_viol: dict[str, int] = {}
        self._slo_window: dict[str, deque] = {}

    def record_flush(
        self,
        policy_id: str,
        rows: int,
        requests: int,
        latencies_ms: list,
        occupancy: float,
        slo_ms: Optional[float] = None,
    ) -> None:
        now = time.monotonic()
        with self._lock:
            self._requests += requests
            self._actions += rows
            self._flushes += 1
            self._per_policy[policy_id] = (
                self._per_policy.get(policy_id, 0) + requests
            )
            self._lat_ms.extend(latencies_ms)
            self._recent.append((now, rows))
            self._occupancy.append(occupancy)
            hist = self._hist.get(policy_id)
            if hist is None:
                hist = self._hist[policy_id] = histo.Histogram()
            if slo_ms is not None:
                self._slo_ms[policy_id] = float(slo_ms)
                window = self._slo_window.get(policy_id)
                if window is None:
                    window = self._slo_window[policy_id] = deque(
                        maxlen=SLO_BURN_WINDOW
                    )
                over = [lat > slo_ms for lat in latencies_ms]
                window.extend(over)
                self._slo_viol[policy_id] = (
                    self._slo_viol.get(policy_id, 0) + sum(over)
                )
        # Histogram has its own lock; observing outside _lock keeps the
        # two critical sections short and never nested.
        hist.observe_many(latencies_ms)

    def record_reject(self) -> None:
        with self._lock:
            self._rejected += 1

    def record_shed(self) -> None:
        """One load-shedding 503 that was NOT a queue-capacity reject
        (request timeout, dispatcher down) — the admission-control leg's
        other shed path, counted separately so a saturated queue and a
        wedged dispatcher don't read as the same failure."""
        with self._lock:
            self._shed += 1

    def record_errors(self, n: int) -> None:
        with self._lock:
            self._errors += n

    def burn_rate(self, policy_id: str) -> Optional[float]:
        """Current SLO burn rate of one policy (violation fraction of
        the burn window over the error budget), or None when the policy
        has no SLO class / no window yet — the admission controller's
        shed signal, read per-submit so it must stay a cheap lock +
        window sum."""
        with self._lock:
            window = self._slo_window.get(policy_id)
            if not window:
                return None
            return (sum(window) / len(window)) / SLO_ERROR_BUDGET

    def snapshot(self) -> dict:
        """Flat numeric dict for the sampler gauge registry (the
        exporter flattens one level; per-policy request counters ride as
        `requests_<policy>` keys, SLO rows as `slo_*_<policy>`)."""
        with self._lock:
            lat = sorted(self._lat_ms)
            recent = list(self._recent)
            occ = list(self._occupancy)
            out = {
                "requests_total": self._requests,
                "actions_total": self._actions,
                "flushes_total": self._flushes,
                "rejected_total": self._rejected,
                "shed_total": self._shed,
                "errors_total": self._errors,
            }
            per_policy = dict(self._per_policy)
            slo_ms = dict(self._slo_ms)
            slo_viol = dict(self._slo_viol)
            slo_frac = {
                pid: (sum(w) / len(w) if w else 0.0)
                for pid, w in self._slo_window.items()
            }
        out["latency_p50_ms"] = round(_percentile(lat, 50), 3)
        out["latency_p99_ms"] = round(_percentile(lat, 99), 3)
        # The percentile window size rides along: a p99 over 7 samples
        # is a cold-start anecdote, not an SLO row, and the consumer
        # can only tell when n is visible.
        out["latency_window_n"] = len(lat)
        if occ:
            out["batch_occupancy"] = round(sum(occ) / len(occ), 4)
        if len(recent) >= 2:
            dt = recent[-1][0] - recent[0][0]
            if dt > 0:
                # Rows completed strictly after the window's first flush
                # (that flush timestamps the window start; counting its
                # rows would overstate the rate).
                out["actions_per_s"] = round(
                    sum(r for _, r in recent[1:]) / dt, 2
                )
        for pid, n in sorted(per_policy.items()):
            out[f"requests_{pid}"] = n
        if slo_viol:
            out["slo_violations_total"] = sum(slo_viol.values())
        burns = {}
        for pid, target in sorted(slo_ms.items()):
            burn = round(slo_frac.get(pid, 0.0) / SLO_ERROR_BUDGET, 3)
            burns[pid] = burn
            out[f"slo_ms_{pid}"] = target
            out[f"slo_violations_{pid}"] = slo_viol.get(pid, 0)
            out[f"slo_burn_{pid}"] = burn
        if burns:
            # Headline burn = the worst policy's: the fleet alert fires
            # on any class eating budget, not on a traffic-weighted mean
            # that lets a small policy burn invisibly.
            out["slo_burn"] = max(burns.values())
        return out

    def histogram_snapshots(self) -> dict[str, dict]:
        """{policy_id: cumulative-histogram snapshot} for the exporter
        (each snapshot carries its policy label and the metric base name
        so the renderer emits one `serving_latency_ms` family with
        per-policy label sets)."""
        with self._lock:
            hists = list(self._hist.items())
        out = {}
        for pid, hist in hists:
            snap = hist.snapshot(labels={"policy": pid})
            snap["metric"] = "latency_ms"
            out[pid] = snap
        return out


class _PendingRequest:
    """One enqueued act request; completed by the dispatcher."""

    __slots__ = ("policy_id", "obs", "rows", "result", "error", "done",
                 "t_enq", "trace_id", "t_enq_pc")

    def __init__(
        self, policy_id: str, obs: np.ndarray,
        trace_id: Optional[str] = None,
    ):
        self.policy_id = policy_id
        self.obs = obs
        self.rows = int(obs.shape[0])
        self.result = None  # (actions ndarray, policy version)
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.t_enq = time.monotonic()
        # The gateway's request id (echoed in its response), and the
        # perf_counter enqueue stamp its queue-wait span starts from (t_enq
        # is monotonic, the latency metric's clock; spans live on the
        # tracer's perf_counter axis).
        self.trace_id = trace_id
        self.t_enq_pc = time.perf_counter()


class MicroBatcher:
    """Bounded request queue + single dispatcher thread (module
    docstring). `start=False` leaves the dispatcher unstarted, so a test
    can drive `_flush_once(block=False)` itself."""

    def __init__(
        self,
        store: PolicyStore,
        max_wait_us: float = 2000.0,
        max_batch_rows: Optional[int] = None,
        queue_limit: int = 256,
        metrics: Optional[ServingMetrics] = None,
        start: bool = True,
        max_inflight: int = 1,
        shed_burn_threshold: Optional[float] = None,
        shed_queue_frac: float = 0.5,
    ):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}"
            )
        if not (0.0 < shed_queue_frac <= 1.0):
            raise ValueError(
                f"shed_queue_frac must be in (0, 1], got {shed_queue_frac}"
            )
        self._store = store
        self.max_wait_s = float(max_wait_us) / 1e6
        self._max_batch_rows = max_batch_rows
        self.queue_limit = int(queue_limit)
        self.metrics = metrics or ServingMetrics()
        # Overlapped dispatch: >1 turns on the flight-worker pool; 1 keeps
        # the classic single-thread pack+dispatch loop (and the
        # sequential baseline) unchanged.
        self.max_inflight = int(max_inflight)
        # Admission control: None disables the shed path entirely.
        self.shed_burn_threshold = (
            None if shed_burn_threshold is None else float(shed_burn_threshold)
        )
        self._shed_depth = max(1, int(self.queue_limit * shed_queue_frac))
        self._cv = threading.Condition()
        # Guarded by _cv: the request queue and the closed flag.
        self._pending: deque = deque()
        self._closed = False
        # Written by the dispatcher (classic mode) or the flight workers
        # (overlap mode): a plain float rebind, and health() tolerates
        # one flush of staleness.
        self._last_flush_t = time.monotonic()
        # Overlap-mode plumbing (built in start() when max_inflight>1):
        # a 1-deep handoff queue and the flight worker pool.
        self._handoff: Optional[_queue.Queue] = None
        self._flights: list[threading.Thread] = []
        self._flight_error: Optional[BaseException] = None
        self._flush_counter = itertools.count(1)
        self._flush_seq = 0  # latest drawn seq, for introspection only
        # Span-emission target: the owning gateway points this at its
        # _trace_session, so the dispatcher's hops land in the same session
        # as the gateway thread's even when that session is attached rather
        # than installed as the current one. None: the current session.
        self.session_resolver = None
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> "MicroBatcher":
        if self.max_inflight > 1:
            # 1-deep handoff: the dispatcher can pack ONE flush ahead
            # of the busy flights — exactly "dispatch N+1 packs while N
            # is on the card", never an unbounded staging buffer that
            # would swallow the whole request queue into flights.
            self._handoff = _queue.Queue(maxsize=1)
            self._flights = [
                threading.Thread(
                    target=self._flight_run, name=f"serve-flight-{i}",
                    daemon=True,
                )
                for i in range(self.max_inflight)
            ]
            for t in self._flights:
                t.start()
        self._thread = threading.Thread(
            target=self._run, name="serve-dispatcher", daemon=True
        )
        self._thread.start()
        return self

    # -- client side --------------------------------------------------------

    def submit(
        self, obs, policy_id: Optional[str] = None, copy: bool = True,
        trace_id: Optional[str] = None,
    ) -> _PendingRequest:
        """Enqueue one act request of [n, *obs_shape] rows. Raises
        UnknownPolicy (404), ValueError (400: too many rows for the
        policy's largest bucket), QueueFull / DispatcherDown (503).
        `copy=False` hands the caller's array over as it is (the gateway
        always copies, so the batcher owns the payload). `trace_id` is the
        gateway's request id."""
        handle = self._store.get(policy_id)
        obs = np.asarray(obs)
        if copy:
            obs = np.array(obs)
        limit = self._row_limit(handle)
        if obs.shape[0] > limit:
            raise ValueError(
                f"request of {obs.shape[0]} rows exceeds the largest "
                f"serving bucket ({limit}) — split it client-side"
            )
        req = _PendingRequest(handle.policy_id, obs, trace_id=trace_id)
        with self._cv:
            if self._closed or (
                self._thread is not None and not self._thread.is_alive()
            ):
                raise DispatcherDown("serving dispatcher is not running")
            if len(self._pending) >= self.queue_limit:
                self.metrics.record_reject()
                raise QueueFull(
                    f"request queue at capacity ({self.queue_limit})"
                )
            # Shed-vs-queue (module docstring): under saturation, an
            # SLO-classed policy already eating its error budget fails
            # fast instead of queueing another violation-to-be. The
            # _cv -> metrics-lock nesting matches record_reject above.
            if (
                self.shed_burn_threshold is not None
                and getattr(handle, "slo_ms", None) is not None
                and len(self._pending) >= self._shed_depth
            ):
                burn = self.metrics.burn_rate(handle.policy_id)
                if burn is not None and burn >= self.shed_burn_threshold:
                    self.metrics.record_shed()
                    raise Overloaded(
                        f"shedding {handle.policy_id!r}: queue depth "
                        f"{len(self._pending)}/{self.queue_limit} and SLO "
                        f"burn {burn:.2f} >= {self.shed_burn_threshold}"
                    )
            self._pending.append(req)
            self._cv.notify_all()
        return req

    def wait(self, req: _PendingRequest, timeout: Optional[float] = None):
        """Block for a submitted request; returns (actions, version)."""
        if not req.done.wait(timeout):
            raise TimeoutError(
                f"request not served within {timeout}s (queue depth "
                f"{self.queue_depth()})"
            )
        if req.error is not None:
            raise req.error
        return req.result

    # -- dispatcher side ----------------------------------------------------

    def _row_limit(self, handle) -> int:
        # Clamp to the engine's largest bucket: a max_batch_rows above
        # it would let the dispatcher pack a flush no bucket can hold,
        # failing every (individually valid) request in it.
        limit = int(getattr(handle.engine, "max_rows", 64))
        if self._max_batch_rows is not None:
            limit = min(limit, int(self._max_batch_rows))
        return limit

    def _run(self) -> None:
        if self._handoff is None:
            while self._flush_once(block=True):
                pass
            return
        # Overlap mode: THIS thread only packs — the single packer
        # keeps the grouping/ordering invariants of the classic loop —
        # and the flight pool dispatches. put() blocks once the pool is
        # saturated and one flush is staged, which is the backpressure
        # that stops the packer from inhaling the whole request queue.
        while True:
            packed = self._collect_once(block=True)
            if packed is not None:
                self._handoff.put(packed)
            with self._cv:
                if self._closed and not self._pending:
                    break
        for _ in self._flights:
            self._handoff.put(None)  # flight shutdown sentinels

    def _flight_run(self) -> None:
        try:
            while True:
                packed = self._handoff.get()
                if packed is None:
                    return
                self._dispatch_batch(*packed)
        except BaseException as e:  # surfaced through health()
            self._flight_error = e

    def _flush_once(self, block: bool = True) -> bool:
        """Collect one micro-batch and dispatch it inline (the classic
        single-thread loop; tests drive this entry directly).
        Returns False once the batcher is closed AND drained (the
        dispatcher loop's exit), True otherwise — including empty
        non-blocking polls."""
        packed = self._collect_once(block=block)
        if packed is None:
            with self._cv:
                return not self._closed
        self._dispatch_batch(*packed)
        return True

    def _collect_once(self, block: bool = True):
        """Pack one micro-batch: `(batch, rows, limit, policy_id)`, or
        None when there is nothing to pack. Called only from the
        dispatcher thread (or a test via _flush_once) —
        the single packer is what lets `first` below survive the lock
        gap."""
        with self._cv:
            if block:
                while not self._pending and not self._closed:
                    self._cv.wait(0.05)
            if not self._pending:
                return None
            first = self._pending[0]
            policy_id = first.policy_id
        # Resolve the route OUTSIDE the queue lock: store.get takes the
        # store's lock, and nesting it under _cv would couple the
        # enqueue path to swap()'s critical section. Only the packer
        # pops, so `first` cannot vanish in between.
        route = self._store.get(policy_id)
        limit = self._row_limit(route)
        # Per-policy window (SLO classes): the handle's
        # max_wait_us overrides the batcher's global one.
        wait_us = getattr(route, "max_wait_us", None)
        wait_s = self.max_wait_s if wait_us is None else float(wait_us) / 1e6
        with self._cv:
            if block:
                # GA3C window: hold the flush up to max_wait past the
                # FIRST request's enqueue while more same-policy rows
                # accumulate toward the row budget.
                deadline = first.t_enq + wait_s
                while not self._closed:
                    rows = sum(
                        r.rows for r in self._pending
                        if r.policy_id == policy_id
                    )
                    if rows >= limit:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
            batch: list[_PendingRequest] = []
            rest: deque = deque()
            rows = 0
            while self._pending:
                r = self._pending.popleft()
                if r.policy_id == policy_id and (
                    not batch or rows + r.rows <= limit
                ):
                    batch.append(r)
                    rows += r.rows
                else:
                    rest.append(r)
            self._pending.extend(rest)
        return batch, rows, limit, policy_id

    def _dispatch_batch(
        self, batch: list, rows: int, limit: int, policy_id: str
    ) -> None:
        """Dispatch one packed micro-batch and complete its requests.
        Classic mode runs this on the dispatcher thread; overlap mode
        on a flight worker — everything here is either request-local,
        lock-guarded (metrics), or GIL-atomic (the last-flush stamp), and
        engine.act is safe to run concurrently across flights (each
        checks out a lane of its own)."""
        t_disp_pc = time.perf_counter()
        try:
            # Re-resolve the handle at flush time: a hot-swap that
            # landed while this flush waited serves the NEW version;
            # the handle is immutable, so params/version stay
            # consistent through the dispatch either way. Resolution
            # and concatenation stay INSIDE the try — once requests are
            # popped, any failure must complete them with the error,
            # never kill the dispatcher with callers left hanging.
            handle = self._store.get(policy_id)
            obs = (
                batch[0].obs
                if len(batch) == 1
                else np.concatenate([r.obs for r in batch], axis=0)
            )
            actions = handle.engine.act(handle.params, obs)
        except Exception as e:  # noqa: BLE001 — failures go to callers
            for r in batch:
                r.error = e
                r.done.set()
            self.metrics.record_errors(len(batch))
        else:
            now = time.monotonic()
            offset = 0
            latencies = []
            for r in batch:
                r.result = (actions[offset:offset + r.rows], handle.version)
                offset += r.rows
                latencies.append((now - r.t_enq) * 1e3)
                r.done.set()
            occupancy = rows / max(limit, 1)
            self.metrics.record_flush(
                handle.policy_id, rows, len(batch), latencies,
                occupancy=occupancy,
                slo_ms=getattr(handle, "slo_ms", None),
            )
            seq = next(self._flush_counter)
            self._flush_seq = seq
            self._emit_flush_trace(batch, handle, rows, occupancy, t_disp_pc,
                                   time.perf_counter(), seq)
        self._last_flush_t = time.monotonic()

    def _emit_flush_trace(self, batch, handle, rows: int, occupancy: float,
                          t_disp_pc: float, t_done_pc: float, seq: int) -> None:
        """The dispatcher-side hops of one flush: a `serve_dispatch` span over
        the engine's act, one `serve_queue_wait` span per traced request
        (enqueue stamp to the flush's start), and a flow STEP per trace id
        binding both to the request's gateway-thread track. No-op without a
        session."""
        resolver = self.session_resolver
        session = resolver() if resolver is not None else _telemetry_current()
        if session is None:
            return
        tracer = session.tracer
        tracer.complete("serve_dispatch", t_disp_pc, t_done_pc - t_disp_pc, {
            "policy": handle.policy_id, "version": handle.version, "rows": rows,
            "requests": len(batch), "occupancy": round(occupancy, 4), "flush": seq,
        })
        for r in batch:
            if r.trace_id is None:
                continue
            tracer.complete("serve_queue_wait", r.t_enq_pc, max(t_disp_pc - r.t_enq_pc, 0.0),
                            {"trace": r.trace_id, "flush": seq, "policy": r.policy_id})
            # Stamped INSIDE the dispatch span, so the arrow lands on the
            # flush that served this request.
            tracer.flow(flow_id_of(r.trace_id), "t", ts_us=tracer.pc_to_us(t_disp_pc))

    # -- introspection / lifecycle ------------------------------------------

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def health(self) -> dict:
        """Dispatcher liveness for /healthz: alive flag, queue depth,
        seconds since the last completed flush. In overlap mode a dead
        flight worker also reads as not-alive — a silently shrinking
        pool would otherwise serve at degraded depth forever."""
        alive = self._thread is not None and self._thread.is_alive()
        if self._flight_error is not None:
            alive = False
        with self._cv:
            depth = len(self._pending)
            closed = self._closed
        return {
            "alive": bool(alive and not closed),
            "queue_depth": depth,
            "last_flush_age_s": round(
                time.monotonic() - self._last_flush_t, 3
            ),
            "max_inflight": self.max_inflight,
        }

    def gauge(self) -> dict:
        """The sampler-registry serving gauge: metrics + live queue +
        per-policy latency-histogram snapshots (dict-valued entries the
        exporter recognizes by their `histogram` marker and renders as
        Prometheus `_bucket/_sum/_count`; plain numeric consumers skip
        them as before)."""
        out = self.metrics.snapshot()
        out["queue_depth"] = self.queue_depth()
        for pid, snap in self.metrics.histogram_snapshots().items():
            out[f"latency_ms_hist_{pid}"] = snap
        return out

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting requests, drain in-flight flushes, fail any
        stragglers (idempotent)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        # Flights exit on the sentinels the dispatcher sends after its
        # own drain — join AFTER the dispatcher so a drain in progress
        # finishes instead of stranding packed flushes.
        for t in self._flights:
            t.join(timeout)
        with self._cv:
            stranded = list(self._pending)
            self._pending.clear()
        for r in stranded:
            r.error = DispatcherDown("batcher closed before dispatch")
            r.done.set()
