"""`TelemetrySession` and the module-level current-session API (the
port's counterpart of `actor_critic_tpu/telemetry/session.py`).

The training loops are instrumented UNCONDITIONALLY with the functions
here (`span`, `instant`, `observe`); each call is near-free when no
session is installed — a span is two `time.perf_counter()` reads plus a
list push/pop, kept even without a session so the stall watchdog can
always name the phase that hung. No span touches the device: spans sit
at dispatch boundaries, and a graph replay returns once it is queued.
Installing a session (`python -m actor_critic_tpu_torch.train
--telemetry-dir`) turns the same calls into JSONL emission:

    <telemetry-dir>/spans.jsonl      Chrome-trace phase events
    <telemetry-dir>/resources.jsonl  RSS / device memory / recompiles
    <telemetry-dir>/events.jsonl     health + lifecycle events

Open-span stacks are PER-THREAD (the async actor-learner services run
collection spans on actor threads); the sampler and watchdog
threads read a snapshot across all of them, so a diagnosis line names
the most recently entered phase anywhere in the process.
"""

from __future__ import annotations

import os
import threading
import time
from typing import IO, Optional

from actor_critic_tpu_torch.telemetry.health import (
    DivergenceMonitor,
    ThroughputMonitor,
)
from actor_critic_tpu_torch.telemetry.sampler import ResourceSampler
from actor_critic_tpu_torch.telemetry.spans import SpanTracer
from actor_critic_tpu_torch.utils.numguard import safe_json_row

_SESSION: Optional["TelemetrySession"] = None

# Event kinds that are a run's last words: after writing one, all three
# sinks are flushed AND fsynced so a SIGKILL'd run (or a machine losing
# power mid-stall) keeps its final stall/divergence evidence on disk —
# line buffering alone only guarantees the row reached the page cache.
DURABLE_EVENT_KINDS = frozenset(
    {"stall", "divergence", "throughput_regression"}
)

# Open-span stacks, one per thread: (name, entry perf_counter). A
# single global list would do while only the training thread opened
# spans, but the async actor-learner services (algos/traj_queue.py)
# run collection spans on actor THREADS — interleaved
# push/pops on one list leave permanently stranded entries. Each thread
# pushes/pops its own stack; the watchdog/exporter threads read a
# snapshot across all of them. The registry lock guards only
# stack creation/removal (the per-span hot path is an append/pop on a
# list no other thread mutates).
_OPEN_STACKS: dict[int, list[tuple[str, float]]] = {}
_OPEN_LOCK = threading.Lock()


def _thread_stack() -> list[tuple[str, float]]:
    ident = threading.get_ident()
    stack = _OPEN_STACKS.get(ident)
    if stack is None:
        with _OPEN_LOCK:
            stack = _OPEN_STACKS.setdefault(ident, [])
    return stack


class _Span:
    """Context manager for one phase span. Always tracks the open-span
    stack; emits a Chrome-trace complete event only while a session is
    installed at EXIT time (so a session installed mid-span still
    records it)."""

    __slots__ = ("_name", "_args", "_t0")

    def __init__(self, name: str, args: Optional[dict]):
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        _thread_stack().append((self._name, self._t0))
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter() - self._t0
        stack = _thread_stack()
        if stack and stack[-1][0] == self._name:
            stack.pop()
        if not stack:
            # Drop the empty stack so short-lived actor threads don't
            # accumulate registry entries across a run.
            with _OPEN_LOCK:
                if not _OPEN_STACKS.get(threading.get_ident()):
                    _OPEN_STACKS.pop(threading.get_ident(), None)
        s = _SESSION
        if s is not None:
            s.tracer.complete(self._name, self._t0, dur, self._args)


def span(name: str, **args) -> _Span:
    """`with telemetry.span("update", it=12):` around a loop phase."""
    return _Span(name, args or None)


def instant(name: str, **args) -> None:
    """Mark a phase with no separable host duration (fused rollouts)."""
    s = _SESSION
    if s is not None:
        s.tracer.instant(name, args or None)


def complete_span(name: str, start_pc: float, dur_s: float, **args) -> None:
    """Emit a Chrome-trace complete event for a span measured EXTERNALLY
    (e.g. a sharded-pool worker's busy time within a collection block,
    aggregated host-side). `start_pc` is a `perf_counter()` reading.
    Unlike `span()`, it does not touch the open-span stack — the
    measured work happened in another process."""
    s = _SESSION
    if s is not None:
        s.tracer.complete(name, start_pc, dur_s, args or None)


def event(kind: str, **fields) -> None:
    """Append a structured event row to events.jsonl (no-op untracked)."""
    s = _SESSION
    if s is not None:
        s.event(kind, **fields)


def observe(it: int, metrics: dict) -> None:
    """Feed one logged iteration to the health monitors (no-op when no
    session is installed)."""
    s = _SESSION
    if s is not None:
        s.observe(it, metrics)


def current() -> Optional["TelemetrySession"]:
    return _SESSION


def set_current(session: Optional["TelemetrySession"]) -> None:
    global _SESSION
    _SESSION = session


def open_spans() -> list[str]:
    """Names of THIS thread's currently open spans, outermost first."""
    return [
        name
        for name, _ in list(_OPEN_STACKS.get(threading.get_ident(), []))
    ]


def last_open_span() -> Optional[tuple[str, float]]:
    """(name, seconds open) of the innermost open span across EVERY
    thread — the most recently entered phase is the one executing when
    a watchdog/exporter thread asks what the process is doing."""
    with _OPEN_LOCK:
        stacks = [list(s) for s in _OPEN_STACKS.values()]
    candidates = [s[-1] for s in stacks if s]
    if not candidates:
        return None
    name, t0 = max(candidates, key=lambda x: x[1])
    return name, time.perf_counter() - t0


def stall_report(stalled_s: float = 0.0) -> str:
    """One diagnosis clause for the watchdog's exit-42 message: names the
    phase that was open when progress stopped. Also records a `stall`
    event while a session is installed (the files are line-buffered, so
    the row survives the `os._exit` that follows)."""
    last = last_open_span()
    s = _SESSION
    if s is not None:
        fields = {"stalled_s": round(stalled_s, 1)}
        if last is not None:
            fields.update(phase=last[0], phase_open_s=round(last[1], 1))
        try:
            s.event("stall", **fields)
        except Exception:
            pass
    if last is None:
        return ""
    return (
        f"; last open telemetry span: {last[0]!r} "
        f"(open {last[1]:.1f}s)"
    )


class TelemetrySession:
    """Owns the three telemetry sinks for one run.

    `directory` is created; the files are opened line-buffered append so
    every completed write survives even an `os._exit` teardown. Install
    with `set_current` (or use as a context manager) to route the
    module-level `span`/`instant`/`event`/`observe` calls here.
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        run_info: Optional[dict] = None,
        resource_interval_s: float = 5.0,
        sample_resources: bool = True,
        throughput_drop_threshold: float = 0.5,
        serve_port: Optional[int] = None,
        serve_host: str = "127.0.0.1",
        profile: bool = True,
        flight: bool = True,
    ):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # Tombstone flag the exporter keys off: once close() runs, a
        # still-scraping /metrics must see `up 0`, not the process-global
        # gauges of a session that no longer exists.
        self.closed = False
        self._spans_fh = self._open("spans.jsonl")
        self._resources_fh = self._open("resources.jsonl")
        self._events_fh = self._open("events.jsonl")
        # events.jsonl has MULTIPLE writers (health monitors on the
        # training thread, stall_report on the watchdog thread);
        # unlocked writes could interleave into torn lines and lose the
        # stall evidence the sink exists to preserve.
        self._events_lock = threading.Lock()
        self.tracer = SpanTracer(self._spans_fh)
        # Crash flight recorder (telemetry/flight.py): an mmap'd ring of
        # the last N spans/events/gauge ticks that survives SIGKILL for
        # post-mortem harvest, dumped to JSON on stall/divergence. The
        # mirrors feed it; line-buffered sinks stay the durable record.
        # Only the session-owning thread writes this (set in __init__,
        # cleared in close()); sampler and event() callers on other
        # threads READ it, and FlightRecorder's record/dump/close are
        # individually no-ops after close, so a stale read during shutdown
        # degrades to a dropped mirror record.
        # torchlint: thread-owned=owner (only the session-owning thread writes
        # this, set here and cleared in close(); other threads read it, and a
        # stale read during shutdown drops one mirror record)
        self.flight = None
        if flight:
            from actor_critic_tpu_torch.telemetry.flight import (
                RING_FILENAME,
                FlightRecorder,
            )

            try:
                self.flight = FlightRecorder(
                    os.path.join(self.directory, RING_FILENAME),
                    meta={"pid": os.getpid(), **(run_info or {})},
                )
                self.tracer.mirror = self.flight.mirror
            except Exception:
                self.flight = None  # ring creation failing never blocks a run
        self._t0 = time.monotonic()
        # Live-introspection state the exporter reads: the most recent
        # observe() row and the rates derived from consecutive rows.
        self.last_observation: Optional[dict] = None
        # Single writer: observe() runs on the training thread only; the
        # exporter thread snapshots via rates()'s dict() copy, and a
        # one-row-stale read is fine for a metrics scrape.
        # torchlint: thread-owned=train (single writer: observe() runs on the
        # training thread only; the exporter copies it with one dict() call
        # under the GIL, and a row-stale read is fine for a scrape)
        self._rates: dict[str, float] = {}
        self._prev_observe: Optional[tuple[int, Optional[float], float]] = None
        self.event("session_start", **(run_info or {}))
        self._monitors = [
            ThroughputMonitor(
                self._emit_health, drop_threshold=throughput_drop_threshold
            ),
            DivergenceMonitor(self._emit_health),
        ]
        # The session's lifecycle (install and close()) is owned by the
        # run-owning thread; daemon threads only read these handles.
        # torchlint: thread-owned=train (the session's lifecycle, install and
        # close(), belongs to the run-owning thread; daemon threads only read
        # the handles)
        self.profiler = None
        if profile:
            from actor_critic_tpu_torch.telemetry.profiler import WindowedProfiler

            self.profiler = WindowedProfiler(self.directory)
        # torchlint: thread-owned=train (the same lifecycle contract as profiler)
        self.sampler: Optional[ResourceSampler] = None
        if sample_resources:
            self.sampler = ResourceSampler(
                self._resources_fh,
                interval_s=resource_interval_s,
                mirror=(
                    None if self.flight is None
                    else self.flight.record_gauges
                ),
            ).start()
        # torchlint: thread-owned=train (the same lifecycle contract as profiler)
        self.exporter = None
        if serve_port is not None:
            from actor_critic_tpu_torch.telemetry.exporter import TelemetryExporter

            self.exporter = TelemetryExporter(
                self, port=serve_port, host=serve_host
            )
            self.event("exporter_start", port=self.exporter.port)

    @property
    def exporter_port(self):
        """The exporter's ACTUAL bound port (with serve_port=0 the
        OS-assigned ephemeral one: scripts read it here instead of racing
        for a fixed port), or None when no exporter is serving."""
        return None if self.exporter is None else self.exporter.port

    def _open(self, name: str) -> IO[str]:
        return open(os.path.join(self.directory, name), "a", buffering=1)

    def _emit_health(self, kind: str, **fields) -> None:
        self.event(kind, **fields)

    def event(self, kind: str, **fields) -> None:
        row = {"ts": round(time.time(), 3), "kind": kind, **fields}
        try:
            # safe_json_row: a non-finite event field (a NaN loss in a
            # divergence event's payload!) becomes null instead of the
            # WHOLE event vanishing — losing exactly the forensic row
            # the run needed.
            line = safe_json_row(row, default=str) + "\n"
        except (TypeError, ValueError):
            return  # unserializable field; never raise
        # Bounded acquire, not `with`: the watchdog thread calls this
        # from the stall path while the training thread may be wedged
        # INSIDE an events write (a hung filesystem, one of the stall
        # classes the watchdog escapes). Blocking here would stop the exit-42
        # escape; dropping the row after 1s cannot.
        if not self._events_lock.acquire(timeout=1.0):
            return
        try:
            self._events_fh.write(line)
        except (OSError, ValueError):
            pass  # disk full / closed mid-shutdown
        finally:
            self._events_lock.release()
        if self.flight is not None:
            self.flight.record(f"event_{kind}", **fields)
        if kind in DURABLE_EVENT_KINDS:
            # Last-words path: dump the flight ring BEFORE the fsync so
            # a stall that ends in os._exit leaves both the durable
            # sinks and a rendered flight_dump_*.json behind.
            if self.flight is not None:
                self.flight.dump(kind)
            self._durable_flush()

    def _durable_flush(self, timeout_s: float = 2.0) -> None:
        """Flush + fsync all three sinks so the row that was just written
        survives a SIGKILL. Runs in a bounded side thread: the stall path
        calls event() from the watchdog thread moments before os._exit,
        and an fsync hanging on the very filesystem stall being reported
        must not block the exit-42 escape."""

        def _sync():
            for fh in (self._spans_fh, self._resources_fh, self._events_fh):
                try:
                    fh.flush()
                    os.fsync(fh.fileno())
                except (OSError, ValueError):
                    pass  # closed, or a sink on a non-fsyncable fs

        t = threading.Thread(target=_sync, daemon=True)
        t.start()
        t.join(timeout=timeout_s)

    def observe(self, it: int, metrics: dict) -> None:
        now = time.monotonic() - self._t0
        for m in self._monitors:
            try:
                m.observe(it, metrics, now)
            except Exception:
                pass  # telemetry must never take the run down
        # Live-introspection snapshot for /metrics: the row itself plus
        # iters/s and env-steps/s from consecutive observe() calls.
        env_steps = metrics.get("env_steps")
        try:
            env_steps = None if env_steps is None else float(env_steps)
        except (TypeError, ValueError):
            env_steps = None
        prev = self._prev_observe
        if prev is not None:
            p_it, p_steps, p_t = prev
            dt = now - p_t
            if it > p_it and dt > 0:
                self._rates["iters_per_s"] = (it - p_it) / dt
                if env_steps is not None and p_steps is not None:
                    self._rates["env_steps_per_s"] = (
                        env_steps - p_steps
                    ) / dt
        self._prev_observe = (it, env_steps, now)
        # Reserved keys LAST: a training metric named "it"/"age_t" must
        # not overwrite the bookkeeping /healthz and /metrics read.
        self.last_observation = {**metrics, "it": it, "age_t": now}

    def rates(self) -> dict[str, float]:
        """{'iters_per_s', 'env_steps_per_s'} from the last two observe()
        calls (empty until two logged iterations have landed)."""
        return dict(self._rates)

    def uptime_s(self) -> float:
        return time.monotonic() - self._t0

    def last_observe_age_s(self) -> Optional[float]:
        if self.last_observation is None:
            return None
        return self.uptime_s() - self.last_observation["age_t"]

    def close(self) -> None:
        if self.exporter is not None:
            self.exporter.close()
            self.exporter = None
        if self.profiler is not None:
            self.profiler.close()
            self.profiler = None
        if self.sampler is not None:
            self.sampler.stop()
            self.sampler = None
        self.event("session_end")
        if self.flight is not None:
            self.tracer.mirror = None
            self.flight.close()
            self.flight = None
        # Tombstone BEFORE closing the sinks: a /metrics scrape racing
        # shutdown (the exporter above is gone, but a standalone serving
        # exporter may still hold this session) must flip to `up 0`
        # rather than re-serve the dead run's last rates and gauges.
        self.closed = True
        self.last_observation = None
        self._rates = {}
        self._prev_observe = None
        for fh in (self._spans_fh, self._resources_fh, self._events_fh):
            try:
                fh.close()
            except Exception:
                pass
        if _SESSION is self:
            set_current(None)

    def __enter__(self) -> "TelemetrySession":
        set_current(self)
        return self

    def __exit__(self, *exc) -> None:
        self.close()
