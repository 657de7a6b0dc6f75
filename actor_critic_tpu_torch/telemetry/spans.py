"""Chrome-trace span emission (`spans.jsonl`): a copy of
`actor_critic_tpu/telemetry/spans.py`.

One JSON object per line, each a valid Chrome Trace Event Format entry
(the `{"traceEvents": [...]}` wrapper is added by
`scripts/run_report.py --trace`, or with `jq -s '{traceEvents:.}'`).
Spans are emitted as complete ("ph":"X") events at EXIT time — children
close before parents, and the format is order-independent, so nesting
reconstructs from the ts/dur containment Perfetto renders natively.

Timestamps are microseconds on the `perf_counter` clock, zeroed at
tracer creation; a clock-sync metadata event records the corresponding
unix epoch so wall-clock can be recovered.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import IO, Optional

from actor_critic_tpu_torch.utils.numguard import safe_json_row

# Canonical phase-span vocabulary. Every `telemetry.span(...)` /
# `complete_span(...)` / `instant(...)` name in the codebase must come
# from this set (tests/test_torch_span_names.py statically enforces it): the
# per-phase breakdown in scripts/run_report.py groups rows by name, so a
# typo'd phase would not error anywhere — it would just silently grow a
# one-off row nobody aggregates. Add new phases HERE first.
CANONICAL_PHASES = frozenset({
    "iteration",        # one host-loop iteration (encloses the rest)
    "env_step",         # host env collection block (or fused instant)
    "env_step_worker",  # sharded-pool worker simulator time (relayed)
    "host_to_device",   # block transfer onto the device
    "queue_wait",       # async learner waiting on the trajectory queue
    "update",           # jitted learner update (async dispatch)
    "eval",             # greedy eval sweep
    "log",              # metrics materialization + sinks
    "checkpoint",       # checkpoint save boundary
    "profile",          # on-demand torch.profiler capture window
    # Serving-gateway request hops: one /v1/act request
    # renders as a flow-linked track across these.
    "serve_request",    # whole request on its gateway handler thread
    "serve_parse",      # HTTP body read + obs validation
    "serve_queue_wait", # enqueue -> dispatcher pops it into a flush
    "serve_dispatch",   # one micro-batch flush through engine.act
    "serve_respond",    # response serialization + socket write
})


def flow_id_of(trace_id: str) -> int:
    """Stable 32-bit Chrome-trace flow id for a request trace id (hex
    or arbitrary client-minted text — crc32 keeps it deterministic
    either way, so the same id links across processes)."""
    return zlib.crc32(str(trace_id).encode()) & 0x7FFFFFFF


class SpanTracer:
    """Serializes span/instant events to a line-buffered JSONL handle."""

    def __init__(self, fh: IO[str]):
        self._fh = fh
        self._lock = threading.Lock()
        # Optional tap fed every emitted event dict — the session points
        # this at the flight recorder's ring (telemetry/flight.py) so
        # the last N spans survive a SIGKILL. Called OUTSIDE _lock (it
        # has its own) and must never raise.
        self.mirror = None
        self._pid = os.getpid()
        self._t0 = time.perf_counter()
        # Epoch of ts=0, kept for converting FOREIGN timestamps (worker
        # processes report wall-clock epochs; time.time() is the one
        # clock all processes on the host share).
        self._epoch0 = time.time()
        self._named_pids: set[int] = set()
        self._write({
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": "train"},
        })
        self._write({
            "name": "clock_sync", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"unix_epoch_at_ts0": self._epoch0},
        })

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def pc_to_us(self, pc: float) -> float:
        """Convert a raw `perf_counter()` reading onto this tracer's ts
        axis (callers that stamped an event before emission time)."""
        return (pc - self._t0) * 1e6

    def _write(self, evt: dict) -> None:
        try:
            # safe_json_row: a non-finite span arg (e.g. a NaN metric
            # riding an `update` span) serializes as null instead of
            # ValueError-dropping the whole event.
            line = safe_json_row(evt)
            with self._lock:
                self._fh.write(line + "\n")
        except (OSError, ValueError):
            # ENOSPC / closed handle: telemetry must never take the run
            # down — a span emission failing on the training thread
            # would otherwise crash a multi-day run over a full disk.
            pass
        mirror = self.mirror
        if mirror is not None:
            try:
                mirror(evt)
            except Exception:
                pass

    def complete(
        self, name: str, start_pc: float, dur_s: float,
        args: Optional[dict] = None,
    ) -> None:
        """Emit a ph:"X" complete event; `start_pc` is the span's entry
        `perf_counter()` reading, `dur_s` its duration in seconds."""
        evt = {
            "name": name,
            "ph": "X",
            "ts": round((start_pc - self._t0) * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
            "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "cat": "phase",
        }
        if args:
            evt["args"] = args
        self._write(evt)

    def name_process(self, pid: int, name: str) -> None:
        """Emit a process_name metadata event for a FOREIGN pid (e.g. an
        env-shard worker) so Perfetto labels its lane; idempotent per
        pid so the relay can call it on every drain."""
        # Test-and-set under the lock: the relay drains from the
        # training thread today, but nothing stops a second drain site
        # (async actors relaying their own pools), and two threads
        # passing the membership test together would emit duplicate
        # metadata rows. _write reacquires the same lock AFTER this
        # block releases it — never nested.
        with self._lock:
            if pid in self._named_pids:
                return
            self._named_pids.add(pid)
        self._write({
            "name": "process_name", "ph": "M", "pid": int(pid), "tid": 0,
            "args": {"name": name},
        })

    def _foreign_evt(
        self, name: str, epoch_start: float, dur_s: float,
        pid: int, tid: int, args: Optional[dict],
    ) -> dict:
        evt = {
            "name": name,
            "ph": "X",
            "ts": round((epoch_start - self._epoch0) * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
            "pid": int(pid),
            "tid": int(tid),
            "cat": "phase",
        }
        if args:
            evt["args"] = args
        return evt

    def complete_foreign(
        self, name: str, epoch_start: float, dur_s: float,
        pid: int, tid: int = 0, args: Optional[dict] = None,
    ) -> None:
        """Emit a ph:"X" event measured in ANOTHER process. `epoch_start`
        is a `time.time()` reading from that process — converted onto
        this tracer's ts axis via the epoch anchor recorded at creation,
        so worker lanes line up with the parent's spans. The record
        keeps the worker's real pid (its own Perfetto lane)."""
        self._write(self._foreign_evt(name, epoch_start, dur_s, pid, tid, args))

    def complete_foreign_many(
        self, items: list[tuple[str, float, float, int, int, Optional[dict]]]
    ) -> None:
        """Batched `complete_foreign`: one lock acquisition and ONE write
        for the whole list of (name, epoch_start, dur_s, pid, tid, args)
        tuples. The shard-pool relay drains hundreds of per-step records
        per collection block on the training thread — a write syscall
        per record would be real hot-loop overhead."""
        try:
            lines = [
                safe_json_row(self._foreign_evt(*item))
                for item in items
            ]
            if not lines:
                return
            with self._lock:
                self._fh.write("\n".join(lines) + "\n")
        except (OSError, ValueError):
            pass  # same never-take-the-run-down contract as _write

    def flow(
        self,
        flow_id: int,
        phase: str = "s",
        ts_us: Optional[float] = None,
        name: str = "serve_flow",
    ) -> None:
        """Emit one Chrome-trace flow event (`ph` "s" start / "t" step /
        "f" end). Flow events with the same `id` draw as connecting
        arrows between the slices that CONTAIN their timestamps — which
        is how one request's gateway-thread span, its queue wait, and
        the dispatcher's flush render as a single connected track.
        Pass `ts_us` (via `pc_to_us`) to bind to a slice
        stamped earlier than the emission call."""
        evt = {
            "name": name,
            "cat": "flow",
            "ph": phase,
            "id": int(flow_id) & 0xFFFFFFFF,
            "ts": round(self.now_us() if ts_us is None else ts_us, 1),
            "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if phase == "f":
            evt["bp"] = "e"  # bind to the enclosing slice, not the next
        self._write(evt)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """Emit a ph:"i" instant event (thread scope) — used to mark
        phases that exist but have no separable host duration (e.g. the
        env rollout fused into the captured train step)."""
        evt = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": round(self.now_us(), 1),
            "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "cat": "phase",
        }
        if args:
            evt["args"] = args
        self._write(evt)
