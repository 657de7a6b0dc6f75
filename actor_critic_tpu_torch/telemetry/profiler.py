"""On-demand device profiling and compile attribution (the port's
counterpart of `actor_critic_tpu/telemetry/profiler.py`).

Two introspection tools that run INSIDE a live training process:

- `WindowedProfiler`: an armable, windowed `torch.profiler` capture (CPU
  and CUDA activities; the start/stop pair is
  `utils/profiling.start_trace`/`stop_trace`). Arm it with `arm(iters)`
  (the exporter's `/profile?iters=N`, SIGUSR2 through `install_sigusr2`,
  or a direct call) and the next `tick()` (the loops call one per
  iteration or dispatch) starts a capture that stops `iters` ticks
  later, leaving a Chrome trace under `<telemetry-dir>/profile_<n>/` and
  `profile_start`/`profile_done` events naming it; a window that cannot
  start or stop writes `profile_failed` and the run goes on exactly as it
  was (never switched to eager). An idle `tick()` is one lock-free
  attribute read.

- the compile record (`record_compile`), the counterpart of JAX's
  compile-funnel listener. The port compiles in two places: a CUDA-graph
  capture (`algos/loop.CapturedStep`, the blocked evals, the serving
  engine's bucket graphs) and a kernel build (`_build.build`'s nvcc,
  `native.build`'s g++). Each site wraps its work in `record_compile`,
  which times it and writes one `compile` event with `name` (the
  trainer's step, the eval block, the bucket, the source file),
  `compile_s` and `signature` (the shapes and dtypes of the tensors the
  capture carries, or the build's arch and flags); a build that found
  its library already built gets `cache_hit: true` and is not counted as
  a recompile. `scripts/run_report.py`'s attribution table renders the
  events unchanged. The hook is in the port's own code, so it is always
  live (`introspection_active()` is always true), with or without a
  session.

A capture closes any open profiler window first (its `profile_done`
event says `cut_by: "capture"`): a CUPTI trace running across a CUDA
graph's capture is not something a run may depend on, and the window's
counts would mix capture-time launches with replays.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from typing import Optional

DEFAULT_PROFILE_ITERS = 5

# Process-global compile log: records accumulate per process (a bounded
# ring), and a current session additionally gets each as a `compile` event.
_COMPILE_RING_MAX = 256
_compile_records: list[dict] = []
_compile_total = 0  # every record, cache hits included (monotonic)
_recompile_total = 0  # captures and compiler runs only: `recompiles`
_build_counts = {"hits": 0, "misses": 0}  # the builds alone: the build cache's
_compile_lock = threading.Lock()


def introspection_active() -> bool:
    """Whether compile events are recorded: always, in the port (every
    capture and build site records itself)."""
    return True


def ensure_compile_introspection() -> bool:
    """JAX's name, kept: nothing to install in the port."""
    return True


def compile_event_count() -> int:
    """Compile events recorded so far, cache hits included (monotonic).
    Sampling it around a dispatch tells whether the dispatch captured or
    built (the chunk-wall ratchet's probe)."""
    return _compile_total


def recompile_count() -> int:
    """Captures and compiler runs so far (the sampler's `recompiles`)."""
    return _recompile_total


def build_cache_counts() -> dict:
    """{'hits', 'misses'}: the builds recorded so far that found their
    library (`cache_hit`) and those that ran a compiler; captures are not
    builds (`utils/compile_cache.cache_stats`)."""
    with _compile_lock:
        return dict(_build_counts)


def signature_of(named: dict) -> str:
    """`name:dtype[shape]` of each tensor in `named`, comma-joined (at most
    2000 characters): the abstract signature a capture is specialized to."""
    parts = []
    for name, t in named.items():
        dtype = str(getattr(t, "dtype", type(t).__name__)).removeprefix("torch.")
        shape = ",".join(str(d) for d in getattr(t, "shape", ()))
        parts.append(f"{name}:{dtype}[{shape}]")
    return ", ".join(parts)[:2000]


@contextlib.contextmanager
def record_compile(name: str, signature: Optional[str] = None, cache_hit: bool = False,
                   capture: bool = True):
    """Time the block as one compile: a CUDA-graph capture (`capture`: any
    open profiler window is closed first) or a build (`capture=False`).
    The record is written after the block returns; a block that raises
    records nothing (its error goes on to the caller)."""
    if capture:
        _close_window_for_capture()
    t0 = time.perf_counter()
    yield
    record_build(name, time.perf_counter() - t0, signature, cache_hit, build=not capture)


def record_build(name: str, seconds: float, signature: Optional[str] = None,
                 cache_hit: bool = False, build: bool = True) -> None:
    """Record one compile timed by the caller (builds that run in parallel
    time themselves); `build=False` for a capture, which the build cache's
    counts leave out."""
    record = {"name": name, "compile_s": round(seconds, 4)}
    if cache_hit:
        record["cache_hit"] = True
    if signature:
        record["signature"] = signature[:2000]
    _record(record, build)


def _record(record: dict, build: bool = False) -> None:
    global _compile_total, _recompile_total
    with _compile_lock:
        _compile_total += 1
        if not record.get("cache_hit"):
            _recompile_total += 1
        if build:
            _build_counts["hits" if record.get("cache_hit") else "misses"] += 1
        _compile_records.append(record)
        del _compile_records[:-_COMPILE_RING_MAX]
    from actor_critic_tpu_torch.telemetry import session as _session

    try:
        _session.event("compile", **record)
    except Exception:  # noqa: BLE001 — telemetry never takes the run down
        pass


def compile_records() -> list[dict]:
    """Recent structured compile records (process-global ring)."""
    with _compile_lock:
        return list(_compile_records)


def _close_window_for_capture() -> None:
    from actor_critic_tpu_torch.telemetry import session as _session

    s = _session.current()
    if s is not None and s.profiler is not None:
        s.profiler.close(cut_by="capture")


class WindowedProfiler:
    """Armable N-tick `torch.profiler` capture bound to one telemetry
    directory.

    States: idle -> armed (`arm(iters)`) -> active (the first `tick()`
    after arming starts the trace) -> idle (after `iters` more ticks, or
    `close()`). The transitions are lock-guarded; `arm` is safe from the
    exporter's HTTP thread, `request_arm` from a signal handler, and
    `tick` runs on the training thread.
    """

    def __init__(self, directory: str):
        self.directory = os.fspath(directory)
        self._lock = threading.Lock()
        self._armed_iters = 0
        # Signal-safe arm request: SIGUSR2 runs its handler ON the main
        # (training) thread, which may already hold self._lock inside
        # tick(). The handler therefore only WRITES (_pending_arm, then the
        # request counter), and tick() only READS, comparing the counter
        # with the last value it consumed.
        self._pending_arm = DEFAULT_PROFILE_ITERS
        # torchlint: thread-owned=signal (single writer by design: only the
        # signal handler bumps the request counter; taking the
        # non-reentrant lock there would deadlock a handler landing inside
        # tick(), see above)
        self._arm_requests = 0
        self._arm_seen = 0
        self._remaining = 0
        self._active_dir: Optional[str] = None
        self._prof = None
        self._captures = 0
        self._t_start = 0.0

    # -- control surface (HTTP thread) ------------------------------------
    def arm(self, iters: int = DEFAULT_PROFILE_ITERS) -> dict:
        """Request a capture of the next `iters` ticks. Returns the status
        dict; arming while armed or active is a no-op report, not an error
        (two probes racing must not corrupt a capture). Not for a signal
        handler on the training thread: that is `request_arm`."""
        iters = max(int(iters), 1)
        with self._lock:
            if (
                self._armed_iters == 0
                and self._arm_requests == self._arm_seen
                and self._active_dir is None
            ):
                self._armed_iters = iters
            return self._status_locked()

    def request_arm(self, iters: int = DEFAULT_PROFILE_ITERS) -> None:
        """Lock-free arm request for signal handlers: two plain attribute
        stores; the next tick() folds it into the armed state."""
        self._pending_arm = max(int(iters), 1)
        self._arm_requests += 1

    def status(self) -> dict:
        with self._lock:
            return self._status_locked()

    def _status_locked(self) -> dict:
        requested = self._arm_requests != self._arm_seen
        armed = self._armed_iters or (requested and self._pending_arm)
        if self._active_dir is not None:
            state = "active"
        elif armed:
            state = "armed"
        else:
            state = "idle"
        out = {"state": state, "captures": self._captures}
        if armed:
            out["iters"] = armed
        if self._active_dir is not None:
            out["directory"] = self._active_dir
            out["remaining_iters"] = self._remaining
        return out

    # -- training-thread surface ------------------------------------------
    def tick(self) -> None:
        """One training iteration (or dispatch) boundary. Starts a pending
        capture or counts an active one down; free when idle."""
        requests = self._arm_requests
        with self._lock:
            if (
                requests != self._arm_seen
                and self._armed_iters == 0
                and self._active_dir is None
            ):
                self._armed_iters = self._pending_arm
            self._arm_seen = requests
            if self._active_dir is not None:
                self._remaining -= 1
                if self._remaining > 0:
                    return
                stop = self._take_active_locked()
            elif self._armed_iters > 0:
                self._start_locked()
                return
            else:
                return
        self._stop(*stop)

    def _start_locked(self) -> None:
        from actor_critic_tpu_torch.telemetry import session as _session

        n, self._armed_iters = self._armed_iters, 0
        self._captures += 1
        path = os.path.join(self.directory, f"profile_{self._captures:03d}")
        try:
            from actor_critic_tpu_torch.utils.profiling import start_trace

            prof = start_trace(path)
        except Exception as e:  # noqa: BLE001 — profiler unavailable: report, don't die
            _session.event("profile_failed", path=path, error=str(e)[:500])
            return
        self._prof = prof
        self._active_dir = path
        self._remaining = n
        self._t_start = time.perf_counter()
        _session.event("profile_start", path=path, iters=n)

    def _take_active_locked(self) -> tuple:
        out = (self._prof, self._active_dir, time.perf_counter() - self._t_start)
        self._prof, self._active_dir = None, None
        return out

    def _stop(self, prof, path: str, dur_s: float, **fields) -> None:
        from actor_critic_tpu_torch.telemetry import session as _session

        try:
            from actor_critic_tpu_torch.utils.profiling import stop_trace

            stop_trace(prof, path)
        except Exception as e:  # noqa: BLE001 — report, never end the run
            _session.event("profile_failed", path=path, error=str(e)[:500], **fields)
            return
        _session.complete_span("profile", time.perf_counter() - dur_s, dur_s, path=path)
        _session.event("profile_done", path=path, wall_s=round(dur_s, 3), **fields)

    def close(self, cut_by: Optional[str] = None) -> None:
        """Stop a capture left active (session teardown mid-window, or a
        CUDA-graph capture about to start: `cut_by="capture"`, which
        leaves an armed window armed for the ticks after it)."""
        with self._lock:
            if cut_by is None:
                self._armed_iters = 0
                self._arm_seen = self._arm_requests
            if self._active_dir is None:
                return
            stop = self._take_active_locked()
        self._stop(*stop, **({} if cut_by is None else {"cut_by": cut_by}))


def tick() -> None:
    """Per-iteration hook the training loops call: routes to the current
    session's profiler (no-op when no session or no profiler is
    installed)."""
    from actor_critic_tpu_torch.telemetry import session as _session

    s = _session.current()
    if s is not None and s.profiler is not None:
        s.profiler.tick()


def install_sigusr2(iters: int = DEFAULT_PROFILE_ITERS) -> bool:
    """`kill -USR2 <pid>` arms a capture on the live run: the way in when
    no --telemetry-port was passed. Main thread only (POSIX signal
    contract); returns False where unsupported."""
    if threading.current_thread() is not threading.main_thread():
        return False
    usr2 = getattr(signal, "SIGUSR2", None)
    if usr2 is None:  # pragma: no cover - non-POSIX
        return False

    def _handler(signum, frame):
        from actor_critic_tpu_torch.telemetry import session as _session

        s = _session.current()
        if s is not None and s.profiler is not None:
            # request_arm, not arm(): the handler runs ON the training
            # thread, which may hold the profiler lock inside tick().
            s.profiler.request_arm(iters)

    signal.signal(usr2, _handler)
    return True
