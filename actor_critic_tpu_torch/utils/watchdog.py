"""Stall watchdog: failure DETECTION for long training runs (the port's
counterpart of `actor_critic_tpu/utils/watchdog.py`).

A device call can wedge mid-run: the host thread then blocks forever in a
wait (a kernel that never ends, a lost card), the process looks alive,
and a long run silently becomes a zero-progress hang. Checkpoint/resume
already makes runs restart-idempotent; this is the component that
*notices* the hang and dies so that a retry loop can restart:

    python -m actor_critic_tpu_torch.train ... --ckpt-dir runs/x --save-every 1000 \
        --stall-timeout 300
    while [ $? -eq 42 ]; do python -m actor_critic_tpu_torch.train ... --resume; done

A daemon thread watches a heartbeat the training loops touch (`beat()`:
every host collection step, every eval step, every fused dispatch); if no
beat lands within `timeout_s` the process prints a diagnosis naming the
open telemetry span and `os._exit(42)`s, the only reliable escape, since
the main thread is stuck inside a C extension call that Python
exceptions cannot interrupt.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

STALL_EXIT_CODE = 42

# Arm/disarm (append/remove) happen only on the run-owning thread via
# start()/stop(); the watchdog daemon and /healthz threads only iterate,
# and a snapshot that is one arm/disarm stale is harmless for a heartbeat
# check.
_ACTIVE: list["StallWatchdog"] = []


def beat() -> None:
    """Touch every armed watchdog. Called from the hot host loops; a
    plain attribute write, so it is safe (and ~free) when none is armed."""
    for w in _ACTIVE:
        w.touch()


def armed() -> bool:
    """Whether any watchdog is currently armed (callers use this to skip
    watchdog-only work, e.g. the chunk-wall measurement in
    `algos/loop.fused_train_loop`, which waits for each replay)."""
    return bool(_ACTIVE)


def status() -> Optional[dict]:
    """Staleness snapshot of the armed watchdog for live introspection
    (telemetry/exporter.py's /healthz): seconds since the last heartbeat,
    the configured timeout, and whether the startup grace still shields
    firing. None when no watchdog is armed. With several armed (tests),
    reports the one CLOSEST TO FIRING — staleness relative to its own
    timeout, not raw staleness (a 200s-stale 10s-timeout watchdog fires
    long before a 300s-stale 600s-timeout one)."""
    if not _ACTIVE:
        return None
    now = time.monotonic()
    w = max(_ACTIVE, key=lambda w: (now - w._last) - w.timeout_s)
    return {
        "staleness_s": round(now - w._last, 3),
        "timeout_s": w.timeout_s,
        "in_grace": now <= w._grace_until,
    }


def extend_grace(secs: float) -> None:
    """Shield every armed watchdog from firing for the next `secs`
    seconds (raises the startup-grace deadline, never lowers it).

    For slow-but-legitimate windows that must NOT widen the PERMANENT
    stall timeout: chunked dispatch uses it after a dispatch that ran
    eagerly in the warm-up or captured a graph (or built a kernel), whose
    measured wall mixes that one-off cost with run time. The temporary
    shield covers the next chunk; the first clean dispatch then supplies
    a wall for the real `ensure_timeout_at_least` ratchet."""
    for w in _ACTIVE:
        w.extend_grace(secs)


def ensure_timeout_at_least(secs: float) -> None:
    """Raise every armed watchdog's timeout to at least `secs`.

    Chunked dispatch (`fused_train_loop(chunk>1)`) beats once per chunk;
    a chunk whose legitimate wall time exceeds --stall-timeout would
    otherwise be killed as a stall on every chunk after the startup grace,
    a kill/resume loop that never clears a chunk. The loop calls this
    with a multiple of each COMPLETED dispatch's measured wall time:
    proof of real progress, so widening the stall definition to match is
    correct, and a genuine wedge is still detected within the widened
    window."""
    for w in _ACTIVE:
        if secs > w.timeout_s:
            print(
                f"[watchdog] chunk wall time requires stall timeout "
                f">= {secs:.0f}s; raising from {w.timeout_s:.0f}s",
                file=sys.stderr, flush=True,
            )
            w.timeout_s = float(secs)


class StallWatchdog:
    """Arms a daemon thread that kills the process (exit 42) if `touch()`
    isn't called for `timeout_s` seconds. Use as a context manager around
    a training run; `stop()` disarms."""

    def __init__(self, timeout_s: float, startup_grace_s: float = 600.0):
        """`startup_grace_s`: no firing during the first max(timeout,
        grace) seconds of THIS process: the first kernel builds, the eager
        warm-up iterations and the graph captures block the host with no
        beats, and a resume pays them again, so an early 'stall' would
        send the retry loop into a kill/restart cycle that never
        progresses."""
        if timeout_s <= 0:
            raise ValueError("timeout_s must be > 0 (use no watchdog instead)")
        self.timeout_s = float(timeout_s)
        # extend_grace raises the deadline from the run-owning thread
        # only; the watchdog thread reads a float.
        self._grace_until = time.monotonic() + max(timeout_s, startup_grace_s)
        self._last = time.monotonic()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )

    def touch(self) -> None:
        self._last = time.monotonic()

    def extend_grace(self, secs: float) -> None:
        """Push the no-fire grace deadline to at least `secs` from now
        (module-level `extend_grace` broadcasts to all armed instances)."""
        deadline = time.monotonic() + float(secs)
        if deadline > self._grace_until:
            self._grace_until = deadline

    def start(self) -> "StallWatchdog":
        _ACTIVE.append(self)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped = True
        if self in _ACTIVE:
            _ACTIVE.remove(self)

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        poll = min(5.0, self.timeout_s / 4)
        while not self._stopped:
            time.sleep(poll)
            now = time.monotonic()
            stalled = now - self._last
            if (
                not self._stopped
                and now > self._grace_until
                and stalled > self.timeout_s
            ):
                # Telemetry names the phase that was open when progress
                # stopped (the span stack is maintained even without a
                # --telemetry-dir session) and, with a session, writes a
                # durable `stall` event before the hard exit.
                try:
                    from actor_critic_tpu_torch import telemetry

                    phase = telemetry.stall_report(stalled)
                except Exception:  # noqa: BLE001 — the exit must happen
                    phase = ""
                print(
                    f"[stall-watchdog] no training progress for "
                    f"{stalled:.0f}s (> {self.timeout_s:.0f}s) — device "
                    "presumed wedged; exiting "
                    f"{STALL_EXIT_CODE} so a retry loop can --resume "
                    f"from the last checkpoint{phase}",
                    file=sys.stderr,
                    flush=True,
                )
                sys.stderr.flush()
                os._exit(STALL_EXIT_CODE)
