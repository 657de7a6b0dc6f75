"""Daemon resource sampler (`resources.jsonl`), the port's counterpart of
`actor_critic_tpu/telemetry/sampler.py`.

A background thread records, on a fixed cadence, the signals that
explain the two classic silent run-killers, memory creep and recompile
storms:

- process RSS (``/proc/self/statm``; peak-RSS ``getrusage`` fallback),
- per-card live/peak bytes from ``torch.cuda.memory_stats(i)``
  (``allocated_bytes.all.current`` and ``.peak``). On the CPU there is
  no allocator to ask: the row is ``{"id": 0, "platform": "cpu"}``,
  with the byte fields ABSENT, never zero (JAX's row for a backend
  without allocator stats),
- the ``recompiles`` counter: the port's counterparts of an XLA compile,
  i.e. CUDA-graph captures (`algos/loop.CapturedStep`, behind the fused
  trainers, the host and async learners' `host_loop.HostUpdate`, the
  blocked evals; `serving/engine.py`'s bucket graphs) and kernel builds
  that ran a compiler (`_build.build`'s nvcc, `native.build`'s g++).
  `telemetry/profiler.py::record_compile` counts them; a build that
  found its library already built is a cache hit and is not counted.
  The key keeps JAX's name because `scripts/run_report.py` reads it,
- any registered gauges (``register_gauge``): the async queues, the
  device ring, the serving gateway, the replay ring's facts, so their
  rows ride the same cadence.

No call here is one a CUDA-graph capture forbids: the fused loop
captures in "global" mode, where a forbidden call from ANY thread (this
one included) breaks the capture. ``memory_stats`` reads the caching
allocator's host-side counters, and the card count is read once, at the
first sample, before any capture (a session starts its sampler before
the run does).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import IO, Callable, Optional

from actor_critic_tpu_torch.utils.numguard import safe_json_row

_PAGE = 4096
try:
    import resource as _resource

    _PAGE = _resource.getpagesize()
except Exception:  # pragma: no cover - non-POSIX
    _resource = None


def compile_count() -> int:
    """Captures and compiler runs of this process (see the module
    docstring); the counter lives in `telemetry/profiler.py`."""
    from actor_critic_tpu_torch.telemetry import profiler

    return profiler.recompile_count()


def ensure_compile_listener() -> None:
    """JAX's name, kept: the port's counter needs no listener (every capture
    and build site counts itself), so there is nothing to install."""


# Gauge registry: components with run-long state register a zero-argument
# callable whose return value rides every resources.jsonl row under the
# registered key. Process-global, like JAX's: gauges outlive sessions.
_gauges: dict[str, Callable[[], object]] = {}
_gauges_lock = threading.Lock()


def register_gauge(name: str, fn: Callable[[], object]) -> str:
    """Register `fn` under `name` (suffixed `_2`, `_3`, ... on collision,
    e.g. two gateways in one process). Returns the unique key actually
    used: pass it to `unregister_gauge`."""
    with _gauges_lock:
        key, i = name, 1
        while key in _gauges:
            i += 1
            key = f"{name}_{i}"
        _gauges[key] = fn
        return key


def unregister_gauge(name: str) -> None:
    with _gauges_lock:
        _gauges.pop(name, None)


def gauges() -> dict[str, object]:
    """{key: fn()} of every registered gauge, called outside the registry's
    lock; a gauge that raises is left out (a reader must never take the
    process down)."""
    with _gauges_lock:
        items = list(_gauges.items())
    out = {}
    for key, fn in items:
        try:
            out[key] = fn()
        except Exception:  # noqa: BLE001 — one broken gauge must not end the read
            continue
    return out


def rss_bytes() -> Optional[int]:
    """Current resident set size; peak RSS when /proc is unavailable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        if _resource is None:
            return None
        # ru_maxrss is kilobytes on Linux but bytes on macOS (both are
        # peak, the documented degraded mode).
        maxrss = _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss
        return maxrss if sys.platform == "darwin" else maxrss * 1024


_card_count: Optional[int] = None


def device_memory() -> list[dict]:
    """[{id, platform, live_bytes, peak_bytes}] per card the process has
    initialised (`platform` "gpu", JAX's word for it); on a process that
    has not touched CUDA, one CPU row without byte fields."""
    global _card_count
    try:
        import torch

        if not torch.cuda.is_initialized():
            return [{"id": 0, "platform": "cpu"}]
        if _card_count is None:
            _card_count = torch.cuda.device_count()
        out = []
        for i in range(_card_count):
            row: dict = {"id": i, "platform": "gpu"}
            stats = torch.cuda.memory_stats(i)
            live = stats.get("allocated_bytes.all.current")
            peak = stats.get("allocated_bytes.all.peak")
            if live is not None:
                row["live_bytes"] = int(live)
            if peak is not None:
                row["peak_bytes"] = int(peak)
            out.append(row)
        return out
    except Exception:  # noqa: BLE001 — a sampler error never ends a run
        return []


def sample_row() -> dict:
    """One resources.jsonl row (also usable synchronously from tests)."""
    row: dict = {
        "ts": round(time.time(), 3),
        "recompiles": compile_count(),
    }
    rss = rss_bytes()
    if rss is not None:
        row["rss_bytes"] = rss
    devs = device_memory()
    if devs:
        row["devices"] = devs
    row.update(gauges())
    return row


class ResourceSampler:
    """Daemon thread appending `sample_row()` to `fh` every `interval_s`
    seconds (plus once at start and once at stop, so even a short run
    gets a first/last pair)."""

    def __init__(
        self,
        fh: IO[str],
        interval_s: float = 5.0,
        mirror: Optional[Callable[[dict], None]] = None,
    ):
        self._fh = fh
        self._interval = max(float(interval_s), 0.01)
        # Optional tap fed every sampled row: the session points this at
        # the flight recorder so gauge trends ride the crash ring.
        self._mirror = mirror
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-sampler", daemon=True
        )

    def start(self) -> "ResourceSampler":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _emit(self) -> None:
        row = sample_row()
        try:
            # safe_json_row: one NaN gauge would otherwise raise on EVERY
            # tick and silently end resource sampling for the rest of the
            # run; non-finite values serialize as null.
            self._fh.write(safe_json_row(row) + "\n")
        except (OSError, ValueError):
            # A full disk would otherwise kill the daemon thread; skip the
            # row and keep ticking.
            pass
        if self._mirror is not None:
            try:
                self._mirror(row)
            except Exception:  # noqa: BLE001 — a broken mirror never ends sampling
                pass

    def _run(self) -> None:
        self._emit()
        while not self._stop.wait(self._interval):
            self._emit()
        self._emit()
