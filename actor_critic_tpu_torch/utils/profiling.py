"""Tracing, timing and numerics-guard helpers (the port's counterpart of
`actor_critic_tpu/utils/profiling.py`):

- `trace(logdir)`: a `torch.profiler` context (CPU activity, and CUDA
  when the process has a card) that writes a Chrome trace,
  `<logdir>/trace.json` (open it in ui.perfetto.dev or chrome://tracing).
  `start_trace`/`stop_trace` are the same as a pair, for windows that
  cannot hold a context open (`telemetry/profiler.py`'s
  `/profile?iters=N`).
- `named_scope`: `torch.profiler.record_function`, so a trace carries
  readable range names.
- `time_fn(fn, *args)`: seconds per call after warm-up calls; on the card
  timed with CUDA events around back-to-back calls, on the CPU with the
  host clock.
- `nan_guard(tree, name)`: a non-finite detector for development runs. JAX's
  rides a `jax.debug.callback` inside the compiled program; a captured CUDA
  graph can run no host callback, so this one raises when called while
  the current stream captures and otherwise checks on the host and logs a
  warning. No trainer calls it, here or in JAX.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Callable, Optional

import torch

named_scope = torch.profiler.record_function

_log = logging.getLogger(__name__)
TRACE_FILE = "trace.json"
_current: Optional[tuple[Any, str]] = None  # the trace start_trace opened last


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(logdir: str):
    """Begin a profiler capture that `stop_trace` writes into `logdir`;
    returns the profiler object."""
    global _current
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    _current = (prof, os.fspath(logdir))
    return prof


def stop_trace(prof=None, logdir: Optional[str] = None) -> str:
    """End a capture (`prof`, by default the one `start_trace` opened
    last) and write its Chrome trace into `logdir`; returns the trace's
    path."""
    global _current
    if prof is None:
        if _current is None:
            raise RuntimeError("no trace was started")
        prof, start_dir = _current
        logdir = logdir or start_dir
    if _current is not None and _current[0] is prof:
        logdir = logdir or _current[1]
        _current = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """`with trace("runs/prof"):` around the iterations to profile."""
    prof = start_trace(logdir)
    try:
        yield prof
    finally:
        stop_trace(prof, logdir)


def _cuda_tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj] if obj.is_cuda else []
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _cuda_tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _cuda_tensors(x)]
    return []


def time_fn(fn: Callable[..., Any], *args: Any, iters: int = 10, warmup: int = 2) -> float:
    """Mean seconds per `fn(*args)` call. The `warmup` calls absorb first-use
    costs; the `iters` timed calls are issued back to back. When an
    argument or the output lies on the card, the time is the device's,
    between two CUDA events around the calls; otherwise the host clock's."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    cuda = _cuda_tensors(args) or _cuda_tensors(out)
    if cuda:
        device = cuda[0].device
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def nan_guard(tree: Any, name: str = "value") -> None:
    """Log a warning if any floating leaf of `tree` (a tensor, or a dict,
    list or tuple of them) holds a non-finite element. Reading the values
    waits for the device. Raises inside a CUDA-graph capture, where no
    host check can run."""
    if _capturing():
        raise RuntimeError(
            "nan_guard reads values on the host; a captured CUDA graph cannot run it "
            f"(called for {name!r} while the current stream captures)")
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                leaves.append(x)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    if leaves and not all(bool(torch.isfinite(x).all()) for x in leaves):
        _log.warning("nan_guard: non-finite values detected in %s", name)
