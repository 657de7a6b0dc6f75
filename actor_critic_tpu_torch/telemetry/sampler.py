"""The process-wide gauge registry (the registry of
`actor_critic_tpu/telemetry/sampler.py`): components with run-long state
(the serving gateway) register a zero-argument callable, and a reader
(`gauges`) calls each one. Process-global like JAX's: gauges outlive any
one session. The sampler loop that writes the registered gauges to disk is
not ported yet (ROADMAP Queue 1 item 10)."""

from __future__ import annotations

import threading
from typing import Callable

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
