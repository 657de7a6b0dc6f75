"""Health monitors — structured run-health events (`events.jsonl`); a
copy of `actor_critic_tpu/telemetry/health.py`.

Both monitors consume the same per-iteration `observe` feed the session
routes from the training loops (`telemetry.observe(it, metrics)` inside
the log callbacks) and emit JSONL events through a supplied `emit(kind,
**fields)` callable. They share one signature — `observe(it, metrics,
now_s)` — so the session dispatches to every monitor uniformly (each
ignores the argument it doesn't need). They never raise and never touch
the device: a health check is a handful of float compares per logged
iteration.

- `ThroughputMonitor`: EMA of iterations/s; fires `throughput_regression`
  when the rate stays below `(1 - drop_threshold)` of the EMA for
  `confirm_observations` CONSECUTIVE observations (after a warmup) —
  one isolated slow window (a checkpoint save or an eval inside the
  observation interval inflates dt) recovers on the next observation
  and stays quiet — then re-arms only after the rate recovers so a
  sustained slowdown produces one event, not one per iteration.
- `DivergenceMonitor`: fires `divergence` on (a) a non-finite value for
  any `*loss*` metric (the SAC alpha-runaway signature), or (b) a
  tracked return metric collapsing below `collapse_frac` of its best
  observed value once the run had made real progress.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

Emit = Callable[..., None]


class ThroughputMonitor:
    """Iterations/s EMA with a configurable regression threshold."""

    def __init__(
        self,
        emit: Emit,
        drop_threshold: float = 0.5,
        ema_alpha: float = 0.2,
        warmup_observations: int = 3,
        confirm_observations: int = 2,
    ):
        """`confirm_observations`: consecutive sub-floor rates required
        before firing. The default of 2 makes the monitor blind to the
        periodic one-window blips a healthy run produces (checkpoint
        saves, evals) while a sustained regression still fires on its
        second observation."""
        if not 0.0 < drop_threshold < 1.0:
            raise ValueError("drop_threshold must be in (0, 1)")
        self._emit = emit
        self._drop = float(drop_threshold)
        self._alpha = float(ema_alpha)
        self._warmup = int(warmup_observations)
        self._confirm = max(int(confirm_observations), 1)
        self._ema: Optional[float] = None
        self._seen = 0
        self._below = 0
        self._last_it: Optional[int] = None
        self._last_t: Optional[float] = None
        self._tripped = False

    def observe(self, it: int, metrics: dict, now_s: float) -> None:
        """Feed one observation; only (it, now_s) matter here, `metrics`
        rides the uniform monitor signature."""
        if self._last_it is not None and it > self._last_it:
            dt = now_s - self._last_t
            if dt <= 0:
                return  # same-timestamp double log; no rate to measure
            rate = (it - self._last_it) / dt
            self._seen += 1
            if self._ema is not None and self._seen > self._warmup:
                floor = (1.0 - self._drop) * self._ema
                if rate < floor:
                    self._below += 1
                    if self._below >= self._confirm and not self._tripped:
                        self._tripped = True
                        self._emit(
                            "throughput_regression",
                            iter=it,
                            iters_per_s=round(rate, 4),
                            ema_iters_per_s=round(self._ema, 4),
                            drop_threshold=self._drop,
                        )
                else:
                    self._below = 0
                    self._tripped = False
            self._ema = (
                rate
                if self._ema is None
                else self._alpha * rate + (1.0 - self._alpha) * self._ema
            )
        self._last_it = it
        self._last_t = now_s


class DivergenceMonitor:
    """Non-finite-loss and return-collapse detector."""

    def __init__(
        self,
        emit: Emit,
        return_keys: Sequence[str] = (
            "avg_return_ema", "recent_return", "eval_return",
        ),
        collapse_frac: float = 0.1,
        min_progress: float = 1.0,
    ):
        """`min_progress`: the best-return watermark must exceed this
        before collapse can fire — a run still at its random-policy floor
        has nothing to collapse from (and near-zero watermarks would make
        the fraction test fire on noise)."""
        self._emit = emit
        self._return_keys = tuple(return_keys)
        self._collapse = float(collapse_frac)
        self._min_progress = float(min_progress)
        self._best: dict[str, float] = {}
        self._fired_nonfinite = False
        self._fired_collapse: set[str] = set()

    def observe(self, it: int, metrics: dict, now_s: float = 0.0) -> None:
        for k, v in metrics.items():
            if "loss" not in k:
                continue
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(f):
                if not self._fired_nonfinite:
                    self._fired_nonfinite = True
                    self._emit(
                        "divergence", iter=it, reason="non_finite_loss",
                        metric=k,
                    )
                return  # one event covers the row; collapse is moot now
        for k in self._return_keys:
            v = metrics.get(k)
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(f):
                continue
            best = self._best.get(k)
            if best is None or f > best:
                self._best[k] = f
                self._fired_collapse.discard(k)  # recovered: re-arm
                continue
            if (
                best > self._min_progress
                and f < self._collapse * best
                and k not in self._fired_collapse
            ):
                self._fired_collapse.add(k)
                self._emit(
                    "divergence", iter=it, reason="return_collapse",
                    metric=k, value=round(f, 4), best=round(best, 4),
                    collapse_frac=self._collapse,
                )
