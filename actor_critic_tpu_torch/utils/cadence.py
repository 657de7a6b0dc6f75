"""Logging and checkpoint cadences (counterpart of
`actor_critic_tpu/utils/cadence.py`), shared by the loop and the CLI."""

from __future__ import annotations


def should_log(it: int, log_every: int, num_iterations: int) -> bool:
    """Every `log_every` iterations (when > 0) plus always the first and
    final ones; `it` is 1-based."""
    if it == 1 or it == num_iterations:
        return True
    return log_every > 0 and it % log_every == 0


def should_save(it: int, save_every: int, num_iterations: int) -> bool:
    """Every `save_every` iterations (when > 0) plus always the final one;
    `it` is 1-based."""
    if it == num_iterations:
        return True
    return save_every > 0 and it % save_every == 0


def finite_or_none(v):
    """float(v) if finite, else None: NaN and Inf are not strict JSON."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if f == f and abs(f) != float("inf") else None
