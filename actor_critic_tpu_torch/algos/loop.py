"""The host loop around a train step (counterpart of
`actor_critic_tpu/algos/host_loop.py::fused_train_loop`).

A plain per-iteration loop. Metrics stay on the device and are synced to
the host only on the iterations that log: every `log_every`, and always
the first and the last, and every `eval_every` (an eval iteration always
logs, as in the JAX CLI). CUDA graphs and chunked dispatch come later.
"""

from __future__ import annotations

from typing import Callable, Optional


def should_log(it: int, log_every: int, num_iterations: int) -> bool:
    """Every `log_every` iterations (when > 0) plus always the first and
    final ones; `it` is 1-based."""
    if it == 1 or it == num_iterations:
        return True
    return log_every > 0 and it % log_every == 0


def fused_train_loop(
    make_train_step: Callable,
    init_state: Callable,
    env,
    cfg,
    num_iterations: int,
    seed: int = 0,
    device="cuda",
    state=None,
    log_every: int = 0,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    eval_every: int = 0,
):
    """Run `num_iterations` train steps; returns (state, last metrics)."""
    if num_iterations < 1:
        raise ValueError("num_iterations must be >= 1")
    if state is None:
        state = init_state(env, cfg, seed, device)
    step = make_train_step(env, cfg)
    metrics: dict = {}
    for it in range(1, num_iterations + 1):
        state, metrics = step(state)
        if log_fn is not None and (
            should_log(it, log_every, num_iterations)
            or (eval_every > 0 and it % eval_every == 0)
        ):
            log_fn(it, {k: float(v) for k, v in metrics.items()})
    return state, metrics
