"""The host loop around a train step (counterpart of
`actor_critic_tpu/algos/host_loop.py::fused_train_loop`).

The JAX package runs a fused iteration as one compiled program
(`jax.jit(step, donate_argnums=0)`). On the card the port's counterpart is
a CUDA graph: for a trainer whose step is capturable (`CAPTURABLE` in
`a2c.py` and `ppo.py`) the loop runs the first `WARMUP_ITERATIONS`
iterations eagerly on a side stream, which torch needs before it captures
autograd and cuBLAS work; they are real iterations, logged, counted and
annealed. It then captures the next iteration's whole step (rollout,
bootstrap values, GAE through the kernel, the update, the episode fold)
into a `torch.cuda.CUDAGraph` (`CapturedStep`) and replays that graph once
per iteration. A capture or replay that fails raises: the loop never
carries on eagerly. On the CPU, and for IMPALA/A3C, every iteration runs
eagerly.

What a capture freezes, and how the step is built around it:
- addresses: a replay reads and writes the tensors the capture saw, so
  everything the step carries over (parameters, moments, rollout obs and
  env state, episode accounting, `step_counter`, Adam's count) is written
  in place;
- host values: the step reads its step-dependent scalars from the state's
  schedule table on the device, never from a Python float;
- random numbers: the trainer's generator is registered with the graph,
  so each replay draws the numbers the same eager iteration would;
- Python: the step's Python runs once, at capture, and none of its
  kernels do. Nothing is counted on the host: the iteration and Adam
  counts are device tensors that each replay advances, and each kernel
  counts its own launches on the card.

Metrics stay on the device and are synced to the host only on the
iterations that log: every `log_every`, and always the first and the
last, and every `eval_every` (an eval iteration always logs, as in the JAX
CLI). A replay overwrites the metrics of the one before, so they are read
before the next replay.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# Eager iterations before the capture; iteration 1 is always one of them.
WARMUP_ITERATIONS = 2


def should_log(it: int, log_every: int, num_iterations: int) -> bool:
    """Every `log_every` iterations (when > 0) plus always the first and
    final ones; `it` is 1-based."""
    if it == 1 or it == num_iterations:
        return True
    return log_every > 0 and it % log_every == 0


class CapturedStep:
    """One train step captured into a CUDA graph from `state` (which must
    have run the step eagerly before, on a side stream); the capture runs
    no iteration. `replay()` runs one and returns its metrics, valid until
    the next replay."""

    def __init__(self, step: Callable, state):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        with torch.cuda.graph(self.graph):
            _, self.metrics = step(state)

    def replay(self) -> dict[str, torch.Tensor]:
        self.graph.replay()
        return self.metrics


def eager_step(step: Callable, state, stream: Optional[torch.cuda.Stream] = None):
    """`step(state)`, on `stream` if one is given, ordered after the current
    stream's work and before its next (the caller reads the metrics and may
    run an eval there)."""
    if stream is None:
        return step(state)
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = step(state)
    current.wait_stream(stream)
    return out


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
    capturable: bool = False,
):
    """Run `num_iterations` train steps; returns (state, last metrics).
    `capturable` (the trainer's `CAPTURABLE`) lets the loop replay the step
    as a CUDA graph where the state lives on the card."""
    if num_iterations < 1:
        raise ValueError("num_iterations must be >= 1")
    if state is None:
        state = init_state(env, cfg, seed, device)
    step = make_train_step(env, cfg)
    graph = capturable and state.ep_return.is_cuda
    warmup_stream = torch.cuda.Stream(state.ep_return.device) if graph else None
    captured: Optional[CapturedStep] = None
    metrics: dict = {}
    for it in range(1, num_iterations + 1):
        if not graph or it <= WARMUP_ITERATIONS:
            state, metrics = eager_step(step, state, warmup_stream)
        else:
            if captured is None:
                captured = CapturedStep(step, state)
            metrics = captured.replay()
        if log_fn is not None and (
            should_log(it, log_every, num_iterations)
            or (eval_every > 0 and it % eval_every == 0)
        ):
            log_fn(it, {k: float(v) for k, v in metrics.items()})
    return state, metrics
