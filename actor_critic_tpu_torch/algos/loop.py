"""The host loop around a train step (counterpart of
`actor_critic_tpu/algos/host_loop.py::fused_train_loop` and
`utils/checkpoint.py::checkpointed_train`).

The JAX package runs a fused iteration as one compiled program
(`jax.jit(step, donate_argnums=0)`). On the card the port's counterpart is
a CUDA graph: for a trainer whose step is capturable (`CAPTURABLE` in
`a2c.py`, `ppo.py`, `impala.py`, `ddpg.py` and `sac.py`) the loop runs the first
`WARMUP_ITERATIONS` iterations of the process eagerly on a side stream,
which torch needs before it captures autograd, cuBLAS and cuDNN work; they
are real iterations, logged, counted and annealed. It then captures the
next iteration's whole step (rollout, bootstrap values, the advantage
kernel, the update, the episode fold) into a `torch.cuda.CUDAGraph`
(`CapturedStep`) and replays that graph once per iteration. With `chunk`
k > 1 (the CLI's `--chunk`, JAX's `make_chunked_step`) it captures k
consecutive steps into one graph and replays it once per k iterations;
its metrics are the last iteration's. A chunk cut short (by the warm-up,
a resume that is not on a multiple of k, or the end of the run) replays
the one-step graph instead. A capture or replay that fails raises: the
loop never carries on eagerly. On the CPU every iteration runs eagerly,
k of them per chunk.

What a capture freezes, and how the step is built around it:
- addresses: a replay reads and writes the tensors the capture saw, so
  everything the step carries over (`common.carried_tensors`) is written
  in place;
- host values: the step reads its step-dependent scalars from the state's
  schedule table on the device, never from a Python float;
- random numbers: the trainer's generator is registered with the graph,
  so each replay draws the numbers the same eager iteration would, and
  its state after a replay is the eager state's;
- Python: the step's Python runs once, at capture, and none of its
  kernels do. Nothing is counted on the host: the iteration and Adam
  counts are device tensors that each replay advances, and each kernel
  counts its own launches on the card.

Checkpoints (`ckpt`, a `utils.checkpoint.Checkpointer`): with `resume`
the loop first copies the latest checkpoint into the state's own tensors,
before any capture, and runs the iterations left; it saves on the
`save_every` cadence and after the last iteration (reading the state to
the host waits for the device). A resume with nothing left to run returns
the saved metrics.

A `state_hook(it, state)` runs on the host before the first dispatch and
after each one (`it` the number of iterations already run), so before
every iteration that follows, and before the save of iteration `it`: the
seam where the mixture curriculum installs new type weights into the
fleet state (`envs/mixture.py::set_fleet_weights`), which then ride the
checkpoint. It writes the state in place and returns nothing, so that a
replay, which reads the addresses its capture saw, sees what it wrote.

Metrics stay on the device and are synced to the host only on the
iterations that log: every `log_every`, and always the first and the
last, and every `eval_every` (an eval iteration always logs, as in the JAX
CLI), at dispatch boundaries. A replay overwrites the metrics of the one
before, so they are read before the next replay.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from actor_critic_tpu_torch.utils.cadence import should_log, should_save

# Eager iterations before the capture; iteration 1 is always one of them.
WARMUP_ITERATIONS = 2


class CapturedStep:
    """`iterations` consecutive train steps captured into one CUDA graph
    from `state` (which must have run the step eagerly before, on a side
    stream); the capture runs no iteration. `replay()` runs them and
    returns the last one's metrics, valid until the next replay."""

    def __init__(self, step: Callable, state, iterations: int = 1):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        with torch.cuda.graph(self.graph):
            for _ in range(iterations):
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
    state_hook: Optional[Callable[[int, Any], None]] = None,
    chunk: int = 1,
    ckpt=None,
    save_every: int = 0,
    resume: bool = False,
):
    """Run train steps up to `num_iterations` (from the latest checkpoint in
    `ckpt` when `resume`); returns (state, last metrics). `capturable` (the
    trainer's `CAPTURABLE`) lets the loop replay the step as a CUDA graph
    where the state lives on the card, `chunk` steps per graph; the log,
    eval and save cadences fire at chunk boundaries, so the caller makes
    them multiples of `chunk`. `state_hook`: see the module's docstring."""
    if num_iterations < 1:
        raise ValueError("num_iterations must be >= 1")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if state is None:
        state = init_state(env, cfg, seed, device)
    done, metrics = 0, {}
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        done = ckpt.restore(state)
        if done >= num_iterations:
            metrics = ckpt.restore_metrics(done)
    step = make_train_step(env, cfg)
    graph = capturable and state.ep_return.is_cuda
    warmup_stream = torch.cuda.Stream(state.ep_return.device) if graph else None
    eager_left = WARMUP_ITERATIONS if graph else 0
    captured: dict[int, CapturedStep] = {}  # by steps per replay: 1 and `chunk`
    it = done
    if state_hook is not None:
        state_hook(it, state)
    while it < num_iterations:
        # A chunk cut short realigns the next one to a multiple of `chunk`.
        k = min(chunk - it % chunk, num_iterations - it)
        if not graph:
            for _ in range(k):
                state, metrics = step(state)
        elif eager_left > 0:
            k, eager_left = 1, eager_left - 1
            state, metrics = eager_step(step, state, warmup_stream)
        else:
            n = chunk if k == chunk else 1
            if n not in captured:
                captured[n] = CapturedStep(step, state, n)
            for _ in range(k // n):
                metrics = captured[n].replay()
        it += k
        if log_fn is not None and (
            should_log(it, log_every, num_iterations)
            or (eval_every > 0 and it % eval_every == 0)
        ):
            log_fn(it, {name: float(v) for name, v in metrics.items()})
        if state_hook is not None:
            state_hook(it, state)
        if ckpt is not None and should_save(it, save_every, num_iterations):
            ckpt.save(it, state, {name: float(v) for name, v in metrics.items()})
    return state, metrics
