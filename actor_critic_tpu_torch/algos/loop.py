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

The warm-up registry (`utils/compile_cache.py`): when the run's warm-up
plan names the trainer's `<module>.make_train_step` entry, the loop runs
its capture part right before the first dispatch (after the restore and
the first `state_hook` call): `warm_up`, the `WARMUP_ITERATIONS` eager
steps off the books (everything the step writes snapshotted and put back
bitwise), then the captures of the graphs `compile_cache.fused_graphs`
names. The loop then replays from its first iteration and records no
capture; on the CPU only the eager part runs. Without the plan (or when
its capture part failed) the loop behaves as described above.

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

Telemetry (`telemetry/`, JAX's `checkpointed_train` sites): each dispatch
beats the stall watchdog, ticks the on-demand profiler, and runs in an
`update` span (`it`, `dispatch`) holding an `env_step` instant (the
rollout is fused into the step); a `checkpoint` span (`step`, `saved`)
marks every save boundary, also without `ckpt`, and a `log` span wraps
each dispatch's log decision (and the sync of a logged row). A replay
returns once it is queued, so the `update` span is the host's launch
time, as JAX's is its dispatch time. The save comes before the log, as in
JAX, unless a `state_hook` is given: then the log's eval runs first, the
hook installs what it decided, and the save holds it.

The chunk-wall ratchet (JAX's): with `chunk` > 1 and a stall watchdog
armed, each dispatch waits for its replay (an event sync; the unwatched
loop adds no sync) and times itself. A dispatch that ran eagerly in the
warm-up (on the CPU: the process's first), captured a graph or built a
kernel (`profiler.compile_event_count` moved), or ran a graph's first
replay (after a warm-up the loop's first dispatch is one) only extends
the watchdog's grace by 3 x its wall; any other raises the watchdog's timeout to at least
3 x its wall and, with `ckpt`, persists the wall to `<ckpt
dir>/chunk_wall.json`, which a resumed run reads before its first
dispatch.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from typing import Any, Callable, Optional

import torch

from actor_critic_tpu_torch import telemetry
from actor_critic_tpu_torch.telemetry import profiler
from actor_critic_tpu_torch.utils import watchdog
from actor_critic_tpu_torch.utils.cadence import should_log, should_save

# Eager iterations before the capture; iteration 1 is always one of them.
WARMUP_ITERATIONS = 2


_collector_lock = threading.Lock()
_collector_holds = 0
_collector_was_enabled = True


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, **kwargs):
    """`torch.cuda.graph(graph, **kwargs)` with Python's cyclic collector
    held off from the first of any overlapping captures until the last
    ends. A CUDAGraph that the collector frees mid-capture (one of an
    earlier run, kept in a reference cycle) resets itself, a CUDA call that
    invalidates a "global"-mode capture from any thread and a
    "thread_local" one from its own. Garbage waits for the next collection
    (collecting before each capture, as torch once did, is slow in a large
    process). Every capture of the port goes through here."""
    global _collector_holds, _collector_was_enabled
    with _collector_lock:
        if _collector_holds == 0:
            _collector_was_enabled = gc.isenabled()
            gc.disable()
        _collector_holds += 1
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
    finally:
        with _collector_lock:
            _collector_holds -= 1
            if _collector_holds == 0 and _collector_was_enabled:
                gc.enable()


class CapturedStep:
    """`iterations` consecutive train steps captured into one CUDA graph
    from `state` (which must have run the step eagerly before, on a side
    stream); the capture runs no iteration. `replay()` runs them and
    returns the last one's metrics, valid until the next replay.
    `capture_error_mode` is `torch.cuda.graph`'s: the async learners
    capture in "thread_local" mode, so that actor threads may go on
    enqueueing their copies while the learner's thread captures. Its
    callers record the capture as one `compile` event
    (`telemetry/profiler.record_compile`)."""

    def __init__(self, step: Callable, state, iterations: int = 1,
                 capture_error_mode: str = "global"):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        with capture(self.graph, capture_error_mode=capture_error_mode):
            for _ in range(iterations):
                _, self.metrics = step(state)

    def replay(self) -> dict[str, torch.Tensor]:
        self.graph.replay()
        return self.metrics


@contextlib.contextmanager
def restored(tensors: dict[str, torch.Tensor], generator: torch.Generator):
    """Snapshot `tensors` and `generator`'s state, and put both back bitwise
    when the block ends, also when it raises (the copies run on the current
    stream, after any side-stream work the block joined back). The
    snapshot is freed then."""
    saved = {k: t.clone() for k, t in tensors.items()}
    generator_state = generator.get_state()
    try:
        yield
    finally:
        with torch.no_grad():
            for k, t in tensors.items():
                t.copy_(saved[k])
        generator.set_state(generator_state)
        saved.clear()


def capture_mode(step: Callable) -> str:
    """The capture mode of a train step: "thread_local" for a step with a
    process group (`step.group`, a data-parallel step: NCCL's watchdog
    thread polls the communicator's events during the capture, a CUDA call
    that would invalidate a "global"-mode one), "global" otherwise."""
    return "thread_local" if getattr(step, "group", None) is not None else "global"


def warm_up(step: Callable, state, graphs: tuple[int, ...] = (),
            stream: Optional[torch.cuda.Stream] = None,
            name: str = "train_step") -> dict[int, CapturedStep]:
    """The warm-up a capture needs, ahead of the first dispatch and off the
    books: `WARMUP_ITERATIONS` eager steps (on `stream`, a side stream, on
    the card) from a snapshot of everything the step writes
    (`common.carried_tensors` and the generator's state), put back bitwise
    after them; then one capture per steps-per-replay in `graphs` (each
    one `compile` event named `<name>[x<n>]`). Returns the captures by
    steps per replay."""
    from actor_critic_tpu_torch.algos.common import carried_tensors

    with restored(carried_tensors(state), state.generator):
        for _ in range(WARMUP_ITERATIONS):
            eager_step(step, state, stream)
    captured = {}
    for n in graphs:
        with profiler.record_compile(f"{name}[x{n}]",
                                     profiler.signature_of(carried_tensors(state))):
            captured[n] = CapturedStep(step, state, n, capture_mode(step))
    return captured


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
    train_step: Optional[Callable] = None,
):
    """Run train steps up to `num_iterations` (from the latest checkpoint in
    `ckpt` when `resume`); returns (state, last metrics). `capturable` (the
    trainer's `CAPTURABLE`) lets the loop replay the step as a CUDA graph
    where the state lives on the card, `chunk` steps per graph; the log,
    eval and save cadences fire at chunk boundaries, so the caller makes
    them multiples of `chunk`. `state_hook`: see the module's docstring.

    `train_step` replaces `make_train_step(env, cfg)` with a step the
    caller built: a data-parallel one (`parallel.dp.make_dp_train_step`
    over a state from `distribute_state`), run on every rank of its group.
    Its collectives are first issued eagerly (the warm-up iterations make
    NCCL's communicator before any capture), and it is captured in
    "thread_local" mode (`capture_mode`)."""
    if num_iterations < 1:
        raise ValueError("num_iterations must be >= 1")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    from actor_critic_tpu_torch.algos.common import carried_tensors
    from actor_critic_tpu_torch.utils import checkpoint, compile_cache

    if state is None:
        state = init_state(env, cfg, seed, device)
    done, metrics = 0, {}
    if ckpt is not None and resume and ckpt.latest_step() is not None:
        done = ckpt.restore(state)
        if done >= num_iterations:
            metrics = ckpt.restore_metrics(done)
    step = make_train_step(env, cfg) if train_step is None else train_step
    graph = capturable and state.ep_return.is_cuda
    warmup_stream = torch.cuda.Stream(state.ep_return.device) if graph else None
    eager_left = WARMUP_ITERATIONS if graph else 0
    captured: dict[int, CapturedStep] = {}  # by steps per replay: 1 and `chunk`
    replayed: set[int] = set()  # the graphs whose first replay has run
    chunk_wall_path = None
    if chunk > 1 and ckpt is not None:
        chunk_wall_path = os.path.join(ckpt.directory, checkpoint.CHUNK_WALL_FILE)
        learned = checkpoint._read_chunk_wall(chunk_wall_path)
        if learned is not None:
            # This process's first dispatches warm up and capture, and are
            # never ratcheted from: start from what an earlier leg proved.
            watchdog.ensure_timeout_at_least(3.0 * learned)
    name = getattr(make_train_step, "__module__", "step").rpartition(".")[2]

    def save(it: int) -> None:
        if should_save(it, save_every, num_iterations):
            with telemetry.span("checkpoint", step=it, saved=ckpt is not None):
                if ckpt is not None:
                    ckpt.save(it, state, {n: float(v) for n, v in metrics.items()})

    def log(it: int) -> None:
        if log_fn is not None:
            with telemetry.span("log", it=it):
                if (should_log(it, log_every, num_iterations)
                        or (eval_every > 0 and it % eval_every == 0)):
                    log_fn(it, {n: float(v) for n, v in metrics.items()})

    it = done
    if state_hook is not None:
        state_hook(it, state)
    if it < num_iterations:
        graphs = compile_cache.fused_graphs(chunk, num_iterations, resume) if graph else ()

        def warm_captures() -> None:
            captured.update(warm_up(step, state, graphs, warmup_stream, f"{name}.train_step"))

        if compile_cache.capture_part(f"{name}.make_train_step", warm_captures) and graph:
            eager_left = 0
    while it < num_iterations:
        # A chunk cut short realigns the next one to a multiple of `chunk`.
        k = min(chunk - it % chunk, num_iterations - it)
        # An eager warm-up iteration on the card; without a graph, the
        # process's first dispatch (its first-call costs).
        warm = eager_left > 0 if graph else it == done
        if graph and warm:
            k, eager_left = 1, eager_left - 1
        watchdog.beat()
        telemetry.profiler_tick()
        timed = chunk > 1 and watchdog.armed()
        compiles_before = profiler.compile_event_count() if timed else 0
        first_replay = False
        t_dispatch = time.monotonic()
        with telemetry.span("update", it=it + k, dispatch="async"):
            telemetry.instant("env_step", fused=True)
            if not graph:
                for _ in range(k):
                    state, metrics = step(state)
            elif warm:
                state, metrics = eager_step(step, state, warmup_stream)
            else:
                n = chunk if k == chunk else 1
                if n not in captured:
                    with profiler.record_compile(
                            f"{name}.train_step[x{n}]",
                            profiler.signature_of(carried_tensors(state))):
                        captured[n] = CapturedStep(step, state, n, capture_mode(step))
                first_replay = n not in replayed
                replayed.add(n)
                for _ in range(k // n):
                    metrics = captured[n].replay()
        if timed:
            # The replay returned when it was queued: its wall is only seen
            # behind a wait, taken only while a watchdog is armed.
            if graph:
                done_event = torch.cuda.Event()
                done_event.record()
                # torchlint: disable=transfer-discipline (only while a watchdog is
                # armed: the chunk wall needs the replay's end)
                done_event.synchronize()
            wall = time.monotonic() - t_dispatch
            if warm or first_replay or profiler.compile_event_count() > compiles_before:
                # A warm-up, capture or first-replay wall would bake that
                # one-off cost into 3x the stall timeout for good: shield the
                # next chunk only.
                watchdog.extend_grace(3.0 * wall)
            else:
                watchdog.ensure_timeout_at_least(3.0 * wall)
                if chunk_wall_path is not None:
                    checkpoint._persist_chunk_wall(chunk_wall_path, wall)
        it += k
        if state_hook is None:
            save(it)
            log(it)
        else:
            # The hook installs what this iteration's eval decided, and the
            # save holds it: a resume then goes on from the same state.
            log(it)
            state_hook(it, state)
            save(it)
    return state, metrics
