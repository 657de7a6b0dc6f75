"""The host env path's loop plumbing (counterpart of the synchronous half
of `actor_critic_tpu/algos/host_loop.py`).

A host trainer (`ppo.train_host`, `ddpg.train_host`, `sac.train_host`)
steps a `HostEnvPool` in numpy for K steps, records the steps into a
time-major [K, E] block, uploads the block to the device once, and runs
one device update on it. This module holds what they share:

- `EpisodeTracker`: raw-return episode accounting on the host.
- `BlockBuffers`: double-buffered [K, E] block storage. On the card each
  buffer set is pinned host memory written through numpy views; `upload()`
  copies a block into static device buffers with one asynchronous `copy_`
  per field and records a CUDA event after the copies, and
  `begin_block()` waits on the event of the set it is about to rewrite. A
  copy from pinned memory reads the host buffer when the stream reaches
  it, not when it is enqueued, so that wait is what keeps block N's bytes
  intact until they are on the device while block N+1 is collected into
  the other set.
- `HostUpdate`: the device update replayed as one CUDA graph over those
  static buffers (the first `loop.WARMUP_ITERATIONS` calls eager on a side
  stream, then a capture; eager on the CPU). When the run's warm-up plan
  names the update's entry (`utils/compile_cache.py`), the trainer runs
  `HostUpdate.warm` before its first iteration instead, on a zero block
  staged into the static buffers (`BlockBuffers.preallocate`), and every
  call is a replay.
- `IterationClock`: where an iteration's time goes (collect, wait,
  dispatch on the host clock; upload and update on the device).
- the checkpoint state (`host_ckpt_state`, `strip_replay`, `host_resume`,
  `host_maybe_save`) and the shared off-policy loop
  (`off_policy_train_host`).

With a numpy mirror (`models/host_actor.py`) and `overlap`, the host acts
with parameters one update stale: before each update's replay a copy of
the acting module's parameters into pinned memory is enqueued
(`MirrorSnapshot`), and the next block's first mirror call waits on its
event. Stream order makes that snapshot the parameters the update read,
and the collect loop never waits for the update itself. Without a mirror,
or with `overlap=False`, the host acts through the module on the device
every env step and waits for it.

The async actor-learner half (JAX's `async_host_*` checkpoint functions
and `off_policy_train_host_async`) is below the synchronous loops: actor
threads (`traj_queue.ActorService`) collect through the mirrors and push
blocks into a queue, and the learner's thread takes them (`AsyncFeed`:
through pinned staging from the host `TrajQueue`, or by slot from the
device ring), replays its update, and publishes the update's input
parameters (`publish_snapshot`).

Telemetry, at the JAX module's sites: an `env_step` span per collected
block and a watchdog `beat()` per env step (`host_collect`) and per eval
step (`host_evaluate`); per iteration a profiler `tick()` and an
`iteration` span around `host_to_device` (the staging and upload),
`update` (the host's launch of the graph replay: it returns once queued),
`queue_wait` (async), `eval`, `log` (`maybe_log`, which syncs the row)
and `checkpoint` (a save); and the off-policy loops' `replay` gauge (the
ring's capacity facts, static).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from actor_critic_tpu_torch import telemetry
from actor_critic_tpu_torch.algos import loop
from actor_critic_tpu_torch.algos.common import OffPolicyTransition, named_carried
from actor_critic_tpu_torch.models import host_actor
from actor_critic_tpu_torch.telemetry import profiler, sampler
from actor_critic_tpu_torch.tree import tree_map
from actor_critic_tpu_torch.utils import watchdog
from actor_critic_tpu_torch.utils.cadence import should_log, should_save


class EpisodeTracker:
    """Raw-return episode accounting across host steps."""

    def __init__(self, num_envs: int):
        self._ep_ret = np.zeros(num_envs)
        self.finished: list[float] = []

    def update(self, raw_reward: np.ndarray, done: np.ndarray) -> None:
        self._ep_ret += raw_reward
        for i in np.nonzero(done)[0]:
            self.finished.append(float(self._ep_ret[i]))
            self._ep_ret[i] = 0.0

    def report(self, window: int = 20) -> dict[str, float]:
        return {
            "recent_return": (
                float(np.mean(self.finished[-window:])) if self.finished else float("nan")
            ),
            "episodes": float(len(self.finished)),
        }


class MergedEpisodeTracker:
    """A read-only `report()` over several actors' EpisodeTrackers: the
    mean over each one's last `window` episodes."""

    def __init__(self, trackers: list[EpisodeTracker]):
        self._trackers = trackers

    def report(self, window: int = 20) -> dict[str, float]:
        recent: list[float] = []
        total = 0
        for t in self._trackers:
            finished = t.finished
            total += len(finished)
            recent.extend(finished[-window:])
        return {
            "recent_return": float(np.mean(recent)) if recent else float("nan"),
            "episodes": float(total),
        }


class BlockBuffers:
    """Preallocated, double-buffered time-major [K, E, ...] block storage,
    and the static device buffers a block is uploaded into.

    `record(t, name, value)` writes step t of a field; `put(name, value)` a
    whole array that rides with the block (the bootstrap obs, the mirror's
    baselines, the env-step count). Each field is allocated at its first
    value, in pinned memory when `device` is a card, and reused.
    `begin_block()` flips to the other buffer set, after waiting for the
    upload that last read it; `block()` is the current block's numpy
    arrays (only the fields written since `begin_block()`); `upload()`
    copies them into `device` (the same tensors at every call: a CUDA
    graph reads them) and returns those tensors by field."""

    def __init__(self, num_steps: int, device: torch.device | str = "cpu"):
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        self.num_steps = int(num_steps)
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._bufs: tuple[dict, dict] = ({}, {})
        self._events: list[Optional[torch.cuda.Event]] = [None, None]
        self._active = 0
        self._seen: set[str] = set()
        self.static: dict[str, torch.Tensor] = {}
        self.wait_s = 0.0  # host seconds spent waiting in begin_block()

    def begin_block(self) -> None:
        self._active ^= 1
        self._seen = set()
        event = self._events[self._active]
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            self.wait_s += time.perf_counter() - t0

    def _slot(self, name: str, shape: tuple[int, ...], dtype: np.dtype) -> np.ndarray:
        buf = self._bufs[self._active]
        held = buf.get(name)
        if held is None or held[1].shape != shape or held[1].dtype != dtype:
            tensor = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                 pin_memory=self._pin)
            held = buf[name] = (tensor, tensor.numpy())
        self._seen.add(name)
        return held[1]

    def record(self, t: int, name: str, value) -> None:
        value = np.asarray(value)
        self._slot(name, (self.num_steps, *value.shape), value.dtype)[t] = value

    def put(self, name: str, value) -> None:
        value = np.asarray(value)
        self._slot(name, value.shape, value.dtype)[...] = value

    def block(self) -> dict[str, np.ndarray]:
        buf = self._bufs[self._active]
        return {k: buf[k][1] for k in buf if k in self._seen}

    def preallocate(self, spec: dict) -> None:
        """Allocate the static device buffers of `spec` (name → an object
        with `shape` and a numpy `dtype`) zero-filled, before any upload: a
        warm-up ahead of the first block reads them (finite, and valid
        indices), and every upload after checks its block against them."""
        from actor_critic_tpu_torch.data_plane.ring import torch_dtype

        for name, leaf in spec.items():
            if name not in self.static:
                self.static[name] = torch.zeros(tuple(leaf.shape), dtype=torch_dtype(leaf.dtype),
                                                device=self.device)

    def upload(self) -> dict[str, torch.Tensor]:
        buf = self._bufs[self._active]
        for name in self._seen:
            src = buf[name][0]
            dst = self.static.get(name)
            if dst is None:
                dst = self.static[name] = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            elif dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"block field {name!r} changed from {tuple(dst.shape)} "
                                 f"{dst.dtype} to {tuple(src.shape)} {src.dtype}")
            dst.copy_(src, non_blocking=self._pin)
        if self._pin:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._events[self._active] = event
        return self.static


def host_collect(
    pool,
    obs: np.ndarray,
    num_steps: int,
    act_fn: Callable[[np.ndarray], tuple[np.ndarray, dict[str, np.ndarray]]],
    tracker: EpisodeTracker,
    buffers: Optional[BlockBuffers] = None,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Step the pool `num_steps` times; return (last obs, [K, E] block).

    `act_fn(obs) -> (action, extras)`; the extras (log_prob and value
    on-policy) are recorded beside the standard fields, into `buffers` (a
    loop-lived `BlockBuffers`; a private one when None)."""
    if buffers is None:
        buffers = BlockBuffers(num_steps)
    elif buffers.num_steps != num_steps:
        raise ValueError(
            f"buffers hold {buffers.num_steps}-step blocks, collect asked for {num_steps}")
    buffers.begin_block()
    record = buffers.record
    # The sharded pool's workers buffer a span record a step; while a
    # session is installed they are relayed after the block under the
    # workers' own pids (0 records for a pool without workers).
    drain_fn = getattr(pool, "drain_telemetry", None) if telemetry.current() is not None else None
    # One span per block, not per pool step: the breakdown needs the
    # block's total, not millions of micro-events.
    with telemetry.span("env_step", steps=num_steps):
        for t in range(num_steps):
            watchdog.beat()
            action, extras = act_fn(obs)
            out = pool.step(action)
            record(t, "obs", obs)
            record(t, "action", action)
            for k, v in extras.items():
                record(t, k, v)
            record(t, "reward", out.reward)
            record(t, "done", out.done)
            record(t, "terminated", out.terminated)
            record(t, "final_obs", out.final_obs)
            tracker.update(out.raw_reward, out.done)
            obs = out.obs
    if drain_fn is not None:
        try:
            drain_fn()
        except RuntimeError:
            raise  # a dead worker: the same contract as a failed step
        except Exception:
            pass  # telemetry never takes the run down
    return obs, buffers.block()


def host_evaluate(pool, act_fn: Callable[[np.ndarray], np.ndarray], max_steps: int = 1000) -> float:
    """Greedy host eval: the mean RAW return of each env's FIRST episode;
    `act_fn(obs) -> action` is the deterministic policy. Stops once every
    env has finished an episode."""
    obs = pool.reset()
    E = pool.num_envs
    returns = np.zeros(E)
    alive = np.ones(E)
    for _ in range(max_steps):
        watchdog.beat()  # an eval sweep is progress, not a stall
        out = pool.step(act_fn(obs))
        returns += out.raw_reward * alive
        alive *= 1.0 - out.done
        obs = out.obs
        if not alive.any():
            break
    return float(returns.mean())


def timed_eval(pool, act_fn: Callable[[np.ndarray], np.ndarray], max_steps: int) -> dict:
    """`host_evaluate` as log-row entries, in an `eval` span:
    `eval_return`, and `eval_s`, its seconds on the host clock (the CLI
    leaves them out of `wall_s`)."""
    t0 = time.perf_counter()
    with telemetry.span("eval"):
        ret = host_evaluate(pool, act_fn, max_steps=max_steps)
    return {"eval_return": ret, "eval_s": time.perf_counter() - t0}


def device_act(module_fn: Callable[[torch.Tensor], Any], device: torch.device):
    """`obs (numpy) -> module_fn(obs on device)` with every output read back
    to numpy: the acting path without a mirror (waits for the device)."""

    @torch.no_grad()
    def act(obs: np.ndarray):
        out = module_fn(torch.as_tensor(np.asarray(obs), device=device))
        if isinstance(out, tuple):
            return tuple(x.cpu().numpy() for x in out)
        return out.cpu().numpy()

    return act


def greedy_eval_act(module, greedy: Callable, host_greedy: Optional[Callable],
                    device: torch.device) -> Callable[[], Callable[[np.ndarray], np.ndarray]]:
    """`make()` → the eval's act function over `module`'s parameters as they
    are at that call: the numpy mirror `host_greedy(np_params, obs)` on a
    snapshot (taken once an eval, after the update in flight), else
    `greedy(module, obs)` on the device every step."""
    if host_greedy is None:
        return lambda: device_act(lambda o: greedy(module, o), device)

    def make():
        params = host_actor.mirror_params(module)
        return lambda o: np.asarray(host_greedy(params, o))

    return make


class HostUpdate:
    """A host trainer's device update, `body() -> metrics`, which reads the
    static block buffers (or the device ring's slot) and writes the learner
    in place (the counterpart of the JAX trainers' jitted update). On the
    card the first `loop.WARMUP_ITERATIONS` calls run eagerly on a side
    stream; the next captures `body` into one CUDA graph
    (`loop.CapturedStep`, the trainer's generator registered with it, in
    `capture_error_mode`) and every call from then on replays it. On the
    CPU every call runs eagerly. The metrics of a replay are the graph's
    output tensors, overwritten by the next replay. The capture is one
    `compile` event named `name`, its signature the shapes of what
    `carried()` returns at the capture (the tensors the update reads and
    writes, by name)."""

    def __init__(self, body: Callable[[], dict[str, torch.Tensor]], generator: torch.Generator,
                 capture_error_mode: str = "global", name: str = "host_update",
                 carried: Callable[[], dict[str, torch.Tensor]] = dict):
        self.body = body
        self.generator = generator
        self.capture_error_mode = capture_error_mode
        self.name = name
        self.carried = carried
        cuda = generator.device.type == "cuda"
        self.stream = torch.cuda.Stream(generator.device) if cuda else None
        self.eager_left = loop.WARMUP_ITERATIONS if cuda else 0
        self.captured: Optional[loop.CapturedStep] = None

    @property
    def warming(self) -> bool:
        """Whether the next call runs eagerly or captures (on the card)."""
        return self.stream is not None and self.captured is None

    def _step(self, _):
        return self, self.body()

    def _capture(self) -> None:
        with profiler.record_compile(self.name, profiler.signature_of(self.carried())):
            self.captured = loop.CapturedStep(self._step, self,
                                              capture_error_mode=self.capture_error_mode)

    def warm(self) -> None:
        """The update's warm-up ahead of its first call, off the books:
        `loop.WARMUP_ITERATIONS` eager calls (on the side stream on the card)
        from a snapshot of `carried()` and the generator's state, put back
        bitwise after them, then (on the card) the capture: every call
        after it replays. Its inputs are what the static buffers or the
        ring's slot hold now, so the caller stages finite ones first."""
        with loop.restored(self.carried(), self.generator):
            for _ in range(loop.WARMUP_ITERATIONS):
                loop.eager_step(self._step, self, self.stream)
        if self.stream is not None:
            self.eager_left = 0
            if self.captured is None:
                self._capture()

    def __call__(self) -> dict[str, torch.Tensor]:
        if self.stream is None:
            return self.body()
        if self.eager_left > 0:
            self.eager_left -= 1
            return loop.eager_step(self._step, self, self.stream)[1]
        if self.captured is None:
            self._capture()
        return self.captured.replay()


def warm_update(entry: str, update: HostUpdate, buffers: Optional[BlockBuffers] = None,
                spec: Optional[dict] = None, gate=None) -> bool:
    """Entry `entry`'s capture part, run when the run's warm-up plan names it
    (`utils/compile_cache.capture_part`): a zero block of `spec` staged into
    `buffers`' static device buffers (None on the device data plane, whose
    ring slot is zeroed at its allocation), then `update.warm()`, with
    `gate` (an async learner's: a serving sidecar's flushes wait on it)
    cleared meanwhile. Returns whether it ran; without it the update warms
    up at its first calls."""
    from actor_critic_tpu_torch.utils import compile_cache

    def warm() -> None:
        if buffers is not None:
            buffers.preallocate(spec)
        if gate is not None:
            gate.clear()
        try:
            update.warm()
        finally:
            if gate is not None:
                gate.set()

    return compile_cache.capture_part(entry, warm)


def offpolicy_block_fields(spec, cfg, actors: int) -> dict:
    """The fields an off-policy update reads from its static buffers: the
    [K, E_a] transition block (`device_replay.offpolicy_block_spec`; the
    lockstep loop records no `last_obs`) and the 0-dim int64 `env_steps`."""
    from actor_critic_tpu_torch.data_plane import device_replay, ring

    out = device_replay.offpolicy_block_spec(spec, cfg, actors)
    if not actors:
        del out["last_obs"]
    return {**out, "env_steps": ring.array_spec((), "int64")}


class IterationClock:
    """Where one host iteration's time goes: `collect_s` (stepping the pool
    and acting, mirror baselines included), `wait_s` (the host blocked on
    the device: the mirror snapshot's event and the buffers' upload events)
    and `dispatch_s` (enqueueing the upload, the snapshot and the update),
    on the host clock; on the card also `upload_ms` and `update_ms`, the
    device time between CUDA events around the upload and the update. The
    device times are read at `row()`, which the loop calls on logged
    iterations, after the metrics' read has waited for the update."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.times: dict[str, float] = {}
        self._events: list[torch.cuda.Event] = []

    def start(self, phases: tuple[str, ...] = ("collect_s", "wait_s", "dispatch_s")) -> None:
        self.times = dict.fromkeys(phases, 0.0)
        self._events = []

    def add(self, phase: str, seconds: float) -> None:
        self.times[phase] += seconds

    def mark(self) -> None:
        """An event on the current stream (before the upload, between the
        upload and the update, after the update)."""
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._events.append(event)

    def row(self) -> dict[str, float]:
        out = dict(self.times)
        if self.cuda and len(self._events) == 3:
            a, b, c = self._events
            c.synchronize()
            out["upload_ms"] = a.elapsed_time(b)
            out["update_ms"] = b.elapsed_time(c)
        return out


@dataclasses.dataclass
class HostRun:
    """What a host trainer's iteration works on, handed to an
    `iteration_hook(it, run)` after each iteration's dispatch: the block
    buffers (host arrays and static device buffers; None on the async
    learner's device data plane), the mirror's snapshot (None without a
    mirror), the device update, the tensors the update writes by name
    (`carried()`), the clock, and for an async learner its queue (a
    `TrajQueue` or `DeviceTrajRing`) and its actors' gate (a hook that runs
    the update eagerly clears it meanwhile, as `run_updates` does)."""

    buffers: Optional[BlockBuffers]
    snapshot: Optional[host_actor.MirrorSnapshot]
    update: HostUpdate
    device_state: dict[str, Any]
    clock: IterationClock
    queue: Any = None
    gate: Any = None

    def carried(self) -> dict[str, torch.Tensor]:
        return named_carried(self.device_state, "")


# -- checkpoints -------------------------------------------------------


@dataclasses.dataclass
class HostCheckpoint:
    """A host trainer's checkpoint (`utils.checkpoint.Checkpointer` saves and
    restores it): the device state by name (the net and its Adam state, or
    the learner, and the env-step count), the trainer's generator (the
    JAX trainers' key) and the pool's normalizer state as float64 tensors
    (`pool obs_rms.mean`, ...)."""

    generator: torch.Generator
    device_state: dict[str, Any]
    pool: dict[str, torch.Tensor]


def pool_tensors(state: dict) -> dict[str, torch.Tensor]:
    """A pool's `get_state()` as float64 tensors by dotted name."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in pool_tensors(v).items()})
        else:
            out[k] = torch.tensor(np.asarray(v, np.float64))
    return out


def pool_state(tensors: dict[str, torch.Tensor]) -> dict:
    """The inverse of `pool_tensors`: a state `HostEnvPool.set_state` takes."""
    out: dict = {}
    for k, t in tensors.items():
        *path, leaf = k.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.numpy()
    return out


def strip_replay(learner):
    """The learner with its replay storage cut to one slot of its own
    (shape and dtype kept), and cursors of its own: what a replay-free
    checkpoint holds. The quantizer's stats stay the learner's own tensors:
    they are item-shaped, cost a few bytes, and a resumed run encodes
    fresh transitions against the standardization the restored critic
    trained under."""
    rb = learner.replay
    return dataclasses.replace(learner, replay=rb._replace(
        storage=tree_map(lambda x: x[:1].clone(), rb.storage),
        insert_pos=rb.insert_pos.clone(), size=rb.size.clone()))


def host_ckpt_state(pool, generator: torch.Generator, save_replay: bool = True,
                    **device_state) -> HostCheckpoint:
    """The checkpoint state of a host trainer: `device_state` (the learner,
    or the net and its Adam state, and `env_steps`), the generator and the
    pool's normalizer state. `save_replay=False` cuts the learner's ring to
    a one-slot stub (`strip_replay`): a Humanoid-scale ring is ~3 GB a
    save. Resuming such a checkpoint restarts with an EMPTY ring, and the
    warm-up gate holds the updates until it holds a batch again."""
    if not save_replay and "learner" in device_state:
        device_state = dict(device_state, learner=strip_replay(device_state["learner"]))
    return HostCheckpoint(generator=generator, device_state=device_state,
                          pool=pool_tensors(pool.get_state()))


def host_maybe_save(ckpt, it: int, save_every: int, num_iterations: int, pool, metrics: dict,
                    generator: torch.Generator, save_replay: bool = True,
                    **device_state) -> None:
    """Save on the `should_save` cadence (`it` is 1-based). Reading the
    state to the host waits for the device."""
    if ckpt is None or not should_save(it, save_every, num_iterations):
        return
    with telemetry.span("checkpoint", step=it):
        _host_save(ckpt, it, pool, metrics, save_replay, generator, device_state)


def _host_save(ckpt, it, pool, metrics, save_replay, generator, device_state) -> None:
    # The pool's action convention and whether the ring was saved ride the
    # metrics file, so that a resume can warn on a convention flip and
    # build the template the checkpoint holds.
    metrics = {
        **{k: float(v) for k, v in (metrics or {}).items()},
        "_pool_scale_actions": float(getattr(pool, "scales_actions", False)),
        "_replay_saved": float(save_replay),
    }
    ckpt.save(it, host_ckpt_state(pool, generator, save_replay=save_replay, **device_state),
              metrics)


def _warn_restore_mismatch(restored_pool: dict, pool, saved_scale) -> None:
    """Warn on an action-convention flip and on a normalization flip: a
    checkpoint whose obs normalizer gathered real statistics came from a
    run that fed normalized observations to its networks, and resuming it
    into a raw-obs pool (or the reverse) puts the restored networks off
    their input distribution. The flags are not saved; the stats are the
    signal."""
    try:
        saved_count = float(np.asarray(restored_pool["obs_rms"]["count"]))
    except (KeyError, TypeError):
        saved_count = 0.0
    if saved_scale is not None and bool(saved_scale) != getattr(pool, "scales_actions", False):
        warnings.warn(
            "resuming a checkpoint trained under the "
            f"{'scaled' if saved_scale else 'clipped'}-action convention into a pool with "
            f"scale_actions={getattr(pool, 'scales_actions', False)} — the restored policy's "
            "actions will execute differently than they trained. Relaunch with the run's "
            "original --scale-actions setting.",
            stacklevel=3,
        )
    trained_normalized = saved_count > 1.0
    if trained_normalized != pool.normalizes_obs:
        was, now = (("with obs normalization", "normalize_obs=False") if trained_normalized
                    else ("on RAW observations", "normalize_obs=True"))
        warnings.warn(
            f"resuming a checkpoint trained {was} into a pool with {now} — the restored "
            "networks will act off-distribution (their observation scaling no longer matches "
            f"the pool's). Rebuild the pool with normalize_obs={trained_normalized} (or "
            "restart the run from scratch).",
            stacklevel=3,
        )


def host_resume(ckpt, template: HostCheckpoint, pool) -> tuple[Optional[HostCheckpoint], int]:
    """Restore the latest checkpoint into `template` in place (its tensors,
    the generator) and push the pool's normalizer state back; (None, 0)
    when nothing is saved. The learner, the Adam states, the generator,
    `env_steps` and the normalizer come back exactly; the env simulators
    do not (gymnasium cannot save them), so the pool restarts fresh
    episodes."""
    step = ckpt.latest_step()
    if step is None:
        return None, 0
    ckpt.restore(template, step)
    restored_pool = pool_state(template.pool)
    pool.set_state(restored_pool)
    _warn_restore_mismatch(restored_pool, pool,
                           ckpt.restore_metrics(step).get("_pool_scale_actions"))
    return template, step


def maybe_log(it: int, log_every: int, metrics: dict, tracker, history: list,
              log_fn: Optional[Callable[[int, dict], None]], extra: Optional[dict] = None,
              num_iterations: int = 0, force: bool = False,
              clock: Optional[IterationClock] = None) -> None:
    """Append the host metrics to `history` (and `log_fn`) on the
    `should_log` cadence, or when `force`d (eval rows), with the
    iteration's times from `clock`. Reading the metrics waits for the
    update."""
    if not (force or should_log(it + 1, log_every, num_iterations)):
        return
    # The float() reads are the loop's first wait on the dispatched
    # update: the log span absorbs whatever device time is left.
    with telemetry.span("log", it=it + 1):
        m = {k: float(v) for k, v in metrics.items()}
        m.update(tracker.report())
        if extra:
            m.update(extra)
        if clock is not None:
            m.update(clock.row())
        history.append((it + 1, m))
        if log_fn is not None:
            log_fn(it + 1, m)


def off_policy_train_host(
    pool,
    cfg,
    num_iterations: int,
    *,
    init_learner: Callable,
    make_act_fn: Callable,
    make_ingest_update: Callable,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    eval_every: int = 0,
    make_greedy_act: Optional[Callable] = None,
    eval_envs: int = 4,
    eval_steps: int = 1000,
    ckpt=None,
    save_every: int = 0,
    resume: bool = False,
    overlap: bool = True,
    make_host_explore: Optional[Callable] = None,
    make_host_greedy: Optional[Callable] = None,
    save_replay: bool = True,
    device="cuda",
    iteration_hook: Optional[Callable[[int, HostRun], None]] = None,
):
    """The host-env loop of the off-policy trainers (DDPG/TD3, SAC), which
    differ only in their factories:

      init_learner(obs_shape, action_dim, cfg, generator, device) -> learner
      make_act_fn(action_dim, cfg) -> (actor, obs, generator, env_steps) -> action
      make_ingest_update(action_dim, cfg) -> (learner, [K, E] block,
                                              env_steps, generator) -> metrics

    An iteration collects K steps of the E envs, uploads the block, and
    runs the ingest (insert into the ring, the warm-up gate) and J updates
    as one device update (`HostUpdate`, one CUDA graph on the card), with
    the env-step count after the block copied in with it. The learner
    exposes `.actor`. With `eval_every > 0` a frozen-stats eval pool runs a
    greedy sweep on that cadence (through `make_host_greedy`'s mirror, else
    `make_greedy_act(action_dim, cfg) -> (actor, obs) -> action` on the
    device) and its `eval_return` rides the log row. With `overlap` and a
    `make_host_explore(spec, cfg) -> (np_params, obs, rng, env_steps) ->
    action` mirror, collection acts on the host with parameters one update
    stale. Returns (learner, history)."""
    from actor_critic_tpu_torch import resolve_device

    device = resolve_device(device)
    spec = pool.spec
    generator = torch.Generator(device=device).manual_seed(seed)
    learner = init_learner(spec.obs_shape, spec.action_dim, cfg,
                           torch.Generator().manual_seed(seed), device)
    act = make_act_fn(spec.action_dim, cfg)
    ingest_update = make_ingest_update(spec.action_dim, cfg)
    mirrored = host_actor.supports_mirror(host_actor.mirror_params(learner.actor))

    eval_pool = eval_act = None
    if eval_every > 0 and make_greedy_act is not None:
        eval_pool = pool.eval_pool(eval_envs)
        eval_act = greedy_eval_act(
            learner.actor, make_greedy_act(spec.action_dim, cfg),
            make_host_greedy(spec, cfg) if make_host_greedy is not None and mirrored else None,
            device)

    env_steps = 0
    start_it = 0
    if ckpt is not None and resume:
        # The template mirrors what the checkpoint holds: its
        # `_replay_saved` (not this run's flag) says full ring or stub.
        step = ckpt.latest_step()
        saved_replay = True
        if step is not None:
            saved_replay = bool(ckpt.restore_metrics(step).get("_replay_saved", 1.0))
        steps_t = torch.zeros((), dtype=torch.int64)
        template = host_ckpt_state(pool, generator, save_replay=saved_replay, learner=learner,
                                   env_steps=steps_t)
        restored, start_it = host_resume(ckpt, template, pool)
        if restored is not None:
            if not saved_replay:
                # The ring stays this run's empty one; the stub restored
                # its quantizer stats in place.
                warnings.warn(
                    "resuming a replay-free checkpoint (save_replay=False): the buffer "
                    "restarts EMPTY — updates pause until it refills past one batch, then "
                    "continue on fresh experience only.",
                    stacklevel=2,
                )
            env_steps = int(steps_t)

    # reset() after set_state: it re-zeroes the reward normalizer's running
    # returns (episodes restart on resume), and the restored obs stats take
    # the reset batch as one ordinary update.
    obs = pool.reset()
    E = pool.num_envs
    tracker = EpisodeTracker(E)
    history: list = []
    metrics: dict = {}
    buffers = BlockBuffers(cfg.steps_per_iter, device)
    clock = IterationClock(device)

    snapshot = host_act = None
    if overlap and make_host_explore is not None and mirrored:
        host_act = make_host_explore(spec, cfg)
        snapshot = host_actor.MirrorSnapshot(learner.actor, pin=device.type == "cuda")
        snapshot.enqueue()
        rng = np.random.default_rng(seed + 0x5EED)

    def body() -> dict[str, torch.Tensor]:
        b = buffers.static
        traj = OffPolicyTransition(obs=b["obs"], action=b["action"], reward=b["reward"],
                                   next_obs=b["final_obs"], terminated=b["terminated"],
                                   done=b["done"])
        return ingest_update(learner, traj, b["env_steps"], generator)

    update = HostUpdate(body, generator, name=f"{offpolicy_name(cfg)}.host_update",
                        carried=lambda: named_carried(
                            {"learner": learner, "block": buffers.static}, ""))
    run = HostRun(buffers, snapshot, update, {"learner": learner}, clock)
    if start_it < num_iterations:
        warm_update(f"{offpolicy_name(cfg)}.make_host_ingest_update", update, buffers,
                    offpolicy_block_fields(spec, cfg, 0))
    gauge = register_replay_gauge(learner, cfg)
    try:
        for it in range(start_it, num_iterations):
            telemetry.profiler_tick()
            with telemetry.span("iteration", it=it + 1):
                clock.start()
                if host_act is not None:
                    t0 = time.perf_counter()
                    host_params = snapshot.params()
                    clock.add("wait_s", time.perf_counter() - t0)

                    def explore_act(o):
                        nonlocal env_steps
                        action = host_act(host_params, o, rng, env_steps)
                        env_steps += E
                        return action, {}
                else:

                    @torch.no_grad()
                    def explore_act(o):
                        nonlocal env_steps
                        action = act(learner.actor, torch.as_tensor(o, device=device), generator,
                                     torch.tensor(env_steps, dtype=torch.int64, device=device))
                        env_steps += E
                        return action.cpu().numpy(), {}

                t0 = time.perf_counter()
                wait0 = buffers.wait_s
                obs, _ = host_collect(pool, obs, cfg.steps_per_iter, explore_act, tracker,
                                      buffers=buffers)
                buffers.put("env_steps", np.asarray(env_steps, np.int64))
                t1 = time.perf_counter()
                clock.add("wait_s", buffers.wait_s - wait0)
                clock.add("collect_s", t1 - t0 - (buffers.wait_s - wait0))
                clock.mark()
                with telemetry.span("host_to_device"):
                    buffers.upload()
                clock.mark()
                if snapshot is not None:
                    # The next block's acting parameters: this update's input,
                    # copied in stream order before its replay.
                    snapshot.enqueue()
                with telemetry.span("update", dispatch="async"):
                    metrics = update()
                clock.mark()
                clock.add("dispatch_s", time.perf_counter() - t1)
                extra = {"env_steps": env_steps}
                if eval_pool is not None and (it + 1) % eval_every == 0:
                    extra.update(timed_eval(eval_pool, eval_act(), eval_steps))
                maybe_log(it, log_every, metrics, tracker, history, log_fn, extra=extra,
                          num_iterations=num_iterations,
                          force="eval_return" in extra or it == start_it, clock=clock)
                host_maybe_save(ckpt, it + 1, save_every, num_iterations, pool, metrics,
                                generator, save_replay=save_replay, learner=learner,
                                env_steps=torch.tensor(env_steps, dtype=torch.int64))
                if iteration_hook is not None:
                    iteration_hook(it + 1, run)
    finally:
        sampler.unregister_gauge(gauge)
    return learner, history


def offpolicy_name(cfg) -> str:
    """The off-policy trainer's name for its capture's `compile` event."""
    return type(cfg).__name__.removesuffix("Config").lower()


def register_replay_gauge(learner, cfg) -> str:
    """Register the `replay` sampler gauge of an off-policy learner's ring:
    its static capacity facts (capacity, bytes per transition against
    fp32, the codec mix) and the codec mode. Static on purpose: a live
    `size` read from the sampler thread would read a device tensor.
    Returns the gauge's key."""
    from actor_critic_tpu_torch.replay import quantize

    mode = getattr(cfg, "replay_dtype", "fp32")
    info = dict(quantize.capacity_report(learner.replay, quantize.offpolicy_codecs(mode)),
                mode=mode)
    return sampler.register_gauge("replay", lambda: info)



# -- the async actor-learner -------------------------------------------

DATA_PLANES = ("host", "device")


def make_async_queue(data_plane: str, depth: int, max_staleness: Optional[int], policy: str,
                     block_spec: Optional[dict] = None, codec: str = "fp32",
                     transfer_pad_s: float = 0.0, device="cpu"):
    """The hand-off of an async learner: the host `TrajQueue`, or the
    `DeviceTrajRing` shaped like `block_spec` on `device`."""
    from actor_critic_tpu_torch.algos.traj_queue import TrajQueue

    if data_plane not in DATA_PLANES:
        raise ValueError(f"data_plane must be 'host' or 'device', got {data_plane!r}")
    if data_plane == "host":
        return TrajQueue(depth=depth, max_staleness=max_staleness, policy=policy)
    from actor_critic_tpu_torch.data_plane.ring import DeviceTrajRing

    return DeviceTrajRing(depth=depth, block_spec=block_spec, codec=codec,
                          max_staleness=max_staleness, policy=policy,
                          transfer_pad_s=transfer_pad_s, device=device)


class AsyncFeed:
    """The learner's end of an async hand-off: `stage(block, **scalars)`
    makes a consumed block the input of the updates that follow, and
    `done(block)` ends its lease after the last of them.

    Host plane (`TrajQueue`): the block's arrays and the `scalars` (the
    off-policy env-step count) are copied on the host into the learner's
    pinned staging (`buffers`, a double-buffered `BlockBuffers`, each set
    rewritten only after its upload has run), the queue's slot is released
    at once, and the staging is uploaded into the static device buffers
    the update reads (`buffers.static`). A later put may rewrite the slot,
    never the bytes the update reads. `transfer_pad_s` sleeps before the
    copy (a testbed knob for a slow link).

    Device plane (`DeviceTrajRing`): the scalars go into 0-dim int64
    device tensors (`scalars`) by fill kernels, and `ring.select` points the
    slot index at the block and makes the stream wait for its enqueue; the
    update gathers the slot itself, and `done` releases it."""

    def __init__(self, queue, num_steps: int, device: torch.device, transfer_pad_s: float = 0.0):
        from actor_critic_tpu_torch.data_plane.ring import DeviceTrajRing

        self.queue = queue
        self.device_plane = isinstance(queue, DeviceTrajRing)
        self.device = device
        self.transfer_pad_s = float(transfer_pad_s)
        self.buffers = None if self.device_plane else BlockBuffers(num_steps, device)
        self.scalars: dict[str, torch.Tensor] = {}

    @property
    def wait_s(self) -> float:
        """Host seconds spent waiting for a staging set's upload."""
        return 0.0 if self.buffers is None else self.buffers.wait_s

    def scalar(self, name: str) -> torch.Tensor:
        """The device-plane scalar `name` (made at its first use, before any
        capture reads it)."""
        t = self.scalars.get(name)
        if t is None:
            t = self.scalars[name] = torch.zeros((), dtype=torch.int64, device=self.device)
        return t

    def stage(self, block, **scalars: int) -> None:
        if self.device_plane:
            for name, value in scalars.items():
                self.scalar(name).fill_(int(value))
            self.queue.select(block)
            return
        if self.transfer_pad_s > 0:
            time.sleep(self.transfer_pad_s)
        buffers = self.buffers
        buffers.begin_block()
        for name, value in block.arrays.items():
            buffers.put(name, value)
        for name, value in scalars.items():
            buffers.put(name, np.asarray(value, np.int64))
        self.queue.release(block)
        buffers.upload()

    def done(self, block) -> None:
        if self.device_plane:
            self.queue.release(block)


def stage_block(feed: AsyncFeed, block, **scalars: int) -> None:
    """`feed.stage` as the JAX learners' trace has it: a `host_to_device`
    span around the host plane's staging and upload, a `host_to_device`
    instant (`device_plane=True`) on the device plane, where no block
    bytes move."""
    if feed.device_plane:
        telemetry.instant("host_to_device", device_plane=True)
        feed.stage(block, **scalars)
        return
    with telemetry.span("host_to_device"):
        feed.stage(block, **scalars)


def publish_snapshot(snapshot: host_actor.MirrorSnapshot, publisher, version: int) -> float:
    """Publish the parameters `snapshot` copied before the update's replay
    (the update's INPUT, in stream order) as `version`, once its copy has
    run; the publisher freezes a copy of its own. Returns the host seconds
    spent waiting for the copy (the previous update finishing)."""
    t0 = time.perf_counter()
    tree = snapshot.params()
    waited = time.perf_counter() - t0
    publisher.publish(tree, version)
    return waited


def run_updates(update: HostUpdate, n: int, gate) -> dict[str, torch.Tensor]:
    """`n` calls of `update`; the actors held at their block boundaries
    (`gate` cleared) while it runs eagerly or is captured on the card.
    Returns the last call's metrics."""
    if update.warming:
        gate.clear()
    try:
        for _ in range(n):
            metrics = update()
    finally:
        gate.set()
    return metrics


def check_actors(actors: list) -> None:
    """Raise a dead actor's exception every iteration, not only once the
    queue drains: a surviving actor would otherwise keep a halved fleet
    looking healthy."""
    for a in actors:
        if a.error is not None:
            raise RuntimeError(f"actor {a.actor_id} died") from a.error


def stop_actors(stop, actors: list, queue) -> None:
    stop.set()
    for a in actors:
        a.join(timeout=30.0)
    queue.close()


def async_row(it: int, block, queue, actors: list, steps_per_block: int) -> dict:
    """An async learner's log-row entries: the fleet's collected and the
    learner's consumed env steps, which actor fed this update and how many
    versions stale its block was, the queue's depth and drops, the
    learner's idle seconds waiting on the queue, and per actor its
    cumulative collect seconds and blocks pushed."""
    qs = queue.stats()
    row = {
        "env_steps": sum(a.steps_collected for a in actors),
        "consumed_env_steps": (it + 1) * steps_per_block,
        "block_actor": block.actor_id,
        "block_staleness": max(it - block.version, 0),
        "queue_depth": qs["depth"],
        "queue_drops_full": qs["drops_full"],
        "queue_drops_stale": qs["drops_stale"],
        "learner_idle_s": qs["learner_idle_s"],
    }
    for a in actors:
        row[f"collect_s_{a.actor_id}"] = a.collect_s
        row[f"blocks_{a.actor_id}"] = a.blocks_pushed
    return row


@dataclasses.dataclass
class AsyncHostCheckpoint:
    """An async learner's checkpoint: the device state (the net and its
    Adam state; on the device plane also the ring's quantizer stats,
    `ring_quant`), the trainer's generator, and EVERY actor pool's
    normalizer state by actor index (each actor's pool runs its own
    statistics)."""

    generator: torch.Generator
    device_state: dict[str, Any]
    pools: dict[str, dict[str, torch.Tensor]]


def ring_quant_tensors(tree: dict) -> dict:
    """`DeviceTrajRing.quant_host()` as tensors of the same dtypes."""
    return {name: {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
            for name, st in tree.items()}


def ring_quant_tree(tensors: dict) -> dict:
    """The inverse of `ring_quant_tensors`, for `install_quant`."""
    return {name: {k: t.numpy() for k, t in st.items()} for name, st in tensors.items()}


def async_host_ckpt_state(pools, generator: torch.Generator, **device_state) -> AsyncHostCheckpoint:
    """The checkpoint state of an async learner. The learner's thread reads
    the pools' stats while actors may be mid-block: each leaf is rebound
    (never written in place) by an update, so a read is at worst one batch
    stale per leaf."""
    return AsyncHostCheckpoint(generator=generator, device_state=device_state,
                               pools={str(i): pool_tensors(p.get_state())
                                      for i, p in enumerate(pools)})


def async_host_maybe_save(ckpt, it: int, save_every: int, num_iterations: int, pools,
                          metrics: dict, generator: torch.Generator, data_plane: str = "host",
                          **device_state) -> None:
    """`host_maybe_save` over the whole fleet's pools (`it` is the 1-based
    count of consumed blocks). The metrics file records the fleet's size
    and the data plane, which a resume checks before the restore."""
    if ckpt is None or not should_save(it, save_every, num_iterations):
        return
    with telemetry.span("checkpoint", step=it):
        metrics = {
            **{k: float(v) for k, v in (metrics or {}).items()},
            "_pool_scale_actions": float(getattr(pools[0], "scales_actions", False)),
            "_async_actors": float(len(pools)),
            "_data_plane_device": float(data_plane == "device"),
        }
        ckpt.save(it, async_host_ckpt_state(pools, generator, **device_state), metrics)


def async_host_resume(ckpt, template: AsyncHostCheckpoint, pools,
                      data_plane: str = "host") -> tuple[Optional[AsyncHostCheckpoint], int]:
    """Restore the latest async checkpoint into `template` in place and push
    every actor pool's normalizer state back; (None, 0) when nothing is
    saved. The fleet size (`--async-actors`) and the data plane must be the
    checkpoint's: each pool's stats belong to its own actor's envs, and
    the device plane's checkpoint holds the ring's stats."""
    step = ckpt.latest_step()
    if step is None:
        return None, 0
    saved_metrics = ckpt.restore_metrics(step)
    saved_actors = saved_metrics.get("_async_actors")
    if saved_actors is not None and int(saved_actors) != len(pools):
        raise ValueError(
            f"checkpoint carries {int(saved_actors)} actor-pool states but this run has "
            f"{len(pools)} actors — resume with the original --async-actors count")
    saved_plane = saved_metrics.get("_data_plane_device", 0.0)
    if bool(saved_plane) != (data_plane == "device"):
        saved_name = "device" if saved_plane else "host"
        raise ValueError(
            f"checkpoint was written by a --data-plane {saved_name} run but this run uses "
            f"--data-plane {data_plane} — the save trees differ (the device plane checkpoints "
            "its ring's quantizer stats); resume with the original flag")
    ckpt.restore(template, step)
    saved_scale = saved_metrics.get("_pool_scale_actions")
    for i, pool in enumerate(pools):
        restored = pool_state(template.pools[str(i)])
        pool.set_state(restored)
        _warn_restore_mismatch(restored, pool, saved_scale)
    return template, step


def off_policy_train_host_async(
    pools,
    cfg,
    num_iterations: int,
    *,
    init_learner: Callable,
    make_ingest_update: Callable,
    make_host_explore: Callable,
    make_host_greedy: Optional[Callable] = None,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    eval_every: int = 0,
    eval_envs: int = 4,
    eval_steps: int = 1000,
    queue_depth: int = 4,
    max_staleness: Optional[int] = None,
    data_plane: str = "host",
    plane_codec: str = "fp32",
    transfer_pad_s: float = 0.0,
    device="cuda",
    iteration_hook: Optional[Callable[[int, HostRun], None]] = None,
    publish_hook: Optional[Callable[[int, Any], None]] = None,
    gate: Optional[threading.Event] = None,
):
    """The async actor-learner loop of the off-policy trainers (DDPG/TD3,
    SAC): replay absorbs the behaviour policy's staleness (every consumed
    block lands in the ring, and updates sample it uniformly), so only the
    ingest's hand-off goes through the queue.

    One actor thread per pool explores through the numpy mirror
    (`make_host_explore(spec, cfg)`, parameters refreshed from the
    `PolicyPublisher` once a block) and pushes [K, E_a] transition blocks;
    this (learner) thread takes each block and runs the ingest + J updates
    (`make_ingest_update(action_dim, cfg)`, as `off_policy_train_host`),
    one CUDA graph on the card from the third block, with the FLEET's
    collected env-step count as the gate's input. `max_staleness` defaults
    to None: a stale block is still valid off-policy experience. Each actor
    warms up on uniform actions for its share (warmup_steps / A) of the
    warm-up: the mirror's gate sees the actor's own step count times A.
    `num_iterations` counts consumed blocks. No checkpoints here (as in
    JAX).

    `data_plane="device"`: actors stage encoded blocks in a
    `DeviceTrajRing` (codec `plane_codec`), and the update gathers and
    decodes the slot, writes it into the replay ring and updates
    (`device_replay.make_device_ingest_update`): the learner copies no block
    to the card. `publish_hook(it, np_params)` (serve-while-training) is
    called right after block `it`'s publish with the publisher's frozen copy
    of the actor, and once after the last block with the final actor (`it`
    = `num_iterations`). `gate`, as `ppo.train_host_async`'s, is cleared
    while the update runs eagerly or is captured (under a warm-up plan,
    once, before the actors start). Returns (learner, history)."""
    import threading

    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.algos.traj_queue import (
        ActorService,
        PolicyPublisher,
        consume_block,
        validate_pools,
    )
    from actor_critic_tpu_torch.data_plane import device_replay

    spec, E_a = validate_pools(pools)
    A = len(pools)
    device = resolve_device(device)
    if data_plane not in DATA_PLANES:
        raise ValueError(f"data_plane must be 'host' or 'device', got {data_plane!r}")
    generator = torch.Generator(device=device).manual_seed(seed)
    learner = init_learner(spec.obs_shape, spec.action_dim, cfg,
                           torch.Generator().manual_seed(seed), device)
    np_params = host_actor.mirror_params(learner.actor)
    if not host_actor.supports_mirror(np_params):
        raise ValueError("async actor-learner mode needs the numpy actor mirror (MLP torso; "
                         "models/host_actor.py)")
    host_explore = make_host_explore(spec, cfg)

    def actor_act_factory(actor_id: int):
        # Read and written on that actor's thread only; times A it stands for
        # the fleet's count, so the mirror's warm-up gate hands each actor
        # its 1/A share of the uniform warm-up.
        counter = {"steps": 0}

        def make_act_fn(actor_params, rng):
            def act(o):
                action = host_explore(actor_params, o, rng, counter["steps"] * A)
                counter["steps"] += np.asarray(o).shape[0]
                return action, {}

            return act

        return make_act_fn

    queue = make_async_queue(
        data_plane, queue_depth, max_staleness, "drop_oldest",
        block_spec=device_replay.offpolicy_block_spec(spec, cfg, A), codec=plane_codec,
        transfer_pad_s=transfer_pad_s, device=device)
    ingest_update = make_ingest_update(spec.action_dim, cfg)
    feed = AsyncFeed(queue, cfg.steps_per_iter, device, transfer_pad_s)
    if feed.device_plane:
        device_ingest = device_replay.make_device_ingest_update(ingest_update, queue.codecs)
        env_steps_t = feed.scalar("env_steps")

        def body() -> dict[str, torch.Tensor]:
            return device_ingest(learner, queue.state, queue.slot_index, env_steps_t, generator)
    else:

        def body() -> dict[str, torch.Tensor]:
            b = feed.buffers.static
            traj = OffPolicyTransition(obs=b["obs"], action=b["action"], reward=b["reward"],
                                       next_obs=b["final_obs"], terminated=b["terminated"],
                                       done=b["done"])
            return ingest_update(learner, traj, b["env_steps"], generator)

    publisher = PolicyPublisher(np_params, version=0)
    stop, gate = threading.Event(), gate if gate is not None else threading.Event()
    gate.set()
    actors = [
        ActorService(i, pool, queue, publisher, cfg.steps_per_iter, actor_act_factory(i),
                     rng=np.random.default_rng(seed + 0x5EED + i * 7919), stop=stop, gate=gate)
        for i, pool in enumerate(pools)
    ]
    eval_pool = eval_act = None
    if eval_every > 0 and make_host_greedy is not None:
        eval_pool = pools[-1].eval_pool(eval_envs)
        eval_act = greedy_eval_act(learner.actor, None, make_host_greedy(spec, cfg), device)

    snapshot = host_actor.MirrorSnapshot(learner.actor, pin=device.type == "cuda")
    update = HostUpdate(body, generator, capture_error_mode="thread_local",
                        name=f"{offpolicy_name(cfg)}.async_update",
                        carried=lambda: named_carried({"learner": learner, "block": (
                            feed.buffers.static if feed.buffers is not None else queue.state)},
                            ""))
    clock = IterationClock(device)
    run = HostRun(feed.buffers, snapshot, update, {"learner": learner}, clock, queue, gate)
    # Captured before the actors start: the gate is not cleared for it once
    # training runs.
    warm_update("device_replay.make_device_ingest_update" if feed.device_plane
                else f"{offpolicy_name(cfg)}.make_host_ingest_update",
                update, feed.buffers, offpolicy_block_fields(spec, cfg, A), gate)
    history: list = []
    metrics: dict = {}
    trackers = MergedEpisodeTracker([a.tracker for a in actors])
    gauge = register_replay_gauge(learner, cfg)
    try:
        for a in actors:
            a.start()
        for it in range(num_iterations):
            telemetry.profiler_tick()
            check_actors(actors)
            with telemetry.span("iteration", it=it + 1):
                queue.set_consumer_version(it)
                with telemetry.span("queue_wait", it=it + 1):
                    block = consume_block(queue, actors)
                clock.start(("wait_s", "dispatch_s"))
                t0 = time.perf_counter()
                wait0 = feed.wait_s
                clock.mark()
                stage_block(feed, block, env_steps=sum(a.steps_collected for a in actors))
                clock.mark()
                # The actors' next parameters: this update's input, copied in
                # stream order before its replay.
                snapshot.enqueue()
                with telemetry.span("update", dispatch="async"):
                    metrics = run_updates(update, 1, gate)
                clock.mark()
                if iteration_hook is not None:
                    iteration_hook(it + 1, run)
                feed.done(block)
                waited = feed.wait_s - wait0
                clock.add("dispatch_s", time.perf_counter() - t0 - waited)
                clock.add("wait_s", waited + publish_snapshot(snapshot, publisher, it))
                if publish_hook is not None:
                    publish_hook(it, publisher.get()[1])
                extra = async_row(it, block, queue, actors, cfg.steps_per_iter * E_a)
                if eval_pool is not None and (it + 1) % eval_every == 0:
                    extra.update(timed_eval(eval_pool, eval_act(), eval_steps))
                maybe_log(it, log_every, metrics, trackers, history, log_fn, extra=extra,
                          num_iterations=num_iterations,
                          force="eval_return" in extra or it == 0, clock=clock)
        if publish_hook is not None:
            publish_hook(num_iterations, host_actor.mirror_params(learner.actor))
    finally:
        sampler.unregister_gauge(gauge)
        stop_actors(stop, actors, queue)
        if eval_pool is not None:
            eval_pool.close()
    return learner, history
