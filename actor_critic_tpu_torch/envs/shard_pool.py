"""Sharded multi-process host env pool (counterpart of
`actor_critic_tpu/envs/shard_pool.py`).

`HostEnvPool`'s gym backend steps E envs serially in one SyncVectorEnv, so
one slow simulator step stalls the batch. `ShardedVecEnv` shards the E
envs over W worker processes, each with its own `gym.make` stack in a
per-shard SyncVectorEnv with SAME_STEP auto-reset, so step, reset and
final_obs mean what they mean in the one-process pool. A step moves
through preallocated shared memory:

    parent:   actions → shm, one "step" to every worker
    worker w: SyncVectorEnv.step(act[lo:hi]) → obs / reward / terminated /
              truncated / final_obs written into shm[lo:hi]
    parent:   barrier (one answer from every worker) → the batch's outputs

One broadcast and one barrier a step; observations never go through
pickle. Seeding is over GLOBAL env indices: worker w seeds its envs with
seed+lo .. seed+hi-1, the list one big SyncVectorEnv.reset(seed) derives,
so a sharded pool gives the one-process pool's trajectories bit for bit
at fixed seeds.

Workers are SPAWNED, not forked (the parent may hold CUDA state and
threads, which a fork does not carry safely), with `CUDA_VISIBLE_DEVICES`
emptied in their environment: a worker steps numpy envs and never touches
the card. Spawn's caveat: the script that builds a pool must be
import-safe (the pool built under `if __name__ == "__main__"` or inside a
function); `train.py`, `chip_smoke.py` and pytest are.

A worker's crash (an env exception or the process dying) surfaces as a
`RuntimeError` from the pending barrier, never as a hang. Telemetry: each
worker buffers one span record a step (a bounded deque), relayed once per
collection block (`drain_telemetry`, called by `host_loop.host_collect`)
into the session's spans.jsonl under the worker's real pid; per-worker
busy seconds accumulate in a shared stats block behind `worker_stats()`
and the pool-utilization gauge (`telemetry/sampler.py::register_gauge`).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
from typing import Any, Optional

import numpy as np


def make_host_env(env_id: str, env_kwargs: dict, pixel_preprocess: bool = False):
    """One gym env exactly as the pool's gym backend builds it (the
    in-process SyncVectorEnv, the workers and the parent's space probe all
    see the same spaces and wrappers)."""
    import gymnasium as gym

    e = gym.make(env_id, **env_kwargs)
    if pixel_preprocess:
        from actor_critic_tpu_torch.envs.pixel_wrappers import PixelPreprocess

        e = PixelPreprocess(e)
    return e


def shard_bounds(num_envs: int, workers: int) -> list[tuple[int, int]]:
    """[lo, hi) global env-index range per worker; the remainder goes to
    the first shards, so sizes differ by at most one."""
    base, extra = divmod(num_envs, workers)
    bounds, lo = [], 0
    for w in range(workers):
        hi = lo + base + (1 if w < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _shared_raw(ctx, dtype: np.dtype, shape: tuple[int, ...]):
    """An anonymous shared-memory block for (dtype, shape): a RawArray,
    passed to spawned children as a Process argument, with no named
    segment to leak."""
    n = max(int(np.prod(shape)), 1) * np.dtype(dtype).itemsize
    return ctx.RawArray("b", n)


def _np_view(raw, dtype: np.dtype, shape: tuple[int, ...]) -> np.ndarray:
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


# A worker's telemetry ring: one (epoch start, seconds) record a step, sent
# to the parent on "drain". Bounded, so a run without telemetry (which never
# drains) holds at most this many records a worker.
_TELEMETRY_RING = 4096

# The relayed records' phase name (a canonical phase, telemetry/spans.py).
_WORKER_PHASE = "env_step_worker"


def _worker_main(conn, wid, env_id, env_kwargs, pixel_preprocess, lo, hi, raw, specs):
    """A worker's loop: its own gym stack, commands in, shm slices out. An
    exception goes back as ("error", traceback), which the parent raises at
    the barrier."""
    import traceback
    from collections import deque

    try:
        from gymnasium.vector import AutoresetMode, SyncVectorEnv

        views = {k: _np_view(raw[k], *specs[k]) for k in raw}
        n = hi - lo
        envs = SyncVectorEnv(
            [(lambda: make_host_env(env_id, env_kwargs, pixel_preprocess)) for _ in range(n)],
            autoreset_mode=AutoresetMode.SAME_STEP,
        )
        stats = views["stats"]
        tel: deque = deque(maxlen=_TELEMETRY_RING)
        tel_dropped = 0
        while True:
            cmd, payload = conn.recv()
            if cmd == "reset":
                obs, _ = envs.reset(seed=payload)
                views["obs"][lo:hi] = obs
                conn.send(("ok", None))
            elif cmd == "drain":
                # The buffered records (time.time() starts: one clock for
                # every process of the host) and a fresh buffer.
                conn.send(("ok", {"records": list(tel), "dropped": tel_dropped}))
                tel.clear()
                tel_dropped = 0
            elif cmd == "step":
                t_epoch = time.time()
                t0 = time.perf_counter()
                obs, rew, term, trunc, info = envs.step(np.array(views["act"][lo:hi]))
                views["obs"][lo:hi] = obs
                views["reward"][lo:hi] = rew
                views["terminated"][lo:hi] = term
                views["truncated"][lo:hi] = trunc
                # A dense final_obs slice (the pre-reset row where an
                # episode ended, obs elsewhere): the native engine's form, so
                # the parent never unpacks gymnasium's object array.
                final = views["final_obs"]
                final[lo:hi] = obs
                fos = info.get("final_obs")
                if fos is not None:
                    for j, fo in enumerate(fos):
                        if fo is not None:
                            final[lo + j] = fo
                dt = time.perf_counter() - t0
                stats[wid, 0] += dt  # busy seconds
                stats[wid, 1] += n   # env steps
                stats[wid, 2] = dt   # the last step's wall
                if len(tel) == tel.maxlen:
                    tel_dropped += 1
                tel.append((t_epoch, dt))
                conn.send(("ok", None))
            elif cmd == "close":
                envs.close()
                conn.send(("ok", None))
                return
    except (EOFError, KeyboardInterrupt):
        return  # the parent went away
    except Exception:
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:
            pass


class ShardedVecEnv:
    """E gym envs sharded over W spawned workers behind the SyncVectorEnv
    surface `HostEnvPool` uses (`single_*_space`, `reset(seed=...)`,
    `step(actions) -> (obs, reward, term, trunc, info)`, `close()`).

    `info["final_obs"]` is a dense [E, ...] array in the env's obs dtype
    (the native engine's form), right for the envs that did not end too."""

    def __init__(
        self,
        env_id: str,
        num_envs: int,
        workers: int,
        env_kwargs: Optional[dict] = None,
        pixel_preprocess: bool = False,
        step_timeout_s: float = 300.0,
        worker_env_kwargs: Optional[list[Optional[dict]]] = None,
    ):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if workers > num_envs:
            raise ValueError(
                f"workers={workers} exceeds num_envs={num_envs}; an empty "
                "shard would idle a whole process")
        self.num_envs = E = int(num_envs)
        self.num_workers = W = int(workers)
        env_kwargs = dict(env_kwargs or {})
        # Per-worker constructor overrides over env_kwargs (a sleep-padded
        # straggler among fast shards). They must not change the spaces: the
        # parent probes one env with the base kwargs and sizes every block
        # from it.
        if worker_env_kwargs is not None and len(worker_env_kwargs) != W:
            raise ValueError(
                f"worker_env_kwargs has {len(worker_env_kwargs)} entries "
                f"for workers={W}; need exactly one (or None) per worker")
        self._worker_env_kwargs = [
            {**env_kwargs, **(worker_env_kwargs[w] or {})}
            if worker_env_kwargs is not None else env_kwargs
            for w in range(W)
        ]
        self._step_timeout_s = float(step_timeout_s)

        probe = make_host_env(env_id, env_kwargs, pixel_preprocess)
        self.single_observation_space = probe.observation_space
        self.single_action_space = probe.action_space
        probe.close()
        obs_space = self.single_observation_space
        obs_dtype = np.dtype(obs_space.dtype)
        if hasattr(self.single_action_space, "n"):
            act_spec = (np.dtype(np.int64), (E,))
        else:
            # HostEnvPool hands over clipped or scaled float32 Box actions.
            act_spec = (np.dtype(np.float32), (E, *self.single_action_space.shape))
        specs: dict[str, tuple[np.dtype, tuple[int, ...]]] = {
            "act": act_spec,
            "obs": (obs_dtype, (E, *obs_space.shape)),
            "final_obs": (obs_dtype, (E, *obs_space.shape)),
            "reward": (np.dtype(np.float64), (E,)),
            "terminated": (np.dtype(np.bool_), (E,)),
            "truncated": (np.dtype(np.bool_), (E,)),
            "stats": (np.dtype(np.float64), (W, 3)),
        }
        ctx = mp.get_context("spawn")
        raw = {k: _shared_raw(ctx, dt, shp) for k, (dt, shp) in specs.items()}
        self._views = {k: _np_view(raw[k], *specs[k]) for k in specs}
        self._bounds = shard_bounds(E, W)
        self._conns: list[Any] = []
        self._procs: list[Any] = []
        # A spawned child inherits os.environ at its start: no card for the
        # workers, whatever the parent holds.
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for w, (lo, hi) in enumerate(self._bounds):
                parent_conn, child_conn = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main,
                    args=(child_conn, w, env_id, self._worker_env_kwargs[w],
                          pixel_preprocess, lo, hi, raw, specs),
                    daemon=True,
                    name=f"env-shard-{w}",
                )
                proc.start()
                child_conn.close()
                self._conns.append(parent_conn)
                self._procs.append(proc)
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        self._closed = False
        self._gauge_prev = (time.monotonic(), 0.0)
        self._gauge_last_util = 0.0
        # The gauge integrates a rate for two readers (the sampler's thread
        # and every /metrics scrape), so its read-modify-write is locked.
        self._gauge_lock = threading.Lock()
        from actor_critic_tpu_torch.telemetry import sampler

        self._gauge_name = sampler.register_gauge("host_pool", self._gauge)

    # -- parent ⇄ worker ---------------------------------------------------
    def _death_msg(self, w: int) -> str:
        rc = self._procs[w].exitcode
        return (f"env worker {w} died (exitcode={rc}) — the sharded pool is "
                "unusable; checkpoint-restart the run")

    def _send(self, w: int, msg) -> None:
        try:
            self._conns[w].send(msg)
        except (BrokenPipeError, OSError):
            raise RuntimeError(self._death_msg(w)) from None

    def _await(self, w: int):
        conn, proc = self._conns[w], self._procs[w]
        deadline = time.monotonic() + self._step_timeout_s
        while True:
            try:
                if conn.poll(0.2):
                    kind, payload = conn.recv()
                    if kind == "error":
                        raise RuntimeError(f"env worker {w} crashed:\n{payload}")
                    return payload
            except (EOFError, ConnectionResetError, OSError):
                raise RuntimeError(self._death_msg(w)) from None
            if not proc.is_alive() and not conn.poll(0.2):
                raise RuntimeError(self._death_msg(w))
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"env worker {w} gave no answer within "
                    f"{self._step_timeout_s:.0f}s (simulator wedged?)")

    def _barrier(self) -> None:
        for w in range(self.num_workers):
            self._await(w)

    # -- SyncVectorEnv surface ---------------------------------------------
    def reset(self, seed=None, options=None):
        if isinstance(seed, int):
            # SyncVectorEnv's int → list rule over GLOBAL indices: the
            # layout of the shards never changes which env gets which seed.
            seeds = [seed + i for i in range(self.num_envs)]
        elif seed is None:
            seeds = [None] * self.num_envs
        else:
            seeds = list(seed)
        for w, (lo, hi) in enumerate(self._bounds):
            self._send(w, ("reset", seeds[lo:hi]))
        self._barrier()
        return self._views["obs"].copy(), {}

    def step(self, actions: np.ndarray):
        self._views["act"][:] = actions
        for w in range(self.num_workers):
            self._send(w, ("step", None))
        self._barrier()
        v = self._views
        # Copies: callers keep a step's outputs across the next one, and the
        # blocks are rewritten in place.
        return (v["obs"].copy(), v["reward"].copy(), v["terminated"].copy(),
                v["truncated"].copy(), {"final_obs": v["final_obs"].copy()})

    def close(self) -> None:
        # Test-and-set under the lock: a teardown and an unwinding exception
        # path may both close.
        with self._gauge_lock:
            if self._closed:
                return
            self._closed = True
        from actor_critic_tpu_torch.telemetry import sampler

        sampler.unregister_gauge(self._gauge_name)
        for conn in self._conns:
            try:
                conn.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass

    # -- telemetry -----------------------------------------------------------
    def drain_telemetry(self) -> int:
        """Relay every worker's buffered step records into the installed
        session's spans.jsonl under the worker's real pid (a Perfetto lane
        a worker process). Called by `host_collect` once a collection block;
        returns the records merged (0 without a session)."""
        from actor_critic_tpu_torch import telemetry

        s = telemetry.current()
        if s is None or self._closed:
            return 0
        # Every worker's answer is read before anything is written: a write
        # that fails midway must not leave a "drain" answer in a pipe, where
        # the next step's barrier would take it for its own.
        for w in range(self.num_workers):
            self._send(w, ("drain", None))
        payloads = [self._await(w) for w in range(self.num_workers)]
        batch = []
        for w, (lo, hi) in enumerate(self._bounds):
            payload = payloads[w]
            pid = self._procs[w].pid
            s.tracer.name_process(pid, f"env-shard-{w}")
            args = {"worker": w, "envs": hi - lo}
            batch.extend((_WORKER_PHASE, t_epoch, dur, pid, 0, args)
                         for t_epoch, dur in payload["records"])
            if payload["dropped"]:
                telemetry.event("worker_telemetry_dropped", worker=w,
                                dropped=payload["dropped"])
        s.tracer.complete_foreign_many(batch)
        return len(batch)

    def worker_stats(self) -> list[dict]:
        stats = self._views["stats"]
        return [
            {
                "worker": w,
                "envs": hi - lo,
                "busy_s": round(float(stats[w, 0]), 4),
                "env_steps": int(stats[w, 1]),
                "last_step_s": round(float(stats[w, 2]), 6),
            }
            for w, (lo, hi) in enumerate(self._bounds)
        ]

    # Reads closer together than this reuse the last utilization rather than
    # measure a sliver of a second.
    _GAUGE_MIN_WINDOW_S = 1.0

    def _gauge(self) -> dict:
        """The pool-utilization row of the sampler and of /metrics: the busy
        share of the workers over the window since the last window-resetting
        read (whether the pool or the card bounds the run)."""
        stats = self._views["stats"]
        busy = float(stats[:, 0].sum())
        with self._gauge_lock:
            now = time.monotonic()
            prev_t, prev_busy = self._gauge_prev
            dt = now - prev_t
            if dt >= self._GAUGE_MIN_WINDOW_S:
                util = (busy - prev_busy) / (dt * self.num_workers)
                self._gauge_last_util = round(min(max(util, 0.0), 1.0), 4)
                self._gauge_prev = (now, busy)
            util = self._gauge_last_util
        return {
            "workers": self.num_workers,
            "num_envs": self.num_envs,
            "env_steps": int(stats[:, 1].sum()),
            "busy_s": round(busy, 3),
            "utilization": util,
        }
