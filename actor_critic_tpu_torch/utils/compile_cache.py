"""The warm-up registry and the kernel build cache (the port's counterpart
of `actor_critic_tpu/utils/compile_cache.py`).

JAX compiles one XLA program per jitted entry point, and its registry
moves those compiles ahead of the first iteration. On the card the port's
counterpart of a compile is three things, and this module moves all three
ahead of the first iteration:

1. **The builds** (the build cache): `nvcc` for the kernel libraries of
   `csrc/` (`_build.py`) and `g++` for the C++ env engine (`native/`),
   each keyed by a hash of its sources and flags into a cache directory
   (`enable_persistent_cache`: `<dir>/kernels`, `<dir>/native`). A
   library already there is a hit, recorded as a `compile` event with
   `cache_hit` (`cache_stats` counts them). `resolve_cache_dir` is the
   `--compile-cache-dir` policy: `auto` keeps the checkout's `build/`
   (already keyed by source hash and shared by every run), a path moves
   the cache there, and `none`/`off`/`""` builds into a fresh temporary
   directory removed at exit (`fresh_cache_dir`): a cold start on
   purpose.

2. **The warm-up registry** (`register_warmup`, `plan_warmup`,
   `WarmupRunner`): every capture site of the port belongs to an entry
   registered under JAX's name (`a2c.make_train_step`,
   `ppo.make_async_update_step`, `engine.make_act_program`, ...), whose
   planner decides with JAX's rules whether the entry runs under a
   `WarmupContext` and returns its `Warmup`. An entry has two parts:
   - its build part (the libraries its path launches, and g++ for a
     `native:` pool), which `WarmupRunner` runs on a daemon thread
     started as soon as the CLI has resolved the preset, so that it
     overlaps the pool's construction, the restore and the state's
     allocation (the compilers are subprocesses: they hold no GIL);
   - its capture part: the side-stream eager warm-up a capture needs,
     with the live state bitwise the same afterwards, then the capture.
     It runs where the live objects exist, before their first call: the
     owner (`algos/loop.py::fused_train_loop`, `host_loop.HostUpdate`,
     `common.BlockedEval`, `serving/engine.PolicyEngine.warm`) hands it to
     `capture_part(entry, fn)`, which runs it only when the active plan
     names the entry. The capture stays one `compile` event, and the
     entry's `warmup_compile` event names it.
   A warmed run's loop therefore records no capture, and its first
   iteration is already a replay. The port's products are the live
   graphs themselves, so, unlike JAX's (whose AOT executables reach the
   loop only through its persistent cache), the warm-up runs whether or
   not a cache directory resolves. A planner's or an entry's error is
   contained as JAX's is (a stderr line and a `warmup_plan_error` or
   `warmup_compile` event with `error`): the owner's first call then
   builds or captures as it does without the warm-up, and a failure
   there raises.

3. **Shape stabilization**: `bucket_size` and `pad_to_bucket` (the
   serving engine's buckets). The chunked loop's two graphs (the full
   chunk and the one-step graph a partial chunk replays) are
   `algos/loop.py`'s; `fused_graphs` is JAX's rule for which of them a
   run captures.

JAX names with no counterpart here: `ensure_cache_stats_listener` (the
port's builds record their own hits), `make_chunked_step` (the loop's
`CapturedStep`s), `fused_step_thunk` and `fused_eval_thunk` (the planners
of `register_fused_warmups`; the step's graph rule is `fused_graphs`) and
the abstract-shape helpers (`key_struct`, `aot_compile`, ...): a capture
needs the live tensors, not their shapes.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, ClassVar, Optional

# ---------------------------------------------------------------------------
# The build cache
# ---------------------------------------------------------------------------

# The checkout's `build/` (listed in .gitignore): the cache of every run
# that names no other.
DEFAULT_DIR = Path(__file__).resolve().parent.parent.parent / "build"

_cache_dir: Path = DEFAULT_DIR
_enabled_dir: Optional[str] = None


def cache_path(kind: str) -> Path:
    """The directory the `kind` libraries ("kernels", "native") are built
    into and looked up in: `<cache dir>/<kind>`."""
    return _cache_dir / kind


def cache_stats() -> dict:
    """{'hits', 'misses'} of the build cache in this process: the builds
    that found their library (`compile` events with `cache_hit`) and those
    that ran a compiler."""
    from actor_critic_tpu_torch.telemetry import profiler

    return profiler.build_cache_counts()


def enabled_dir() -> Optional[str]:
    """The cache directory this process enabled, or None."""
    return _enabled_dir


def enable_persistent_cache(cache_dir: str | os.PathLike) -> str:
    """Point the kernel libraries at `<cache_dir>/kernels` and the native
    engine at `<cache_dir>/native` (created as they are built). Returns
    the absolute directory. Libraries already loaded stay loaded; the last
    directory wins."""
    global _cache_dir, _enabled_dir
    cache_dir = os.path.abspath(os.fspath(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    _cache_dir = Path(cache_dir)
    _enabled_dir = cache_dir
    return cache_dir


def fresh_cache_dir() -> str:
    """A new empty directory for a cold start, removed when the process
    exits."""
    path = tempfile.mkdtemp(prefix="actor_critic_build_cache-")
    atexit.register(shutil.rmtree, path, True)
    return path


class temporary_cache:
    """Context manager: enable the build cache at `cache_dir`, then restore
    the previous directories on exit."""

    def __init__(self, cache_dir: str | os.PathLike):
        self._dir = cache_dir

    def __enter__(self) -> str:
        self._prev = (_cache_dir, _enabled_dir)
        return enable_persistent_cache(self._dir)

    def __exit__(self, *exc) -> None:
        global _cache_dir, _enabled_dir
        _cache_dir, _enabled_dir = self._prev


def resolve_cache_dir(cli_value: Optional[str], ckpt_dir: Optional[str]) -> Optional[str]:
    """The `--compile-cache-dir` policy: 'auto' (and no value) is the
    checkout's `build/`, already keyed by source hash and shared by every
    run (JAX's per-checkpoint sidecar would only add cold builds, so
    `ckpt_dir` does not enter); 'none'/'off'/'' is None, a fresh temporary
    directory (`fresh_cache_dir`); any other value is that path."""
    if cli_value is None or cli_value.lower() == "auto":
        return str(DEFAULT_DIR)
    if cli_value.lower() in ("", "none", "off"):
        return None
    return cli_value


# ---------------------------------------------------------------------------
# Shape stabilization
# ---------------------------------------------------------------------------

def bucket_size(n: int, buckets: tuple[int, ...]) -> int:
    """The smallest bucket >= n (buckets need not be sorted). Raises when n
    exceeds every bucket."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    fitting = [b for b in buckets if b >= n]
    if not fitting:
        raise ValueError(f"n={n} exceeds every bucket in {sorted(buckets)}")
    return min(fitting)


def pad_to_bucket(x, buckets: tuple[int, ...], axis: int = 0):
    """Zero-pad `x` along `axis` to the smallest fitting bucket size;
    returns (padded, valid_mask) where `valid_mask` is float32 [bucket]
    with 1.0 on real rows."""
    import numpy as np

    x = np.asarray(x)
    n = x.shape[axis]
    b = bucket_size(n, buckets)
    mask = np.zeros(b, np.float32)
    mask[:n] = 1.0
    if b == n:
        return x, mask
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, b - n)
    return np.pad(x, widths), mask


def fused_graphs(chunk: int, iterations: int, resume: bool) -> tuple[int, ...]:
    """Steps per replay of the graphs a fused run captures (JAX's
    `fused_step_thunk` rule): the one-step graph at chunk 1; else the
    `chunk`-step graph when `iterations` reaches a chunk (or is unknown,
    0), and the one-step graph when a partial chunk can occur (a resume,
    or a tail)."""
    if chunk <= 1:
        return (1,)
    out = []
    if iterations == 0 or iterations >= chunk:
        out.append(chunk)
    if resume or iterations < chunk or iterations % chunk != 0:
        out.append(1)
    return tuple(out)


# ---------------------------------------------------------------------------
# The warm-up registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WarmupContext:
    """Everything a planner needs to decide whether its entry runs in THIS
    run: JAX's fields (the resolved algo, env and config, and the CLI knobs
    that change which graphs a run captures), plus the port's `device`
    ("cuda" builds the kernels the path launches; "cpu" builds none and
    captures nothing) and `native` (the host pool is the C++ engine's:
    its g++ build joins the host entries' build part). `spec` and `env`
    may be None where the pool does not exist yet: no planner needs them
    before it runs."""

    algo: str            # resolved preset algo (td3/a3c keep their alias)
    fused: bool          # a fused trainer vs a host pool
    spec: Any            # EnvSpec, or None before the pool exists
    cfg: Any             # the algo's frozen config dataclass
    env: Any = None      # the TorchEnv (fused runs only)
    chunk: int = 1       # --chunk (fused runs)
    iterations: int = 0  # --iterations (tail-chunk prediction)
    eval_every: int = 0  # --eval-every (eval graphs only if on)
    eval_envs: int = 4   # --eval-envs (host eval pool batch)
    overlap: bool = True  # host loops: numpy actor mirror enabled
    resume: bool = False  # --resume (realignment chunks possible)
    async_actors: int = 0
    async_correction: str = "vtrace"
    data_plane: str = "host"
    plane_codec: str = "fp32"
    queue_depth: int = 4
    # Non-empty: a SERVING context (plan_warmup runs only the serving
    # planners).
    serving_buckets: tuple[int, ...] = ()
    serving_sample: bool = False
    device: str = "cuda"
    native: bool = False


@dataclasses.dataclass(frozen=True)
class Warmup:
    """A plan entry's work. Calling it runs the build part on the runner's
    thread: `kernels` (the `csrc/` libraries the entry's path launches)
    through `_build.build`, and with `native` the C++ env engine through
    `native.load`. Every entry of the port also has a capture part
    (`captures`), which its owner runs through `capture_part` before the
    entry's first call; a plain callable in a plan is a build part alone."""

    captures: ClassVar[bool] = True
    kernels: tuple[str, ...] = ()
    native: bool = False

    def __call__(self) -> None:
        if self.kernels:
            from actor_critic_tpu_torch import _build

            _build.build(*self.kernels)
        if self.native:
            from actor_critic_tpu_torch import native

            native.load()


def warmup_of(ctx: WarmupContext, kernels: tuple[str, ...] = (), host: bool = False) -> Warmup:
    """The `Warmup` of an entry whose path launches `kernels` (built on the
    card only) and, for a host entry, steps the context's pool (its g++
    build where the pool is native)."""
    return Warmup(kernels=tuple(kernels) if ctx.device == "cuda" else (),
                  native=host and ctx.native)


# name -> planner(ctx) -> Optional[Warmup]. A planner returns None when
# its entry will not run under this context (wrong algo, host entry on a
# fused run, eval disabled ...) or has nothing to capture in the port.
# Populated by the register_warmup decorators at module import.
_REGISTRY: dict[str, Callable[[WarmupContext], Optional[Callable]]] = {}
# The planners of the SERVING side (register_warmup(..., serving=True)):
# plan_warmup runs exactly one side per context.
_SERVING_PLANNERS: set[str] = set()
# The modules whose import registers planners.
_REGISTERING_MODULES = (
    "actor_critic_tpu_torch.algos.a2c",
    "actor_critic_tpu_torch.algos.ppo",
    "actor_critic_tpu_torch.algos.impala",
    "actor_critic_tpu_torch.algos.ddpg",
    "actor_critic_tpu_torch.algos.sac",
    "actor_critic_tpu_torch.envs.mixture",
    "actor_critic_tpu_torch.data_plane.ring",
    "actor_critic_tpu_torch.data_plane.device_replay",
    "actor_critic_tpu_torch.serving.engine",
)

# Capture sites (`utils/warmup_lint.py` keys them "<module>.<enclosing
# top-level function or class>") and the registered entries whose capture
# part each one runs. The lint requires every capture site in algos/,
# envs/, data_plane/ and serving/ to be here, its entries registered, or
# in EXEMPT.
_FUSED = ("a2c", "ppo", "impala", "ddpg", "sac")
_EVALS = tuple(f"{m}.make_eval_fn" for m in _FUSED) + ("mixture.make_typed_eval",)
_HOST_UPDATES = ("ppo.make_host_update_step", "ppo.make_async_update_step",
                 "ppo.make_device_update_step", "ddpg.make_host_ingest_update",
                 "sac.make_host_ingest_update", "device_replay.make_device_ingest_update")
SITES: dict[str, tuple[str, ...]] = {
    "loop.fused_train_loop": tuple(f"{m}.make_train_step" for m in _FUSED),
    "loop.warm_up": tuple(f"{m}.make_train_step" for m in _FUSED),
    "host_loop.HostUpdate": _HOST_UPDATES,
    "ppo.train_host": ("ppo.make_host_update_step",),
    "ppo.train_host_async": ("ppo.make_async_update_step", "ppo.make_device_update_step"),
    "host_loop.off_policy_train_host": ("ddpg.make_host_ingest_update",
                                        "sac.make_host_ingest_update"),
    "host_loop.off_policy_train_host_async": ("ddpg.make_host_ingest_update",
                                              "sac.make_host_ingest_update",
                                              "device_replay.make_device_ingest_update"),
    "common.BlockedEval": _EVALS,
    "common.make_net_eval": _EVALS,
    "engine._Lane": ("engine.make_act_program",),
}

# Capture sites the lint must not require an entry for, with the reason
# (JAX's EXEMPT keys of the same name).
EXEMPT: dict[str, str] = {
    "impala.make_sp_update":
        "the sequence-parallel learner over a process mesh; built only by its explicit "
        "callers (no CLI flag reaches it), outside train.py's warmup scope",
    "impala.make_sp_train_step":
        "the sequence-parallel trainer over a process mesh; built only by its explicit "
        "callers (no CLI flag reaches it), outside train.py's warmup scope",
}


def register_warmup(name: str, serving: bool = False):
    """Decorator: register `planner(ctx) -> Warmup | None` under `name`
    ("<module>.<factory>", JAX's key). `serving=True` puts it on the
    serving side of the registry."""

    def deco(planner):
        _REGISTRY[name] = planner
        if serving:
            _SERVING_PLANNERS.add(name)
        return planner

    return deco


def load_registry() -> None:
    """Import every module that registers planners (their decorators run
    at import)."""
    import importlib

    for module in _REGISTERING_MODULES:
        importlib.import_module(module)


def registered_warmups() -> tuple[str, ...]:
    load_registry()
    return tuple(sorted(_REGISTRY))


def _say(msg: str) -> None:
    print(f"[compile_cache] {msg}", file=sys.stderr, flush=True)


def _event(kind: str, **fields) -> None:
    from actor_critic_tpu_torch.telemetry import session as _session

    try:
        _session.event(kind, **fields)
    except Exception:  # noqa: BLE001 — telemetry never takes the run down
        pass


def plan_warmup(ctx: WarmupContext) -> list[tuple[str, Callable]]:
    """(name, Warmup) for every registered entry that runs under `ctx`,
    one side of the registry per context (the serving planners for a
    serving context, the training planners otherwise). A planner that
    raises is contained, but not silent: a stderr line and a
    `warmup_plan_error` event, and the entry is left out."""
    load_registry()
    serving_ctx = bool(ctx.serving_buckets)
    out: list[tuple[str, Callable]] = []
    for name in sorted(_REGISTRY):
        if (name in _SERVING_PLANNERS) != serving_ctx:
            continue
        try:
            thunk = _REGISTRY[name](ctx)
        except Exception as e:  # noqa: BLE001 — a planner never takes the run down
            _say(f"warmup planner {name!r} failed: {type(e).__name__}: {e}")
            _event("warmup_plan_error", entry=name, error=str(e)[:500])
            thunk = None
        if thunk is not None:
            out.append((name, thunk))
    return out


# The runner whose plan `capture_part` consults (at most one per process:
# the CLI's).
_active: Optional["WarmupRunner"] = None
# Called with the runner on the thread that completes its plan, right after
# its `warmup_done` event: before the first dispatch of the site that
# completed it (a caller that counts a run's kernel launches resets them
# here, so that the warm-up's own are left out).
WARMUP_DONE_HOOKS: list[Callable[["WarmupRunner"], None]] = []


def capture_part(name: str, fn: Callable[[], Any]) -> bool:
    """Run entry `name`'s capture part `fn()` on this thread, once its build
    part has run, if the active warm-up's plan names the entry and its
    capture part has not run yet; returns whether `fn` ran without error.
    False leaves the owner to build and capture at its first call, as it
    does without a warm-up."""
    runner = _active
    return runner is not None and runner.capture(name, fn)


class WarmupRunner:
    """One run's warm-up plan. `start()` runs each entry's build part on a
    daemon thread; `capture(name, fn)` (through `capture_part`) runs an
    entry's capture part on its owner's thread. Each entry then gets one
    `warmup_compile` event (`entry`, `build_s`, `capture_s`, `compile_s`
    = their sum, or `error`, or `skipped` for a capture site the run never
    reached) and the plan one `warmup_done` event (`entries`, `errors`,
    `total_s`), after which `done` is set and the `WARMUP_DONE_HOOKS` run.
    `close()` ends the plan at the end of the run."""

    def __init__(self, plan: list[tuple[str, Callable]]):
        self._plan = list(plan)
        self.results: list[dict] = []
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._built = {name: threading.Event() for name, _ in self._plan}
        self._rows: dict[str, dict] = {}
        self._pending = {name for name, thunk in self._plan if getattr(thunk, "captures", False)}
        self._thread = threading.Thread(target=self._run, name="warmup", daemon=True)

    def start(self) -> "WarmupRunner":
        global _active
        _active = self
        self._thread.start()
        return self

    def _run(self) -> None:
        for name, thunk in self._plan:
            t0 = time.perf_counter()
            row = {"entry": name}
            try:
                thunk()
                row["build_s"] = round(time.perf_counter() - t0, 4)
            except Exception as e:  # noqa: BLE001 — the owner's first call builds instead
                row["error"] = f"{type(e).__name__}: {e}"[:500]
                _say(f"warmup entry {name!r} failed to build: {row['error']}")
            with self._lock:
                waiting = name in self._pending and "error" not in row
                if waiting:
                    self._rows[name] = row
                else:
                    self._pending.discard(name)
            self._built[name].set()
            if not waiting:
                self._complete(row)
        if not self._plan:
            self._finish()

    def capture(self, name: str, fn: Callable[[], Any]) -> bool:
        with self._lock:
            if name not in self._pending:
                return False
        self._built[name].wait()
        with self._lock:
            row = self._rows.pop(name, None)
            self._pending.discard(name)
        if row is None:
            return False
        t0 = time.perf_counter()
        try:
            fn()
            row["capture_s"] = round(time.perf_counter() - t0, 4)
        except Exception as e:  # noqa: BLE001 — the owner's first call captures instead
            row["error"] = f"{type(e).__name__}: {e}"[:500]
            _say(f"warmup entry {name!r} failed to capture: {row['error']}")
        self._complete(row)
        return "error" not in row

    def _complete(self, row: dict) -> None:
        if "error" not in row and "skipped" not in row:
            row["compile_s"] = round(row.get("build_s", 0.0) + row.get("capture_s", 0.0), 4)
        with self._lock:
            self.results.append(row)
            finished = len(self.results) == len(self._plan)
        _event("warmup_compile", **row)
        if finished:
            self._finish()

    def _finish(self) -> None:
        global _active
        _event("warmup_done", entries=len(self._plan),
               errors=sum(1 for r in self.results if "error" in r),
               total_s=round(sum(r.get("compile_s", 0.0) for r in self.results), 3))
        if _active is self:
            _active = None
        self._done.set()
        for hook in list(WARMUP_DONE_HOOKS):
            hook(self)

    def close(self) -> None:
        """End the plan: wait for the build parts, record every capture part
        the run never reached as `skipped` (a resumed run with nothing left
        to run), and stop being the active plan."""
        global _active
        if self._thread.is_alive():
            self._thread.join()
        with self._lock:
            left = sorted(self._pending)
            self._pending.clear()
            rows = [dict(self._rows.pop(name, {"entry": name}), skipped="site not reached")
                    for name in left]
        for row in rows:
            self._complete(row)
        if _active is self:
            _active = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


def start_warmup(ctx: WarmupContext) -> WarmupRunner:
    """Plan and start the warm-up of this run (a caller that prints the plan
    first uses `plan_warmup` and `WarmupRunner` itself, as the CLI does)."""
    return WarmupRunner(plan_warmup(ctx)).start()


@contextlib.contextmanager
def running(runner: Optional[WarmupRunner]):
    """`runner` (None: no warm-up) for the block, closed after it."""
    try:
        yield runner
    finally:
        if runner is not None:
            runner.close()


# -- planner helpers (shared by the per-algo registrations) -----------------

def register_fused_warmups(module: str, aliases, kernels: Callable[[Any], tuple[str, ...]]) -> None:
    """Register the two fused-trainer entries every algo shares:
    `<module>.make_train_step` (the step, captured as one graph per steps
    per replay; `kernels(cfg)` its path's kernel libraries) and
    `<module>.make_eval_fn` (the greedy eval's block graphs, when
    --eval-every is on)."""
    aliases = frozenset(aliases)

    @register_warmup(f"{module}.make_train_step")
    def _step(ctx):
        # The capture part is the loop's: `loop.warm_up` of the graphs
        # `fused_graphs` names (JAX's `fused_step_thunk` rule).
        if not ctx.fused or ctx.algo not in aliases:
            return None
        return warmup_of(ctx, kernels(ctx.cfg))

    @register_warmup(f"{module}.make_eval_fn")
    def _eval(ctx):
        if not ctx.fused or ctx.algo not in aliases or ctx.eval_every <= 0:
            return None
        return warmup_of(ctx)


def register_offpolicy_warmups(module: str, aliases) -> None:
    """Register the DDPG/TD3/SAC entry family under JAX's names: the host
    path's explore act, ingest + update and greedy act, and the fused pair.
    The port runs both host acts eagerly (the numpy mirror, or the module
    on the device at each env step), so `make_host_act_fn` and
    `make_greedy_act` have nothing to capture and plan None; the ingest +
    update is `HostUpdate`'s graph (the device plane's async runs capture
    `device_replay.make_device_ingest_update` instead)."""
    aliases = frozenset(aliases)

    @register_warmup(f"{module}.make_host_act_fn")
    def _act(ctx):
        return None  # an eager act: nothing to capture

    @register_warmup(f"{module}.make_host_ingest_update")
    def _ingest(ctx):
        if ctx.fused or ctx.algo not in aliases:
            return None
        if ctx.data_plane == "device" and ctx.async_actors:
            return None
        return warmup_of(ctx, host=True)

    @register_warmup(f"{module}.make_greedy_act")
    def _greedy(ctx):
        return None  # an eager act: nothing to capture

    register_fused_warmups(module, aliases, lambda cfg: ())
