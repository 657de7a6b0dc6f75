"""perfsan: dispatch and transfer budget sanitizer for the steady-state
programs (counterpart of `actor_critic_tpu/analysis/perfsan.py`).

The port's performance claims are contracts: the device data plane copies
no block to the card on the learner's side, a swap never re-captures a
serving graph, a fused step is one replay. perfsan runs the REAL
steady-state programs and meters four quantities per steady-state block
(`measure()`):

- **dispatches**: host-issued device work. One per program call at the
  port's program seams (a `torch.cuda.CUDAGraph.replay`, a
  `loop.CapturedStep.replay`, a `host_loop.HostUpdate` call, a serving
  lane's bucket forward `engine._Lane._forward`), whether the program
  replays a graph on the card or runs eagerly on the CPU; nothing inside a
  seam counts again. Outside the seams, every eager aten op on a tensor of
  the metered device (views and allocations launch nothing and are not
  counted), and every launch of the ctypes kernels (`ops/gae_cuda.py`,
  `ops/vtrace_cuda.py`), which bypass aten.
- **transfers and transferred bytes**: every host↔device crossing. On the
  card: `copy_` and `_to_copy` between the CPU and the card, and scalar
  reads (`_local_scalar_dense`: `.item()`, `float()`, `bool()`). On the
  CPU, where host and device memory are one, the meter draws the line
  where the port draws it, between numpy (the actors, the mirrors, the
  gateway's requests) and tensors: `torch.from_numpy` / `as_tensor` /
  `tensor` of host data, and `Tensor.numpy` / `tolist` / `.item()`, each
  count the bytes they hand across. A crossing is a transfer, not a
  dispatch (JAX's `device_put` is not an XLA execution).
- **recompiles**: `telemetry.profiler.recompile_count()`, the port's
  captures and kernel builds. On the CPU nothing is captured; there a
  program seam's call on tensors other than those of its first metered
  call (by `data_ptr`) counts one, since on the card its graph would have
  to be captured again: the first metered call of a program stands for
  its capture, so every exerciser runs its warm-up inside a discarded
  `measure()`.
- **the "disallow" guard** (JAX's `transfer_guard("disallow")`): explicit
  staging (a non-blocking copy through pinned memory on the card, a numpy
  hand-off on the CPU) is sanctioned and metered; an implicit crossing
  raises `PerfSanError`: a scalar read, a blocking copy, or a host tensor
  fed to a device op. On the card the scope also sets
  `torch.cuda.set_sync_debug_mode("error")` (process-wide, so a flight
  thread is held too), lifted inside `profiler.record_compile`, the
  funnel of every capture and build: a capture synchronizes, and is priced
  by the recompiles budget, not the guard.

A `TorchDispatchMode` sees its own thread's ops only, so the meter pushes
one on every thread that enters a program seam or a serving lane
(`engine._Lane.run`) while it is active: the micro-batcher's flight
workers are metered like the caller. `measure()` restores every seam it
patched, also when the block raises.

Each steady-state program is checked against the port's own manifest,
`actor_critic_tpu_torch/analysis/perf_budgets.json` (the root
`perf_budgets.json` is JAX's), which keeps a value per platform where the
CPU's count differs from the card's; its comment says where and why the
port's counts differ from JAX's. The eight programs (JAX's names):

    ppo_update_host     async V-trace PPO on host-plane blocks: the
                        TrajQueue block staged into pinned buffers and
                        uploaded (`host_loop.AsyncFeed`), then the update
    ppo_update_device   the same learner on a `DeviceTrajRing` (int8):
                        `ring.select` (a fill kernel) and the update's
                        replay; the actor's enqueue rides a sibling budget
    ppo_update_fused    the device plane with correction="none": GAE inside
                        the update's graph
    offpolicy_ingest    DDPG through `device_replay.make_device_ingest_update`
    serving_dispatch    `PolicyEngine.act` on warmed buckets, with a
                        mid-stream `PolicyStore.swap` from a params-only
                        checkpoint, which must not re-capture
    serving_overlap     the same act through a running `MicroBatcher` with
                        max_inflight=2 (two lanes, flight threads)
    serving_proxy_hop   one `FleetProxy` relay to a stub-engine replica:
                        all zeros
    mixture_fleet_step  the fused `cartpole,pendulum` mixture A2C step, 4
                        iterations in one captured chunk

**Reverted modes** prove the meter works, on every run: `host-gather`
copies the leased slot to the host and uploads it again inside the learner
scope (the transfers budget); `unfused` runs GAE as its own program before
the update (the dispatches budget); `uncommit` stands for JAX's swap that
skips `checkpoint.uncommit`: after the swap each lane's parameters are
rebound to new tensors (`load_state_dict(assign=True)`) instead of copied
into the addresses its graphs read, and its graphs are dropped (the
recompiles budget).

    python -m actor_critic_tpu_torch.analysis.perfsan --quick --device cpu
    python -m actor_critic_tpu_torch.analysis.perfsan --program ppo_update_device
    python -m actor_critic_tpu_torch.analysis.perfsan --revert host-gather    # exit 1

Exit codes: 0 every program within budget, 1 a violation (or a reverted
mode caught), 2 crash (a missing or malformed manifest, an unknown
program, a broken exerciser).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import weakref
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.utils._python_dispatch

PROGRAMS = (
    "ppo_update_host",
    "ppo_update_device",
    "ppo_update_fused",
    "offpolicy_ingest",
    "serving_dispatch",
    "serving_overlap",
    "serving_proxy_hop",
    "mixture_fleet_step",
)

BUDGET_KEYS = (
    "max_dispatches_per_block",
    "max_transfers_per_block",
    "max_transferred_bytes_per_block",
    "max_recompiles",
)

PLATFORMS = ("cpu", "cuda")
GUARDS = ("allow", "disallow")
REVERTS = ("host-gather", "unfused", "uncommit")

DEFAULT_MANIFEST_BASENAME = "perf_budgets.json"


class PerfSanError(RuntimeError):
    """A steady-state program exceeded its budget, an implicit crossing hit
    the guard, or a reverted mode was caught (the sanitizer working)."""


class ManifestError(PerfSanError):
    """The budget manifest itself is missing or malformed: a crash (exit
    2), never a detection."""


def default_manifest_path() -> str:
    """The port's manifest, beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), DEFAULT_MANIFEST_BASENAME)


def _budget_value(path: str, name: str, key: str, value, platform: Optional[str]):
    """A budget as an int, or per platform ({"cpu": n, "cuda": m}); resolved
    to `platform`'s int when one is given."""
    if isinstance(value, dict):
        if sorted(value) != sorted(PLATFORMS):
            raise ManifestError(f"budget manifest {path}: program {name!r} key {key!r} must be "
                                f"an int or one per platform {list(PLATFORMS)}, got "
                                f"{sorted(value)}")
        for v in value.values():
            _budget_value(path, name, key, v, None)
        return value if platform is None else value[platform]
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise ManifestError(f"budget manifest {path}: program {name!r} key {key!r} must be a "
                            f"non-negative int, got {value!r}")
    return value


def load_manifest(path: str, platform: Optional[str] = "cuda") -> dict:
    """The budget manifest's programs, each value resolved for `platform`
    ("cpu" or "cuda"; None keeps the per-platform dicts). JAX's refusals,
    each a `ManifestError`: a missing or unparsable file, no `programs`
    object, an entry that is not an object, an unknown key (a typo would
    un-gate that counter) or a missing budget key; and the port's: a
    budget that is not a non-negative int or one per platform, a guard
    other than allow/disallow."""
    if platform is not None and platform not in PLATFORMS:
        raise ManifestError(f"unknown platform {platform!r} (have: {', '.join(PLATFORMS)})")
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        raise ManifestError(f"budget manifest {path}: {e}") from e
    if not isinstance(data, dict) or not isinstance(data.get("programs"), dict):
        raise ManifestError(f"budget manifest {path}: expected "
                            "{'version': 1, 'programs': {...}}")
    allowed = set(BUDGET_KEYS) | {"transfer_guard"}
    out = {}
    for name, entry in data["programs"].items():
        if not isinstance(entry, dict):
            raise ManifestError(f"budget manifest {path}: program {name!r} entry must be an "
                                "object")
        unknown = sorted(set(entry) - allowed)
        missing = sorted(set(BUDGET_KEYS) - set(entry))
        if unknown or missing:
            raise ManifestError(
                f"budget manifest {path}: program {name!r} has "
                + (f"unknown key(s) {unknown} " if unknown else "")
                + (f"missing budget key(s) {missing}" if missing else ""))
        if entry.get("transfer_guard", "allow") not in GUARDS:
            raise ManifestError(f"budget manifest {path}: program {name!r} transfer_guard must "
                                f"be one of {list(GUARDS)}")
        out[name] = {k: (v if k == "transfer_guard"
                         else _budget_value(path, name, k, v, platform))
                     for k, v in entry.items()}
    return out


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Counters:
    """What one measured scope observed."""

    dispatches: int = 0
    transfers: int = 0
    transferred_bytes: int = 0
    recompiles: int = 0
    dispatch_names: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "transfers": self.transfers,
            "transferred_bytes": self.transferred_bytes,
            "recompiles": self.recompiles,
            "dispatch_names": dict(sorted(self.dispatch_names.items())),
        }


def worst_of(counters: Iterable[Counters]) -> Counters:
    """Component-wise max across measured blocks: the value a `max_*`
    budget gates (a block over one counter must not hide behind a sibling
    that maxed another)."""
    out = Counters()
    for c in counters:
        out.dispatches = max(out.dispatches, c.dispatches)
        out.transfers = max(out.transfers, c.transfers)
        out.transferred_bytes = max(out.transferred_bytes, c.transferred_bytes)
        out.recompiles = max(out.recompiles, c.recompiles)
        for name, n in c.dispatch_names.items():
            out.dispatch_names[name] = max(out.dispatch_names.get(name, 0), n)
    return out


# ---------------------------------------------------------------------------
# the meter
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# Ops that launch no kernel: allocations, aliases, host-side bookkeeping.
_NO_KERNEL = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.resize_.default,
    _aten.detach.default, _aten.alias.default, _aten.lift_fresh.default,
    _aten.lift_fresh_copy.default, _aten.is_pinned.default, _aten._pin_memory.default,
    _aten.record_stream.default,
}
# The CPU's numpy seams: (owner, attribute, direction).
_NUMPY_SEAMS = (
    (torch, "from_numpy", "in"),
    (torch, "as_tensor", "in"),
    (torch, "tensor", "in"),
    (torch.Tensor, "numpy", "out"),
    (torch.Tensor, "tolist", "out"),
)
# Program objects' tensor addresses at their first metered call on the CPU
# (the stand-in for what a capture on the card freezes), by program key.
# torchlint: thread-owned=meter (setdefault is one call under the GIL: two
# metered threads reaching one program get the same entry)
_CPU_CAPTURES: "weakref.WeakKeyDictionary[Any, dict]" = weakref.WeakKeyDictionary()
# torchlint: thread-owned=main (the one active meter: measure() is not
# reentrant and runs on the caller's thread)
_ACTIVE: list = []


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


def _tensors(tree) -> list[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _crosses(a: torch.device, b: torch.device) -> bool:
    """Whether data moving between `a` and `b` crosses host↔device: one side
    the CPU, the other not (the card; `meta` stands in for it in tests)."""
    return (a.type == "cpu") != (b.type == "cpu")


class _Meter:
    """The shared state of one `measure()` scope: its counters (under a lock:
    flight threads add to them), the metered device type, the guard, and
    per thread the program-seam depth and whether its dispatch mode is on."""

    def __init__(self, counters: Counters, device_type: str, guard: Optional[str]):
        self.c = counters
        self.device_type = device_type
        self.guard = guard
        self.lock = threading.Lock()
        self.tls = threading.local()
        self.lifts = 0  # open captures and builds, the card's sync check lifted meanwhile

    # -- counting ------------------------------------------------------------

    def dispatch(self, name: str) -> None:
        with self.lock:
            self.c.dispatches += 1
            self.c.dispatch_names[name] = self.c.dispatch_names.get(name, 0) + 1

    def transfer(self, nbytes: int, what: str, implicit: bool) -> None:
        if implicit and self.guard == "disallow":
            raise PerfSanError(
                f"TRANSFER GUARD: an implicit host↔device crossing ({what}, {nbytes} B) inside "
                "a 'disallow' scope — stage it explicitly (a non-blocking copy through pinned "
                "memory) or keep it off the steady-state path")
        with self.lock:
            self.c.transfers += 1
            self.c.transferred_bytes += int(nbytes)

    def recompile(self) -> None:
        with self.lock:
            self.c.recompiles += 1

    # -- threads and seams ---------------------------------------------------

    @property
    def depth(self) -> int:
        return getattr(self.tls, "depth", 0)

    def outside_seams(self) -> bool:
        """Whether work on this thread now is host-issued (not a program
        seam's body, nor a capture recording it)."""
        if self.depth > 0:
            return False
        return not (self.device_type == "cuda" and torch.cuda.is_current_stream_capturing())

    @contextlib.contextmanager
    def on_this_thread(self):
        """This meter's dispatch mode pushed on the calling thread for the
        block, unless it is on already."""
        if getattr(self.tls, "on", False):
            yield
            return
        self.tls.on = True
        try:
            with _OpMeter(self):
                yield
        finally:
            self.tls.on = False

    @contextlib.contextmanager
    def seam(self, name: str, program=None, key=None, addresses: Callable[[], tuple] = tuple):
        """One program call: a dispatch (unless nested in another seam or
        recorded by a capture), and on the CPU the capture stand-in."""
        with self.on_this_thread():
            if self.outside_seams():
                self.dispatch(name)
                if self.device_type == "cpu" and program is not None:
                    seen = _CPU_CAPTURES.setdefault(program, {})
                    sig = addresses()
                    if seen.get(key) != sig:
                        seen[key] = sig
                        self.recompile()
            self.tls.depth = self.depth + 1
            try:
                yield
            finally:
                self.tls.depth -= 1

    # -- aten ops ------------------------------------------------------------

    def observe(self, func, args, kwargs) -> None:
        if func in _NO_KERNEL or func.is_view:
            return
        packet = func.overloadpacket
        if packet is _aten.copy_:
            dst, src = args[0], args[1]
            non_blocking = bool(args[2] if len(args) > 2 else kwargs.get("non_blocking", False))
            if _crosses(src.device, dst.device):
                self.transfer(_nbytes(src), f"{func}: {src.device} -> {dst.device}",
                              implicit=not non_blocking)
                return
        elif packet is _aten._to_copy:
            src = args[0]
            dst = torch.device(kwargs.get("device") or src.device)
            if _crosses(src.device, dst):
                self.transfer(_nbytes(src), f"{func}: {src.device} -> {dst}",
                              implicit=not kwargs.get("non_blocking", False))
                return
        elif packet is _aten._local_scalar_dense:
            src = args[0]
            if src.device.type == self.device_type:
                self.transfer(src.element_size(), f"a scalar read of a {src.device} tensor "
                              "(.item(), float(), bool())", implicit=True)
            return
        tensors = _tensors((args, kwargs))
        types = {t.device.type for t in tensors}
        if kwargs.get("device") is not None:  # a factory (zeros, full, arange)
            types.add(torch.device(kwargs["device"]).type)
        if len(types) > 1 and "cpu" in types:
            host = sum(_nbytes(t) for t in tensors if t.device.type == "cpu")
            self.transfer(host, f"{func}: a host tensor fed to a device op", implicit=True)
        if self.device_type in types and self.outside_seams():
            self.dispatch(str(func))


class _OpMeter(torch.utils._python_dispatch.TorchDispatchMode):
    """The per-thread dispatch mode of a `_Meter`."""

    def __init__(self, meter: _Meter):
        super().__init__()
        self.meter = meter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.meter.observe(func, args, kwargs)
        return func(*args, **kwargs)


def _lane_addresses(lane, b: int) -> tuple:
    return (tuple(p.data_ptr() for p in lane.net.parameters()), lane.inputs[b].data_ptr())


def _seams() -> list[tuple[Any, str, Callable]]:
    """(owner, attribute, make_wrapper(original, meter)) of every seam the
    meter patches."""
    from actor_critic_tpu_torch.algos import host_loop, loop
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda
    from actor_critic_tpu_torch.serving import engine
    from actor_critic_tpu_torch.telemetry import profiler

    def program(name_of, addresses_of=None, key_of=lambda self, *a: None):
        """A program seam; with `addresses_of`, the tensors its program reads
        (the CPU's capture stand-in), by `key_of` (a lane's bucket)."""
        def make(orig, meter):
            def wrapped(self, *a, **k):
                kw = {} if addresses_of is None else dict(
                    program=self, key=key_of(self, *a), addresses=lambda: addresses_of(self, *a))
                with meter.seam(name_of(self, *a), **kw):
                    return orig(self, *a, **k)
            return wrapped
        return make

    def thread_seam(orig, meter):
        def wrapped(self, *a, **k):
            with meter.on_this_thread():
                return orig(self, *a, **k)
        return wrapped

    def kernel(name):
        def make(orig_bind, meter):
            def bind():
                launch = orig_bind()

                def counted(*a):
                    with meter.on_this_thread():
                        if meter.outside_seams():
                            meter.dispatch(f"{name} kernel")
                    return launch(*a)
                return counted
            return bind
        return make

    def compile_funnel(orig, meter):
        @contextlib.contextmanager
        def record_compile(*a, **k):
            # A capture or a build synchronizes: priced by the recompiles
            # budget, not the guard. Lifted until the last open one (two
            # lanes may capture at once) ends.
            guarded = meter.device_type == "cuda" and meter.guard == "disallow"
            if guarded:
                with meter.lock:
                    meter.lifts += 1
                    torch.cuda.set_sync_debug_mode(0)
            try:
                with orig(*a, **k):
                    yield
            finally:
                if guarded:
                    with meter.lock:
                        meter.lifts -= 1
                        if meter.lifts == 0:
                            torch.cuda.set_sync_debug_mode("error")
        return record_compile

    def numpy_seam(direction):
        def make(orig, meter):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                if meter.device_type == "cpu" and getattr(meter.tls, "on", False):
                    t = a[0] if direction == "out" else out
                    if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                        meter.transfer(_nbytes(t), f"{orig.__name__} ({direction})",
                                       implicit=False)
                return out
            return wrapped
        return make

    return [
        (torch.cuda.CUDAGraph, "replay", program(lambda self: "cuda_graph")),
        (loop.CapturedStep, "replay", program(lambda self: "captured_step")),
        (host_loop.HostUpdate, "__call__", program(
            lambda self: self.name,
            lambda self: tuple(t.data_ptr() for t in self.carried().values()))),
        (engine._Lane, "_forward", program(
            lambda self, b: f"serving.act[b={b}]", _lane_addresses, lambda self, b: b)),
        (engine._Lane, "run", thread_seam),
        (gae_cuda, "_bind", kernel("gae")),
        (vtrace_cuda, "_bind", kernel("vtrace")),
        (profiler, "record_compile", compile_funnel),
        *((owner, attr, numpy_seam(direction)) for owner, attr, direction in _NUMPY_SEAMS),
    ]


def seam_originals() -> dict[str, Any]:
    """What every seam `measure()` patches holds now (by `owner.attribute`),
    with the calling thread's dispatch mode stack and the card's sync-debug
    mode: the test that nothing stays patched compares these."""
    out = {f"{getattr(o, '__name__', o)}.{a}": getattr(o, a) for o, a, _ in _seams()}
    out["dispatch modes"] = torch.utils._python_dispatch._get_current_dispatch_mode_stack()
    if torch.cuda.is_available():
        out["sync debug mode"] = torch.cuda.get_sync_debug_mode()
    return out


@contextlib.contextmanager
def measure(guard: Optional[str] = None, device="cuda"):
    """Count dispatches, transfers, bytes and recompiles for the enclosed
    block on `device`'s type, under the "disallow" guard when asked. Yields
    a live `Counters` the caller reads after the block. Not reentrant."""
    from actor_critic_tpu_torch.telemetry import profiler

    if guard not in (None, *GUARDS):
        raise ValueError(f"unknown guard {guard!r}")
    if _ACTIVE:
        raise RuntimeError("perfsan.measure() is not reentrant")
    c = Counters()
    meter = _Meter(c, torch.device(device).type, guard)
    patched = []
    sync_mode = None
    n0 = profiler.recompile_count()
    _ACTIVE.append(meter)
    try:
        for owner, attr, make in _seams():
            had = attr in vars(owner)
            orig = vars(owner)[attr] if had else getattr(owner, attr)
            patched.append((owner, attr, had, orig))
            setattr(owner, attr, make(getattr(owner, attr), meter))
        if meter.device_type == "cuda" and guard == "disallow":
            sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        with meter.on_this_thread():
            yield c
    finally:
        if sync_mode is not None:
            torch.cuda.set_sync_debug_mode(sync_mode)
        for owner, attr, had, orig in reversed(patched):
            if had:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        _ACTIVE.clear()
        c.recompiles += profiler.recompile_count() - n0


def check_budget(program: str, counters: Counters, budgets: dict) -> None:
    """Raise PerfSanError when any counter exceeds the program's budget (an
    absent program entry is itself a violation: a new steady-state program
    must commit a budget)."""
    budget = budgets.get(program)
    if budget is None:
        raise PerfSanError(
            f"{program}: no budget entry in the manifest — every steady-state program must "
            "commit max dispatches/transfers/bytes/recompiles per block")
    actuals = {
        "max_dispatches_per_block": counters.dispatches,
        "max_transfers_per_block": counters.transfers,
        "max_transferred_bytes_per_block": counters.transferred_bytes,
        "max_recompiles": counters.recompiles,
    }
    over = [(key, actuals[key], budget[key]) for key in BUDGET_KEYS
            if key in budget and actuals[key] > int(budget[key])]
    if over:
        detail = "; ".join(f"{k}: measured {a} > budget {b}" for k, a, b in over)
        names = ", ".join(f"{n}x{k}" for n, k in sorted(counters.dispatch_names.items()))
        raise PerfSanError(
            f"BUDGET VIOLATION in {program}: {detail} (dispatches by program: "
            f"{names or 'none'}) — either a regression re-entered the steady-state path, or a "
            "deliberate change must recommit actor_critic_tpu_torch/analysis/perf_budgets.json")


# ---------------------------------------------------------------------------
# shared fixtures (tiny real programs)
# ---------------------------------------------------------------------------


def _fence(device: torch.device) -> None:
    """Close a measured block on finished work: an event wait on the card
    (a stream or device sync would trip the guard's sync-debug mode)."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


def _warm(device: torch.device, fn: Callable[[], Any]) -> None:
    """`fn()` inside a discarded meter: the first metered call of each
    program is its capture on the CPU (the card captured in the warm-up)."""
    with measure(device=device):
        fn()
        _fence(device)


class _Launches:
    """The scan kernels' launches over a span of measured blocks, counted on
    the card (None on the CPU, where the plain versions run)."""

    def __init__(self, device: torch.device):
        from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

        self.kernels = {"gae": gae_cuda, "vtrace": vtrace_cuda}
        self.cuda = device.type == "cuda"
        if self.cuda:
            for k in self.kernels.values():
                k.reset_launch_count()

    def read(self) -> Optional[dict]:
        if not self.cuda:
            return None
        return {name: k.launch_count() for name, k in self.kernels.items()}


def _ppo_spec_cfg():
    from actor_critic_tpu_torch.algos import ppo
    from actor_critic_tpu_torch.envs.env import EnvSpec

    spec = EnvSpec(obs_shape=(4,), action_dim=2, discrete=True, can_truncate=True)
    cfg = ppo.PPOConfig(num_envs=4, rollout_steps=8, epochs=1, num_minibatches=1, hidden=(16,))
    return spec, cfg


class _PPOLearner:
    """The async PPO learner's device state (JAX's `_ppo_fixture`): net,
    Adam, schedule table, generator and iteration on `device`."""

    def __init__(self, device: torch.device, seed: int = 0):
        from actor_critic_tpu_torch.algos import ppo

        self.spec, self.cfg = _ppo_spec_cfg()
        self.net, self.opt_state = ppo.init_host_params(self.spec, self.cfg, seed, device)
        self.schedule = ppo.make_schedule(self.cfg, device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.iteration = torch.zeros(1, dtype=torch.int64, device=device)

    def update(self, body: Callable[[], dict], block: Callable[[], Any], name: str):
        """`body` as the async learner runs it (`host_loop.HostUpdate`)."""
        from actor_critic_tpu_torch.algos import host_loop
        from actor_critic_tpu_torch.algos.common import named_carried

        return host_loop.HostUpdate(
            body, self.generator, capture_error_mode="thread_local", name=name,
            carried=lambda: named_carried({"params": self.net, "opt_state": self.opt_state,
                                           "block": block()}, ""))


def _ppo_block(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    T, E = cfg.rollout_steps, cfg.num_envs
    obs = rng.normal(size=(T, E, 4)).astype(np.float32)
    return {
        "obs": obs,
        "action": rng.integers(0, 2, (T, E)),
        "log_prob": (rng.normal(size=(T, E)) * 0.1 - 0.69).astype(np.float32),
        "value": rng.normal(size=(T, E)).astype(np.float32),
        "reward": np.ones((T, E), np.float32),
        "done": np.zeros((T, E), np.float32),
        "terminated": np.zeros((T, E), np.float32),
        "final_obs": obs.copy(),
        "last_obs": rng.normal(size=(E, 4)).astype(np.float32),
    }


def _fused_block(cfg, seed: int) -> dict:
    """`_ppo_block` with the mirror's baselines (correction="none")."""
    rng = np.random.default_rng(seed)
    block = _ppo_block(cfg, seed)
    T, E = cfg.rollout_steps, cfg.num_envs
    block["final_values"] = rng.normal(size=(T, E)).astype(np.float32)
    block["bootstrap_value"] = rng.normal(size=(E,)).astype(np.float32)
    return block


# ---------------------------------------------------------------------------
# program exercisers
# ---------------------------------------------------------------------------


def exercise_ppo_update_host(blocks: int = 3, seed: int = 0, device="cuda") -> dict:
    """The async V-trace learner consuming HOST-plane blocks: each block
    taken from a `TrajQueue`, staged into the pinned double buffers and
    uploaded into the static buffers its update reads
    (`host_loop.AsyncFeed`), then the update. The upload is the budgeted
    cost of the host plane; the device twin removes it."""
    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.algos import host_loop, ppo
    from actor_critic_tpu_torch.algos.traj_queue import TrajQueue

    device = resolve_device(device)
    lr = _PPOLearner(device)
    step = ppo.make_async_update_step(lr.spec, lr.cfg, True, "vtrace")
    queue = TrajQueue(depth=2, register_gauge=False)
    feed = host_loop.AsyncFeed(queue, lr.cfg.rollout_steps, device)
    feed.buffers.preallocate(ppo.async_block_spec(lr.spec, lr.cfg, 1, "vtrace"))
    update = lr.update(lambda: step(lr.net, lr.opt_state, lr.schedule, lr.generator,
                                    feed.buffers.static, lr.iteration),
                       lambda: feed.buffers.static, "ppo.async_update")

    def take(i: int):
        queue.put(_ppo_block(lr.cfg, seed + i), version=i)  # the actor's side
        return queue.get(timeout=5.0)

    try:
        host_loop.stage_block(feed, take(0))
        update.warm()
        _warm(device, lambda: (host_loop.stage_block(feed, take(0)), update()))
        launches = _Launches(device)
        per_block = []
        for i in range(blocks):
            block = take(1 + i)
            with measure(device=device) as c:
                host_loop.stage_block(feed, block)
                update()
                _fence(device)
            per_block.append(c)
        return {"program": "ppo_update_host", "blocks": blocks, "counters": worst_of(per_block),
                "per_block": per_block, "launches": launches.read()}
    finally:
        queue.close()


def _host_gather(ring, lease, device: torch.device) -> None:
    """REVERTED consume: the leased slot copied to the host and uploaded
    again inside the learner scope (what the device plane removed), each
    crossing explicit, so that the meter prices it."""
    cuda = device.type == "cuda"
    host = {k: v[lease.slot].to("cpu", non_blocking=cuda) for k, v in ring.state.storage.items()}
    _fence(device)
    arrays = {k: h.numpy() for k, h in host.items()}
    uploaded = {k: torch.from_numpy(a).to(device, non_blocking=cuda) for k, a in arrays.items()}
    _fence(device)
    del uploaded


def exercise_ppo_update_device(blocks: int = 3, seed: int = 0, revert: Optional[str] = None,
                               device="cuda") -> dict:
    """The device-plane twin: the actor enqueues int8-encoded blocks into a
    `DeviceTrajRing` (its bytes metered apart: the actor's cost, off the
    learner's path); the learner's scope runs under the "disallow" guard:
    `ring.select` (the slot index by a fill kernel) and the update's
    replay, which gathers and decodes the slot itself. `revert="host-gather"`
    gathers the slot to the host and uploads it inside the learner scope."""
    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.algos import host_loop, ppo
    from actor_critic_tpu_torch.data_plane.ring import DeviceTrajRing

    device = resolve_device(device)
    lr = _PPOLearner(device)
    ring = DeviceTrajRing(depth=2, block_spec=ppo.async_block_spec(lr.spec, lr.cfg, 1, "vtrace"),
                          codec="int8", device=device, register_gauge=False)
    try:
        step = ppo.make_device_update_step(lr.spec, lr.cfg, ring.codecs, True, "vtrace")
        update = lr.update(lambda: step(lr.net, lr.opt_state, lr.schedule, lr.generator,
                                        ring.state, ring.slot_index, lr.iteration),
                           lambda: ring.state, "ppo.async_update")
        feed = host_loop.AsyncFeed(ring, lr.cfg.rollout_steps, device)
        ring.put(_ppo_block(lr.cfg, seed), version=0)
        lease = ring.get(timeout=5.0)
        feed.stage(lease)
        update.warm()
        _warm(device, update)
        feed.done(lease)
        launches = _Launches(device)
        enqueue, consume = [], []
        for i in range(blocks):
            block = _ppo_block(lr.cfg, seed + 1 + i)
            with measure(device=device) as ce:
                ring.put(block, version=i + 1)
                _fence(device)
            enqueue.append(ce)
            lease = ring.get(timeout=5.0)
            with measure(guard="disallow", device=device) as cc:
                if revert == "host-gather":
                    _host_gather(ring, lease, device)
                else:
                    host_loop.stage_block(feed, lease)
                    update()
                    _fence(device)
            feed.done(lease)
            consume.append(cc)
        return {
            "program": "ppo_update_device", "blocks": blocks,
            "counters": worst_of(consume), "per_block": consume,
            "enqueue": worst_of(enqueue),
            "enqueue_bytes_per_block": ring.bytes_per_block(),
            "host_bytes_per_block": ring.raw_bytes_per_block(),
            "launches": launches.read(),
        }
    finally:
        ring.close()


def exercise_ppo_update_fused(blocks: int = 3, seed: int = 0, revert: Optional[str] = None,
                              device="cuda") -> dict:
    """The fused consume: gather + decode + GAE + update as ONE program under
    correction="none" (`ppo.make_device_update_step`, GAE inside the
    update's graph). `revert="unfused"` runs the advantages as a program of
    their own before the update on every block: one dispatch more."""
    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.algos import host_loop, ppo
    from actor_critic_tpu_torch.algos.common import gae_targets
    from actor_critic_tpu_torch.data_plane.ring import DeviceTrajRing, gather_block

    device = resolve_device(device)
    lr = _PPOLearner(device)
    ring = DeviceTrajRing(depth=2, block_spec=ppo.async_block_spec(lr.spec, lr.cfg, 1, "none"),
                          codec="fp32", device=device, register_gauge=False)
    try:
        step = ppo.make_device_update_step(lr.spec, lr.cfg, ring.codecs, True, "none")
        update = lr.update(lambda: step(lr.net, lr.opt_state, lr.schedule, lr.generator,
                                        ring.state, ring.slot_index, lr.iteration),
                           lambda: ring.state, "ppo.async_update")

        def advantages_only() -> dict:
            # The split-out advantage program the fused path removed.
            b = gather_block(ring.state, ring.slot_index, ring.codecs)
            adv, ret = gae_targets(b["reward"], b["value"], b["done"], b["bootstrap_value"],
                                   lr.cfg.gamma, lr.cfg.gae_lambda)
            return {"advantage": adv, "return": ret}

        advantages = host_loop.HostUpdate(
            advantages_only, torch.Generator(device=device), capture_error_mode="thread_local",
            name="ppo.advantages", carried=lambda: {})
        feed = host_loop.AsyncFeed(ring, lr.cfg.rollout_steps, device)

        def consume():
            host_loop.stage_block(feed, lease)
            if revert == "unfused":
                advantages()
            update()
            _fence(device)

        ring.put(_fused_block(lr.cfg, seed), version=0)
        lease = ring.get(timeout=5.0)
        feed.stage(lease)
        update.warm()
        if revert == "unfused":
            advantages.warm()
        _warm(device, consume)
        feed.done(lease)
        launches = _Launches(device)
        per_block = []
        for i in range(blocks):
            ring.put(_fused_block(lr.cfg, seed + 1 + i), version=i + 1)
            lease = ring.get(timeout=5.0)
            with measure(guard="disallow", device=device) as c:
                consume()
            feed.done(lease)
            per_block.append(c)
        return {"program": "ppo_update_fused", "blocks": blocks,
                "counters": worst_of(per_block), "per_block": per_block,
                "launches": launches.read()}
    finally:
        ring.close()


def exercise_offpolicy_ingest(blocks: int = 3, seed: int = 0, device="cuda") -> dict:
    """DDPG's device-plane ingest: gather + decode + insert into the replay
    ring + the update loop, ONE program per consumed block
    (`device_replay.make_device_ingest_update`), its two inputs (the slot and
    the env-step count) written by fill kernels (`AsyncFeed.stage`)."""
    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.algos import ddpg, host_loop
    from actor_critic_tpu_torch.algos.common import named_carried
    from actor_critic_tpu_torch.data_plane import device_replay
    from actor_critic_tpu_torch.data_plane.ring import DeviceTrajRing
    from actor_critic_tpu_torch.envs.env import EnvSpec

    device = resolve_device(device)
    spec = EnvSpec(obs_shape=(3,), action_dim=1, discrete=False, can_truncate=True)
    cfg = ddpg.DDPGConfig(num_envs=2, steps_per_iter=4, batch_size=8, warmup_steps=0,
                          buffer_capacity=256, updates_per_iter=1)
    ring = DeviceTrajRing(depth=2, block_spec=device_replay.offpolicy_block_spec(spec, cfg, 1),
                          codec="int8", device=device, register_gauge=False)
    try:
        ingest = device_replay.make_device_ingest_update(
            ddpg.make_host_ingest_update(spec.action_dim, cfg), ring.codecs)
        learner = ddpg.init_learner((3,), 1, cfg, torch.Generator().manual_seed(seed), device)
        generator = torch.Generator(device=device).manual_seed(seed)
        feed = host_loop.AsyncFeed(ring, cfg.steps_per_iter, device)
        env_steps = feed.scalar("env_steps")
        update = host_loop.HostUpdate(
            lambda: ingest(learner, ring.state, ring.slot_index, env_steps, generator),
            generator, capture_error_mode="thread_local", name="ddpg.async_update",
            carried=lambda: named_carried({"learner": learner, "block": ring.state}, ""))
        rng = np.random.default_rng(seed)

        def block_for():
            K, E = cfg.steps_per_iter, cfg.num_envs
            obs = rng.normal(size=(K, E, 3)).astype(np.float32)
            return {
                "obs": obs,
                "action": rng.uniform(-1, 1, (K, E, 1)).astype(np.float32),
                "reward": np.ones((K, E), np.float32),
                "done": np.zeros((K, E), np.float32),
                "terminated": np.zeros((K, E), np.float32),
                "final_obs": obs.copy(),
                "last_obs": obs[0].copy(),
            }

        def consume(steps: int):
            host_loop.stage_block(feed, lease, env_steps=steps)
            update()
            _fence(device)

        ring.put(block_for(), version=0)
        lease = ring.get(timeout=5.0)
        feed.stage(lease, env_steps=cfg.steps_per_iter)
        update.warm()
        _warm(device, lambda: consume(cfg.steps_per_iter))
        feed.done(lease)
        per_block = []
        steps = cfg.steps_per_iter
        for i in range(blocks):
            ring.put(block_for(), version=i + 1)
            lease = ring.get(timeout=5.0)
            steps += cfg.steps_per_iter
            with measure(guard="disallow", device=device) as c:
                consume(steps)
            feed.done(lease)
            per_block.append(c)
        return {"program": "offpolicy_ingest", "blocks": blocks,
                "counters": worst_of(per_block), "per_block": per_block}
    finally:
        ring.close()


def _serving_fixture(seed: int, device: torch.device, lanes: int = 1):
    from actor_critic_tpu_torch.serving import engine as serving_engine
    from actor_critic_tpu_torch.serving.policy_store import PolicyStore

    spec, cfg = _ppo_spec_cfg()
    engine = serving_engine.PolicyEngine(spec, cfg, algo="ppo", buckets=(1, 4), seed=seed,
                                         device=device, lanes=lanes)
    params = serving_engine.init_params(spec, cfg, "ppo", seed=seed)
    store = PolicyStore()
    store.register("default", engine, params, version=1)
    _warm(device, lambda: engine.warm(store.get("default").params))
    return spec, cfg, engine, store, params


def _rebind_lanes(engine) -> None:
    """REVERTED install (the stand-in for JAX's swap without `uncommit`):
    each lane's parameters rebound to new tensors holding the resident
    version instead of copied into the addresses its graphs read, and its
    graphs dropped, so the next act must capture them again."""
    for lane in engine._lanes:
        state = {name: p.detach().clone() for name, p in lane.net.named_parameters()}
        lane.net.load_state_dict(state, assign=True)
        lane.params = [p for _, p in lane.net.named_parameters()]
        lane.loaded = -1
        lane.graphs.clear()
        lane.outputs.clear()


def exercise_serving_dispatch(acts: int = 4, seed: int = 0, revert: Optional[str] = None,
                              device="cuda") -> dict:
    """`PolicyEngine.act` on warmed buckets (1 and 4), then a mid-stream
    hot swap from a params-only checkpoint (`export_policy_params` →
    `restore_policy_params` → `PolicyStore.swap`) and one more act: one
    replay per act, the staging copies in and out, and zero recompiles
    across the swap (its first act per lane copies the new version into the
    lane's parameters). `revert="uncommit"` rebinds the lanes' parameters
    after the swap (`_rebind_lanes`): the next act captures again."""
    import tempfile

    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.serving import engine as serving_engine
    from actor_critic_tpu_torch.serving.policy_store import (
        export_policy_params,
        restore_policy_params,
    )

    device = resolve_device(device)
    spec, cfg, engine, store, params = _serving_fixture(seed, device)
    rng = np.random.default_rng(seed)
    per_act = []
    for n in [1, 4, 1, 4][:acts] or [1]:
        obs = rng.normal(size=(n, 4)).astype(np.float32)
        handle = store.get("default")
        with measure(guard="disallow", device=device) as c:
            out = engine.act(handle.params, obs)
        assert out.shape[0] == n
        per_act.append(c)
    swap_params = serving_engine.init_params(spec, cfg, "ppo", seed=seed + 1)
    with tempfile.TemporaryDirectory(prefix="perfsan_") as root:
        export_policy_params(root, swap_params)
        store.swap("default", restore_policy_params(root, params))
    if revert == "uncommit":
        _rebind_lanes(engine)
    obs = rng.normal(size=(1, 4)).astype(np.float32)
    handle = store.get("default")
    with measure(guard="disallow", device=device) as c_swap:
        engine.act(handle.params, obs)
    per_act.append(c_swap)
    return {"program": "serving_dispatch", "acts": len(per_act), "counters": worst_of(per_act),
            "per_act": per_act}


def exercise_serving_overlap(acts: int = 4, seed: int = 0, device="cuda") -> dict:
    """The same act budget through a RUNNING `MicroBatcher` with
    max_inflight=2 and an engine of two lanes (the gateway's setting):
    packing, the flight hand-off, shedding and SLO accounting are host
    work and must add no device work per act. One request at a time, so
    each window holds one single-row flush, dispatched on a flight thread
    (metered there through its lane)."""
    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.serving.batcher import MicroBatcher

    device = resolve_device(device)
    _, _, _, store, _ = _serving_fixture(seed, device, lanes=2)
    batcher = MicroBatcher(store, max_wait_us=200.0, max_inflight=2)
    rng = np.random.default_rng(seed)
    per_act = []
    try:
        for _ in range(max(acts, 1)):
            obs = rng.normal(size=(1, 4)).astype(np.float32)
            with measure(guard="disallow", device=device) as c:
                req = batcher.submit(obs, "default")
                if not req.done.wait(timeout=30.0):
                    raise PerfSanError("serving_overlap: flight dispatch never completed "
                                       "(overlap machinery wedged)")
                if req.error is not None:
                    raise req.error
            per_act.append(c)
    finally:
        batcher.close()
    return {"program": "serving_overlap", "acts": len(per_act), "counters": worst_of(per_act),
            "per_act": per_act}


def exercise_serving_proxy_hop(relays: int = 4, seed: int = 0, device="cuda") -> dict:
    """One `FleetProxy` relay to one stub-engine replica gateway over HTTP on
    loopback: ALL ZERO, since the fronting proxy carries no device state
    (`device` only names the meter's device)."""
    import http.client

    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.serving.fleet_proxy import FleetProxy
    from actor_critic_tpu_torch.serving.gateway import ServeGateway
    from actor_critic_tpu_torch.serving.policy_store import PolicyStore

    class _StubEngine:
        max_rows = 8

        def prepare_params(self, params):
            return params

        def act(self, params, obs):
            return np.asarray(obs)[:, 0]

    device = resolve_device(device)
    store = PolicyStore()
    store.register("default", _StubEngine(), {"w": np.ones((1,), np.float32)})
    gateway = ServeGateway(store, port=0)
    proxy = FleetProxy([gateway.url], port=0, probe=False)
    rng = np.random.default_rng(seed)
    per_relay = []

    def relay(conn) -> tuple[int, Any]:
        body = json.dumps({"obs": rng.normal(size=(1, 4)).astype(np.float32).tolist()})
        conn.request("POST", "/v1/act", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    try:
        conn = http.client.HTTPConnection(proxy.host, proxy.port, timeout=10)
        relay(conn)  # unmetered: the first contact sets up both hops' connections
        for _ in range(max(relays, 1)):
            with measure(device=device) as c:
                status, payload = relay(conn)
            if status != 200:
                raise PerfSanError(f"serving_proxy_hop: relay answered {status}: {payload}")
            per_relay.append(c)
        conn.close()
    finally:
        proxy.close()
        gateway.close()
    return {"program": "serving_proxy_hop", "relays": len(per_relay),
            "counters": worst_of(per_relay), "per_relay": per_relay}


def exercise_mixture_fleet_step(calls: int = 3, seed: int = 0, iters_per_call: int = 4,
                                device="cuda") -> dict:
    """The heterogeneous mixture fleet's fused A2C step, `iters_per_call`
    iterations in one captured chunk (`host_loop.HostUpdate` over the
    fused step: `loop.CapturedStep` on the card, eager on the CPU), the
    whole train state device-resident: one dispatch per call and nothing
    crossing, under the "disallow" guard."""
    from actor_critic_tpu_torch import resolve_device
    from actor_critic_tpu_torch.algos import a2c, host_loop, loop
    from actor_critic_tpu_torch.algos.common import carried_tensors
    from actor_critic_tpu_torch.envs.mixture import make_mixture

    device = resolve_device(device)
    env = make_mixture("cartpole,pendulum")
    cfg = a2c.A2CConfig(num_envs=8, rollout_steps=4)
    state = a2c.init_state(env, cfg, seed, device)
    step = a2c.make_train_step(env, cfg)

    def chunk() -> dict:
        for _ in range(iters_per_call):
            _, metrics = step(state)
        return metrics

    block = host_loop.HostUpdate(chunk, state.generator, capture_error_mode=loop.capture_mode(step),
                                 name=f"a2c.train_step[x{iters_per_call}]",
                                 carried=lambda: carried_tensors(state))
    block.warm()
    _warm(device, block)
    launches = _Launches(device)
    per_call = []
    for _ in range(calls):
        with measure(guard="disallow", device=device) as c:
            block()
            _fence(device)
        per_call.append(c)
    return {"program": "mixture_fleet_step", "calls": calls, "counters": worst_of(per_call),
            "per_call": per_call, "launches": launches.read()}


# ---------------------------------------------------------------------------
# the budgeted sweep + reverted modes
# ---------------------------------------------------------------------------

EXERCISERS = {
    "ppo_update_host": exercise_ppo_update_host,
    "ppo_update_device": exercise_ppo_update_device,
    "ppo_update_fused": exercise_ppo_update_fused,
    "offpolicy_ingest": exercise_offpolicy_ingest,
    "serving_dispatch": exercise_serving_dispatch,
    "serving_overlap": exercise_serving_overlap,
    "serving_proxy_hop": exercise_serving_proxy_hop,
    "mixture_fleet_step": exercise_mixture_fleet_step,
}


def run_program(name: str, budgets: dict, seed: int = 0, device="cuda") -> dict:
    """One program end to end: exercise, then gate on its budget; the device
    plane also gates its actor-side enqueue (`ppo_update_device.enqueue`)."""
    report = EXERCISERS[name](seed=seed, device=device)
    check_budget(name, report["counters"], budgets)
    if name == "ppo_update_device" and "ppo_update_device.enqueue" in budgets:
        check_budget("ppo_update_device.enqueue", report["enqueue"], budgets)
    return report


def quick_profile(manifest_path: Optional[str] = None, seed: int = 0,
                  programs: Iterable[str] = PROGRAMS, device="cuda") -> dict:
    """Every steady-state program measured against the manifest's values for
    `device`'s platform. Counters are structural (fixed shapes, fixed
    programs): the actuals are identical run to run."""
    platform = torch.device(device).type
    budgets = load_manifest(manifest_path or default_manifest_path(), platform)
    out: dict = {"platform": platform, "programs": {}, "violations": 0}
    for name in programs:
        report = run_program(name, budgets, seed=seed, device=device)
        entry = {"actuals": report["counters"].as_dict(), "budget": budgets.get(name, {})}
        if "enqueue" in report:
            entry["enqueue_actuals"] = report["enqueue"].as_dict()
            entry["enqueue_bytes_per_block"] = report["enqueue_bytes_per_block"]
            entry["host_bytes_per_block"] = report["host_bytes_per_block"]
        if report.get("launches") is not None:
            entry["launches"] = report["launches"]
        out["programs"][name] = entry
    return out


def run_reverted(mode: str, manifest_path: Optional[str] = None, device="cuda") -> None:
    """The reverted modes, each raising PerfSanError on EVERY run, on JAX's
    budget key: "host-gather" (transfers), "unfused" (dispatches),
    "uncommit" (recompiles; the port's stand-in rebinds the lanes'
    parameters)."""
    budgets = load_manifest(manifest_path or default_manifest_path(), torch.device(device).type)
    if mode == "host-gather":
        report = exercise_ppo_update_device(revert="host-gather", device=device)
        check_budget("ppo_update_device", report["counters"], budgets)
        raise PerfSanError("host-gather revert escaped the transfer budget — the meter is blind")
    if mode == "unfused":
        report = exercise_ppo_update_fused(revert="unfused", device=device)
        check_budget("ppo_update_fused", report["counters"], budgets)
        raise PerfSanError("unfused revert escaped the dispatch budget — the meter is blind")
    if mode == "uncommit":
        report = exercise_serving_dispatch(revert="uncommit", device=device)
        check_budget("serving_dispatch", report["counters"], budgets)
        raise PerfSanError("uncommit revert escaped the recompile budget — the meter is blind")
    raise PerfSanError(f"unknown reverted mode {mode!r}")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """The CLI (JAX's `scripts/perfsan.py`, with `--device`)."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m actor_critic_tpu_torch.analysis.perfsan",
        description="dispatch/transfer budget sanitizer for the steady-state programs")
    p.add_argument("--quick", action="store_true",
                   help="run every steady-state program against the manifest (the default)")
    p.add_argument("--program", default=None,
                   help=f"run ONE program ({' / '.join(PROGRAMS)})")
    p.add_argument("--revert", choices=REVERTS, default=None,
                   help="reverted mode (expected exit 1): 'host-gather' gathers the leased slot "
                   "to the host and uploads it again inside the learner scope; 'unfused' runs "
                   "GAE as its own program before the update; 'uncommit' (JAX's swap without "
                   "checkpoint.uncommit) rebinds the serving lanes' parameters after a swap, so "
                   "their graphs must be captured again")
    p.add_argument("--manifest", default=None,
                   help="budget manifest (default: actor_critic_tpu_torch/analysis/"
                   "perf_budgets.json)")
    p.add_argument("--seed", type=int, default=0,
                   help="fixture seed (counters are structural: any seed measures the same)")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--out", default=None, help="also write the JSON report to this path")
    p.add_argument("--device", default="cuda", choices=PLATFORMS,
                   help="where the programs run, and whose manifest values gate them (default: "
                   "the card)")
    args = p.parse_args(argv)

    if args.revert and args.program:
        print("perfsan: error: --revert and --program are exclusive", file=sys.stderr)
        return 2
    try:
        if args.revert:
            # torchlint: disable=collective-discipline (one process: the CLI maps
            # a crash to exit 2; no fleet runs this)
            run_reverted(args.revert, args.manifest, device=args.device)
            print(f"perfsan: error: reverted mode {args.revert!r} was NOT detected — the meter "
                  "is blind", file=sys.stderr)
            return 2
        programs = PROGRAMS
        if args.program:
            if args.program not in PROGRAMS:
                print(f"perfsan: error: unknown program {args.program!r} (have: "
                      f"{', '.join(PROGRAMS)})", file=sys.stderr)
                return 2
            programs = (args.program,)
        out = quick_profile(manifest_path=args.manifest, seed=args.seed, programs=programs,
                            device=args.device)
    except ManifestError as e:
        print(f"perfsan: error: {e}", file=sys.stderr)
        return 2
    except PerfSanError as e:
        print(f"perfsan: VIOLATION DETECTED: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"perfsan: error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for name, entry in out["programs"].items():
            a = entry["actuals"]
            print(f"perfsan: {name}: {a['dispatches']} dispatch(es), {a['transfers']} "
                  f"transfer(s), {a['transferred_bytes']} B, {a['recompiles']} recompile(s) per "
                  "block — within budget")
        print(f"perfsan: {len(out['programs'])} steady-state program(s) green against "
              f"perf_budgets.json ({out['platform']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
