"""Bucketed act programs for the policy-serving gateway (counterpart of
`actor_critic_tpu/serving/engine.py`).

A serving process runs ONE act program per bucket size: each
micro-batch is padded to the smallest fitting bucket (`pad_to_bucket`), so
the distinct programs are bounded by `len(buckets)` however request sizes
mix. On the card each bucket's program is one CUDA graph (JAX: one
compiled program), captured by `PolicyEngine.warm` before the gateway
takes traffic; on the CPU it is the eager act.

What a graph freezes, and how a flush is built around it:
- addresses: a graph reads its lane's own copy of the network's parameters
  and a static input tensor, and writes a static output tensor. A flush
  copies its policy version's parameters into the lane when the lane last
  held another version (a few device-to-device copies), stages the padded
  observations through pinned memory into the bucket's input, replays, and
  copies the output back through pinned memory: nothing is allocated on
  the card after the capture.
- concurrency: each flight worker of the micro-batcher checks out a lane
  (`lanes` of them, each with its own stream, staging, parameter copy and
  graphs) for the whole stage → replay → read back, so two flushes never
  share a static buffer; with more flights than lanes a flush waits for a
  lane.
- hot swap: `prepare_params` uploads a version's parameters into device
  tensors of its own (`DeviceParams`), which nothing writes afterwards; a
  swap installs a new `DeviceParams`, and an in-flight flush keeps
  serving the version it resolved. The (version, action) pair of every
  response comes from one version's parameters.
- padding: pad rows reach the graph with whatever `pad_to_bucket` wrote
  (zeros), every row is computed on its own, and the first n rows are
  returned; pad rows never reach a response.
- sampling (`sample=True`, PPO): each lane's graphs draw from the lane's
  generator (seeded `seed + lane`), registered with each graph, so every
  replay draws fresh numbers. Torch's draws are not JAX's (threefry); the
  stream is held to the policy's distribution, not to JAX's values.

Parameter trees are flax's layout (`{"params": {<module>: {"kernel":
[in, out], "bias"}}}`, what `models/host_actor.mirror_params` and the
async learners' `publish_snapshot` produce and what the JAX package's
`jax.device_get(params)` gives): `weights.from_flax` turns them into the
module's layout for the device backend, and the mirror backend reads them
as they are.

The warm-up registry (`utils/compile_cache.py`): the serving planner
`engine.make_act_program` (serving side only) makes `PolicyEngine.warm` a
serving run's capture part, which the serve CLI runs before the gateway
binds unless `--no-warmup` (then each bucket's first flush captures). JAX's
`abstract_params` and `warmup_thunk` have no counterpart: a capture needs
the live lane buffers, not abstract shapes.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from actor_critic_tpu_torch import resolve_device, weights
from actor_critic_tpu_torch.algos import loop
from actor_critic_tpu_torch.algos.traj_queue import snapshot_frozen
from actor_critic_tpu_torch.models import host_actor
from actor_critic_tpu_torch.telemetry import profiler
from actor_critic_tpu_torch.utils import compile_cache
from actor_critic_tpu_torch.utils.compile_cache import pad_to_bucket

# Serving act programs are tiny (one policy forward); a fine-grained ladder
# keeps padding waste low at small occupancy while the top end bounds the
# rows of a flush.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

SUPPORTED_ALGOS = ("ppo", "ddpg", "td3", "sac")
BACKENDS = ("device", "mirror", "auto")
# Serial numbers of installed param versions, unique in the process: a lane
# reloads its parameter copy when a flush's serial differs from its own.
_SERIALS = itertools.count()


def obs_dtype_of(spec) -> np.dtype:
    """The observations' dtype: uint8 frames for pixel obs, else float32."""
    return np.dtype(np.uint8 if len(spec.obs_shape) == 3 else np.float32)


def _check_algo(algo: str) -> None:
    if algo not in SUPPORTED_ALGOS:
        raise ValueError(f"unsupported serving algo {algo!r}; supported: {SUPPORTED_ALGOS}")


def make_actor(spec, cfg, algo: str = "ppo",
               generator: Optional[torch.Generator] = None) -> nn.Module:
    """The network an act program runs: PPO's actor-critic net, DDPG/TD3's
    deterministic actor, SAC's squashed-Gaussian actor, drawn from
    `generator` as the trainers draw them (the actor first)."""
    _check_algo(algo)
    if algo == "ppo":
        from actor_critic_tpu_torch.algos import ppo

        return ppo.make_network(spec, cfg, generator)
    if algo in ("ddpg", "td3"):
        from actor_critic_tpu_torch.algos import ddpg

        return ddpg.make_networks(spec.obs_shape[-1], spec.action_dim, cfg, generator)[0]
    from actor_critic_tpu_torch.algos import sac

    return sac.make_networks(spec.obs_shape[-1], spec.action_dim, cfg, generator)[0]


def make_act_program(spec, cfg, algo: str = "ppo", sample: bool = False):
    """The serving act program for one policy architecture: `(net, obs) ->
    actions` (greedy), or `(net, obs, generator) -> actions` with
    `sample=True` (PPO only: the off-policy actors are deterministic and
    serve their greedy action). Built from the trainers' own greedy acts,
    so a served action is the trainer's eval action for the same params."""
    if algo == "ppo":
        from actor_critic_tpu_torch.algos import ppo

        if sample:
            return lambda net, obs, generator: net(obs)[0].sample(generator)
        return ppo.make_greedy_act(spec, cfg)
    if sample:
        raise ValueError(
            f"sample-mode serving is PPO-only ({algo!r} serves a deterministic actor — its "
            "greedy action IS its policy)")
    if algo in ("ddpg", "td3"):
        from actor_critic_tpu_torch.algos import ddpg

        return ddpg.make_greedy_act(spec.action_dim, cfg)
    if algo == "sac":
        from actor_critic_tpu_torch.algos import sac

        return sac.make_greedy_act(spec.action_dim, cfg)
    raise ValueError(f"unsupported serving algo {algo!r}; supported: {SUPPORTED_ALGOS}")


def init_params(spec, cfg, algo: str = "ppo", seed: int = 0) -> dict:
    """Freshly initialized params for this architecture, as a numpy tree in
    flax's layout (actor params only for the off-policy algos): the restore
    template of params-only checkpoints and the `--random-init` policy. The
    draws are the trainers' init from the same seed."""
    return weights.to_flax(make_actor(spec, cfg, algo, torch.Generator().manual_seed(seed)))


class DeviceParams(dict):
    """One policy version installed for the device backend: the frozen numpy
    tree (flax's layout; the dict itself) and `tensors`, the network's
    parameters on the engine's device in `named_parameters` order, written
    once by `prepare_params` and only read afterwards. `serial` tells the
    lanes which version they hold."""

    __slots__ = ("tensors", "serial")


class _Lane:
    """One flight's act state: its own copy of the network's parameters (the
    addresses its graphs read), a static input and output per bucket, and on
    the card a stream, pinned staging in and out, one CUDA graph per bucket
    and the generator its graphs draw from."""

    def __init__(self, engine: "PolicyEngine", index: int):
        dev = engine.device
        self.engine = engine
        self.index = index
        self.cuda = dev.type == "cuda"
        self.net = engine._network().to(dev)
        self.net.requires_grad_(False)
        self.params = [p for _, p in self.net.named_parameters()]
        self.loaded = -1  # serial of the DeviceParams the parameters hold
        self.generator = (torch.Generator(device=dev).manual_seed(engine.seed + index)
                          if engine.sample else None)
        dtype = torch.from_numpy(np.zeros(0, engine.obs_dtype)).dtype
        shape = tuple(engine.spec.obs_shape)
        self.inputs = {b: torch.zeros((b, *shape), dtype=dtype, device=dev)
                       for b in engine.buckets}
        self.outputs: dict[int, torch.Tensor] = {}
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        if self.cuda:
            # From the high-priority pool: torch hands out its 32 streams of a
            # pool round robin, so a normal-priority stream may be the very
            # stream a learner is capturing on in another thread, and a
            # replay enqueued there would join that capture.
            self.stream = torch.cuda.Stream(dev, priority=-1)
            self.stage_in = torch.zeros((engine.max_rows, *shape), dtype=dtype, pin_memory=True)
            self.stage_in_np = self.stage_in.numpy()
            self.stage_out: dict[int, torch.Tensor] = {}
            self.done = torch.cuda.Event()

    def _forward(self, b: int) -> torch.Tensor:
        args = (self.net, self.inputs[b])
        if self.generator is not None:
            args += (self.generator,)
        return self.engine._program(*args)

    def _load(self, prepared: DeviceParams) -> None:
        if self.loaded != prepared.serial:
            for dst, src in zip(self.params, prepared.tensors):
                dst.copy_(src, non_blocking=True)
            self.loaded = prepared.serial

    def _capture(self, b: int) -> None:
        """An eager run of bucket `b` on the lane's stream (cuBLAS's
        handle and workspace for it), then its capture; "thread_local"
        mode, so other threads (flights, a learner) go on meanwhile. Both
        are one compile event: the synchronizations of a capture stay inside
        `profiler.record_compile` (perfsan's guard lifts its sync check
        there)."""
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        signature = profiler.signature_of({"obs": self.inputs[b]})
        with profiler.record_compile(f"serving.act[b={b},lane={self.index}]", signature):
            with torch.cuda.stream(self.stream):
                self._forward(b)
            self.stream.synchronize()
            with loop.capture(graph, stream=self.stream, capture_error_mode="thread_local"):
                out = self._forward(b)
        self.outputs[b] = out
        self.stage_out[b] = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self.graphs[b] = graph

    def run(self, prepared: DeviceParams, padded: np.ndarray, graph: bool = True) -> np.ndarray:
        """The act of `prepared` on the padded batch: on the card its
        bucket's graph replayed (captured at the first use; `graph=False`
        runs the same forward eagerly on the same buffers, the check of a
        replay), on the CPU the eager forward."""
        b = padded.shape[0]
        if not self.cuda:
            self._load(prepared)
            self.inputs[b].numpy()[...] = padded
            return self._forward(b).numpy().copy()
        if graph and b not in self.graphs:
            with self.engine._capture_lock:
                self._capture(b)
        with torch.cuda.stream(self.stream):
            self._load(prepared)
            self.stage_in_np[:b] = padded
            self.inputs[b].copy_(self.stage_in[:b], non_blocking=True)
            if graph:
                self.graphs[b].replay()
                out, host = self.outputs[b], self.stage_out[b]
            else:
                out = self._forward(b)
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            self.done.record(self.stream)
        self.done.synchronize()
        return host.numpy().copy()


class PolicyEngine:
    """Bucket-stabilized act dispatch for ONE policy architecture (spec +
    config + algo). Several resident policies of the same architecture
    share one engine, and so one set of graphs: hot-swapping params never
    changes a graph.

    `act` may be called concurrently from the micro-batcher's flight
    workers: each call checks out one of `lanes` lanes (module docstring)
    and waits while all are busy.

    `backend`: "device" (CUDA graphs on the card, the eager act on the
    CPU; JAX's "xla"), "mirror" (the numpy greedy mirror of
    `models/host_actor.py`: no device at all; ragged batches run as they
    are) or "auto" (`resolve_backend` measures both and fixes the faster).
    `device` is the card unless the caller asks for "cpu"; the mirror
    backend needs none. With `gate` (serve-while-training: the async
    learner's actors' gate) a flush waits while the event is clear, as the
    actors do: the learner clears it while its update runs eagerly or is
    captured, when each of its ~150,000 eager ops would otherwise wait for
    the GIL the gateway's threads hold."""

    def __init__(
        self,
        spec,
        cfg,
        algo: str = "ppo",
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        sample: bool = False,
        seed: int = 0,
        backend: str = "device",
        device="cuda",
        lanes: int = 1,
        gate: Optional[threading.Event] = None,
    ):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.spec = spec
        self.cfg = cfg
        self.algo = algo
        self.sample = bool(sample)
        self.buckets = buckets
        self.seed = int(seed)
        self.obs_dtype = obs_dtype_of(spec)
        if backend == "auto" and self.sample:
            backend = "device"  # the mirror serves greedy only: nothing to choose
        # torchlint: thread-owned=caller (resolve_backend fixes "auto" once, on
        # the owning thread at start-up, before any lane serves)
        self.backend = backend
        # resolve_backend's measurement ({'backend', 'device_ms', 'mirror_ms'}).
        self.auto_choice: Optional[dict] = None
        if backend == "mirror":
            if self.sample:
                raise ValueError("backend='mirror' serves greedy actions only")
            self.device = None
            self._program = None
            self._mirror = host_actor.greedy_mirror_for(spec, cfg, algo)
        else:
            self.device = resolve_device(device)
            self._mirror = None
            self._program = make_act_program(spec, cfg, algo, sample=self.sample)
        self.n_lanes = int(lanes)
        self.gate = gate
        self._lanes: list[_Lane] = []
        self._free: list[_Lane] = []
        self._lanes_cv = threading.Condition()
        self._capture_lock = threading.Lock()
        self._upload_stream = None
        self._param_shapes: list[tuple[str, tuple[int, ...]]] = []
        if self.device is not None:
            self._param_shapes = [(n, tuple(p.shape))
                                  for n, p in self._network().named_parameters()]
            if self.device.type == "cuda":
                self._upload_stream = torch.cuda.Stream(self.device, priority=-1)  # as a lane's

    @property
    def max_rows(self) -> int:
        """Largest bucket: the micro-batcher's per-flush row budget."""
        return self.buckets[-1]

    @property
    def graphs_captured(self) -> int:
        return sum(len(lane.graphs) for lane in self._lanes)

    def _network(self) -> nn.Module:
        """The act network with placeholder weights (from a generator of its
        own: the global one stays untouched)."""
        return make_actor(self.spec, self.cfg, self.algo, torch.Generator().manual_seed(0))

    def prepare_params(self, params):
        """Install-normalize a param tree for serving. Device backend: the
        tree converted by `weights.from_flax` and uploaded into device
        tensors of its own (`DeviceParams`; the upload has landed when this
        returns). Mirror backend: a frozen numpy snapshot after a
        `supports_mirror` structure check."""
        if self.backend == "auto":
            raise RuntimeError("backend='auto' is unresolved — call resolve_backend(params) "
                               "before installing policies")
        tree = snapshot_frozen(params)
        if self.backend == "mirror":
            if not host_actor.supports_mirror(tree):
                raise ValueError("backend='mirror' needs an MLP-torso param tree (conv torsos "
                                 "keep the device acting path)")
            return tree
        state = weights.from_flax(tree)
        names = self._param_shapes
        missing = sorted({n for n, _ in names} - set(state))
        extra = sorted(set(state) - {n for n, _ in names})
        if missing or extra:
            raise ValueError(f"params do not fit the {self.algo} act network: missing {missing}, "
                             f"extra {extra}")
        for n, shape in names:
            if tuple(state[n].shape) != shape:
                raise ValueError(f"params {n}: shape {tuple(state[n].shape)}, the network has "
                                 f"{shape}")
        prepared = DeviceParams(tree)
        prepared.serial = next(_SERIALS)
        if self._upload_stream is not None:
            with torch.cuda.stream(self._upload_stream):
                prepared.tensors = [state[n].to(self.device, non_blocking=True)
                                    for n, _ in names]
            self._upload_stream.synchronize()
        else:
            prepared.tensors = [state[n] for n, _ in names]
        return prepared

    def _ensure_lanes(self) -> None:
        with self._lanes_cv:
            if not self._lanes:
                self._lanes = [_Lane(self, i) for i in range(self.n_lanes)]
                self._free = list(self._lanes)

    def _run(self, params, padded: np.ndarray, graph: bool = True) -> np.ndarray:
        if not isinstance(params, DeviceParams):
            raise TypeError("the device backend acts on prepared params: install them with "
                            "prepare_params (PolicyStore.register / swap do)")
        self._ensure_lanes()
        if self.gate is not None:
            self.gate.wait()
        with self._lanes_cv:
            while not self._free:
                self._lanes_cv.wait()
            lane = self._free.pop()
        try:
            return lane.run(params, padded, graph)
        finally:
            with self._lanes_cv:
                self._free.append(lane)
                self._lanes_cv.notify()

    def resolve_backend(self, params, trials: int = 7) -> str:
        """Fix `backend='auto'` from measured batch-1 walls: `trials`
        single-row acts through the device path (on the card the bucket-1
        graph replay with its copies in and out) and through the numpy
        greedy mirror, min-of-trials, the faster kept; both walls go on
        `self.auto_choice`. Params the mirror cannot serve (conv torsos)
        resolve to "device" without measuring. The bucket-1 capture happens
        outside the timed region. A no-op on a concrete backend."""
        if self.backend != "auto":
            return self.backend
        obs = np.zeros((1, *self.spec.obs_shape), self.obs_dtype)
        np_params = snapshot_frozen(params)
        self.backend = "device"
        if not host_actor.supports_mirror(np_params):
            self.auto_choice = {"backend": "device", "reason": "no mirror"}
            return self.backend
        mirror = host_actor.greedy_mirror_for(self.spec, self.cfg, self.algo)
        prepared = self.prepare_params(params)
        padded, _ = pad_to_bucket(obs, self.buckets)

        def device_once():
            return self._run(prepared, padded)

        device_once()  # bucket-1 capture, untimed

        def wall(fn) -> float:
            best = float("inf")
            for _ in range(max(1, int(trials))):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            return best

        device_ms = wall(device_once) * 1e3
        mirror_ms = wall(lambda: mirror(np_params, obs)) * 1e3
        if mirror_ms < device_ms:
            self.backend = "mirror"
            self._mirror = mirror
        self.auto_choice = {"backend": self.backend, "device_ms": device_ms,
                            "mirror_ms": mirror_ms}
        return self.backend

    def act(self, params, obs: np.ndarray) -> np.ndarray:
        """One micro-batch: pad [n, *obs_shape] to its bucket, run the
        bucket's program (on the card: replay its graph), return the first n
        actions as numpy."""
        obs = np.asarray(obs, dtype=self.obs_dtype)
        n = obs.shape[0]
        if self.backend == "mirror":
            out = self._mirror(params, obs)
        else:
            padded, _ = pad_to_bucket(obs, self.buckets)
            out = self._run(params, padded)
        return np.asarray(out)[:n]

    def eager_act(self, params, obs: np.ndarray) -> np.ndarray:
        """`act` with the bucket's forward run eagerly on the same lane
        buffers instead of replaying its graph (on the CPU: `act`): what a
        replay is checked against."""
        obs = np.asarray(obs, dtype=self.obs_dtype)
        padded, _ = pad_to_bucket(obs, self.buckets)
        return self._run(params, padded, graph=False)[:obs.shape[0]]

    def warm(self, params) -> int:
        """Run every bucket once on every lane with concrete params before
        traffic arrives: on the card this captures each bucket's graph (an
        eager run, then the capture). Returns the number of bucket programs
        (0 for the mirror backend: nothing to build)."""
        if self.backend == "mirror":
            return 0
        prepared = params if isinstance(params, DeviceParams) else self.prepare_params(params)
        self._ensure_lanes()
        with self._lanes_cv:
            while len(self._free) < len(self._lanes):
                self._lanes_cv.wait()
            lanes, self._free = self._free, []
        try:
            for lane in lanes:
                for b in self.buckets:
                    lane.run(prepared, np.zeros((b, *self.spec.obs_shape), self.obs_dtype))
        finally:
            with self._lanes_cv:
                self._free = lanes
                self._lanes_cv.notify_all()
        return len(self.buckets)


@compile_cache.register_warmup("engine.make_act_program", serving=True)
def _warmup_act_buckets(ctx):
    """Serving-side planner: every act bucket of every lane captured before
    the gateway takes traffic (`PolicyEngine.warm`, which the serve CLI runs
    as this entry's capture part). Runs only for serving contexts
    (`ctx.serving_buckets` non-empty)."""
    if not ctx.serving_buckets:
        return None
    return compile_cache.warmup_of(ctx)
