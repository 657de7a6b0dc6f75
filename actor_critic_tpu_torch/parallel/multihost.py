"""The multi-process actor-learner (counterpart of
`actor_critic_tpu/parallel/multihost.py`).

Each process ("host", one rank of a fleet) runs the async actor-learner of
`ppo.train_host_async`: `len(pools)` `ActorService` threads feed a local
`TrajQueue` and one learner consumes [T, E_a] blocks. The learner scales in
one of two modes:

- **sync** (arxiv 1803.02811): a data-parallel update over the ranks'
  `torch.distributed` group, NCCL on the card and gloo on the CPU.
  Each rank keeps its own block as its shard of the global [T, P·E_a]
  batch and the same parameters: V-trace runs locally (its columns are
  independent), each minibatch's advantage statistics and its gradients
  are pmean'd (`ppo.make_async_update_fn(group=...)`: one all-reduce of
  the two statistics and one of the flat gradients), so every rank
  takes the same optimizer step. On the card the update is
  `host_loop.HostUpdate`'s one CUDA graph a block, captured in
  "thread_local" mode with its all-reduces inside. The update is a
  barrier: every iteration a consistency check outside the graph
  (`make_consistency_check`) all-reduces the version counter, the stop
  vote and the parameters' float64 fingerprint, so a diverged rank or a
  miscounted version is seen at once and a wall-bounded run stops after
  the same iteration on every rank. A straggler stalls the fleet.
- **gossip** (arxiv 1906.04585): the ranks update independently, with no
  collective, and every `gossip.every` consumed blocks each publishes its
  `(version, params)` into a filesystem mailbox (`write_params`, one
  `.npz` a rank) and mixes in the snapshot a `FileMailboxWriter` thread
  deposited from the ring-scheduled peer (`gossip_peer`):
  `params <- (1 - w)·own + w·peer`, written into the live parameters in
  place between two replays of the update graph (`mix_params`), so the
  graph keeps reading the tensors it captured. A straggler only serves
  stale parameters.

Versions are plain counts of consumed blocks (the async contract): in
sync mode the barrier keeps every rank's count equal (checked); in gossip
mode each rank counts its own and `gossip_lag` reports the peer's lag at
each mix.

The mailbox's snapshot holds the parameters in the port's order
(`named_parameters()` of the PPO network, its own layout: a Linear's
weight is [out, in]) as `leaf<i>`, plus `version`; `read_params` rebuilds
a `{name: array}` dict from the names. The serving fleet's
`MailboxPolicySyncer` reads the same files.

Nothing here starts a process group: `distributed_init` does, before the
learner, and `launch.py` spawns a local fleet.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zipfile
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from actor_critic_tpu_torch.algos.traj_queue import snapshot_frozen
from actor_critic_tpu_torch.parallel import mesh
from actor_critic_tpu_torch.utils import numguard


def nccl_ranks_fit(num_processes: int, cards: int) -> None:
    """Refuse a NCCL fleet with more ranks than cards: a rank's card is
    `process_id % cards`, so two ranks would share one GPU, which NCCL
    refuses (its communicator cannot place two ranks on one device). The
    fleet is never moved to gloo unasked."""
    if num_processes > cards:
        raise RuntimeError(
            f"--distributed over NCCL needs one card a rank: world {num_processes} on "
            f"{cards} card(s) would put two ranks on one GPU, which NCCL refuses (duplicate "
            "GPU in one communicator). Run at most one rank a card, or use --gossip (no "
            "collective), or --device cpu (gloo)")


def distributed_init(coordinator: str, num_processes: int, process_id: int,
                     device="cuda") -> torch.device:
    """Join the fleet's process group at `coordinator` (`HOST:PORT`) with
    the backend that matches `device`: NCCL on the card, gloo for
    `--device cpu`. On the card the rank's GPU is `process_id %
    torch.cuda.device_count()`, made the current device before the group
    starts; a fleet with more ranks than cards raises
    (`nccl_ranks_fit`). Returns the rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from actor_critic_tpu_torch import resolve_device

        resolve_device(dev)
        cards = torch.cuda.device_count()
        nccl_ranks_fit(num_processes, cards)
        dev = torch.device("cuda", int(process_id) % cards)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    mesh.multihost_init(coordinator, num_processes, process_id, backend)
    return dev


def host_lane(rank: int) -> None:
    """Name this process's lane `host<rank>` in the installed telemetry
    session's trace (one lane per pid; the rank makes a fleet's merged
    trace readable)."""
    from actor_critic_tpu_torch import telemetry

    sess = telemetry.current()
    if sess is not None:
        sess.tracer.name_process(os.getpid(), f"host{rank}")


# ---------------------------------------------------------------------------
# the parameter mailbox: in memory (latest wins, frozen snapshots) and files
# ---------------------------------------------------------------------------


class ParamMailbox:
    """Thread-safe latest-wins store of one peer `(version, params)`
    snapshot: a rank's mailbox in the gossip exchange.

    `deposit` stores a frozen copy (`traj_queue.snapshot_frozen`: the
    numpy leaves copied and marked read-only), so the depositing thread
    keeps no writable alias of what the learner consumes. Versions are
    per-peer clocks (a slow peer's 5 can be fresher than a fast one's 50),
    so only a regression of the SAME peer is dropped. `take` hands out the
    latest snapshot at most once; `peek` reads without consuming."""

    def __init__(self):
        self._lock = threading.Lock()
        self._params: Any = None
        self._version = -1
        self._peer = -1
        self._taken = True
        self._deposits = 0
        self._peer_versions: dict[int, int] = {}

    def deposit(self, params: Any, version: int, peer: int) -> bool:
        """Store a frozen snapshot unless `peer` already reached `version`;
        True when it became the mailbox's latest."""
        snapshot = snapshot_frozen(params)  # copy OUTSIDE the lock
        with self._lock:
            if version <= self._peer_versions.get(int(peer), -1):
                return False
            self._peer_versions[int(peer)] = int(version)
            self._params = snapshot
            self._version = int(version)
            self._peer = int(peer)
            self._taken = False
            self._deposits += 1
            return True

    def take(self) -> Optional[tuple[int, int, Any]]:
        """(version, peer, frozen params) if a deposit landed since the last
        take, else None."""
        with self._lock:
            if self._taken or self._params is None:
                return None
            self._taken = True
            return self._version, self._peer, self._params

    def peek(self) -> Optional[tuple[int, int, Any]]:
        with self._lock:
            if self._params is None:
                return None
            return self._version, self._peer, self._params

    def stats(self) -> dict:
        with self._lock:
            return {"version": self._version, "peer": self._peer, "deposits": self._deposits}


def params_file(mailbox_dir: str, rank: int) -> str:
    return os.path.join(mailbox_dir, f"host{rank}", "params.npz")


def param_names(module: torch.nn.Module) -> list[str]:
    """The mailbox's leaf order for `module`: its `named_parameters()`."""
    return [name for name, _ in module.named_parameters()]


def param_leaves(module: torch.nn.Module) -> list[np.ndarray]:
    """Host copies of `module`'s parameters in the mailbox's order and the
    port's layout (reading them waits for the device)."""
    return [p.detach().cpu().numpy().copy() for _, p in module.named_parameters()]


def _leaves_of(params: Any) -> list[np.ndarray]:
    if isinstance(params, Mapping):
        return [np.asarray(v) for v in params.values()]
    return [np.asarray(v) for v in params]


def write_params(mailbox_dir: str, rank: int, version: int, params: Any) -> str:
    """Atomically publish this rank's `(version, params)` snapshot: the
    leaves (a `{name: array}` dict in the mailbox's order, or a list) as
    `leaf<i>` of an .npz written next to the target, fsynced, then
    `os.replace`-d into place, so a concurrent reader sees the previous
    complete snapshot or this one, and a crash cannot leave a rename whose
    data blocks never landed. Latest wins (one file a rank); the
    temporary name carries the pid. A non-finite snapshot is refused
    (`numguard`: through the ring it would reach every peer), and the
    previous one stays published."""
    path = params_file(mailbox_dir, rank)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {f"leaf{i}": v for i, v in enumerate(_leaves_of(params))}
    numguard.check_finite(payload, "mailbox publish", name="params")
    payload["version"] = np.asarray(int(version), np.int64)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _load_snapshot(path: str):
    """`(version, leaves)` of a published snapshot, or None when it is
    absent or torn (a truncated archive raises `zipfile.BadZipFile`, an
    empty one `EOFError`): a torn read is retried at the next poll, never
    fatal."""
    try:
        with np.load(path) as z:
            version = int(z["version"])
            leaves = [z[f"leaf{i}"] for i in range(len(z.files) - 1)]
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        return None
    return version, leaves


def read_params(mailbox_dir: str, rank: int, template: Sequence[str]):
    """`rank`'s latest `(version, {name: array})`, the leaves named by
    `template` (the parameter names in the mailbox's order, `param_names`);
    None when absent or torn. A snapshot with another number of leaves
    than names raises: it is another architecture, not a torn file."""
    out = _load_snapshot(params_file(mailbox_dir, rank))
    if out is None:
        return None
    version, leaves = out
    names = list(template)
    if len(leaves) != len(names):
        raise ValueError(f"mailbox snapshot of rank {rank} holds {len(leaves)} leaves, the "
                         f"template names {len(names)}")
    return version, dict(zip(names, leaves))


def read_version(mailbox_dir: str, rank: int) -> Optional[int]:
    """The version of `rank`'s published snapshot alone (no template), or
    None when absent or torn."""
    out = _load_snapshot(params_file(mailbox_dir, rank))
    return None if out is None else out[0]


def gossip_peer(rank: int, world: int, round_: int) -> int:
    """The rotating ring: at round r every rank reads the peer `1 + r mod
    (world - 1)` ranks ahead, so over world - 1 rounds it hears from every
    other rank."""
    if world < 2:
        raise ValueError("gossip needs at least 2 hosts")
    return (rank + 1 + round_ % (world - 1)) % world


@torch.no_grad()
def mix_params(own, peer, weight: float):
    """The gossip step `own <- (1 - w)·own + w·peer`, leaf by leaf, written
    into `own`'s tensors in place (`own`: a `{name: tensor}` dict or a
    list of tensors; `peer`: the same names or order, numpy or tensors),
    each leaf keeping its dtype; rounded as JAX's numpy mix (`(1 - w)·a`
    and `w·b` each rounded to the leaf's dtype, then their sum). In place,
    so a CUDA graph that reads these tensors sees the mix. Returns `own`."""
    w = float(weight)
    pairs = (zip(own.values(), (peer[k] for k in own)) if isinstance(own, Mapping)
             else zip(own, peer))
    for t, p in pairs:
        if not isinstance(p, torch.Tensor):
            p = torch.from_numpy(np.array(p))  # a writable copy of a frozen leaf
        t.mul_(1.0 - w).add_(p.to(device=t.device, dtype=t.dtype) * w)
    return own


class FileMailboxWriter:
    """The mailbox thread: polls the ring-scheduled peer's snapshot file and
    deposits fresh versions into the local `ParamMailbox`, off the
    learner's thread (a slow read never holds an update). The learner only
    moves the round (`set_round`) and takes deposits; this thread copies
    host arrays and touches no device tensor."""

    def __init__(self, mailbox_dir: str, rank: int, world: int, template: Sequence[str],
                 mailbox: ParamMailbox, stop: threading.Event, poll_s: float = 0.05):
        self._dir = mailbox_dir
        self._rank = int(rank)
        self._world = int(world)
        self._template = list(template)
        self._mailbox = mailbox
        self._stop = stop
        self._poll_s = float(poll_s)
        # Rebound by the learner's thread (set_round); this thread reads it
        # and tolerates a one-poll-stale round.
        self._round = 0
        # torchlint: thread-owned=mailbox (single writer: poll_once runs on
        # the mailbox thread's loop only, or under fleetsan's scheduler with
        # the thread never started; nothing else reads the per-peer clock)
        self._seen: dict[int, int] = {}
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=f"mailbox-{rank}", daemon=True)

    def set_round(self, round_: int) -> None:
        self._round = int(round_)

    def start(self) -> "FileMailboxWriter":
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread.ident is not None:
            self._thread.join(timeout)

    def poll_once(self) -> bool:
        """One poll of the scheduled peer: read its snapshot, drop versions
        that peer already reached, deposit the rest. True when a deposit
        landed."""
        peer = gossip_peer(self._rank, self._world, self._round)
        out = read_params(self._dir, peer, self._template)
        if out is None:
            return False
        version, params = out
        if version <= self._seen.get(peer, -1):
            return False
        if self._mailbox.deposit(params, version, peer):
            self._seen[peer] = version
            return True
        return False

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self.poll_once()
                self._stop.wait(self._poll_s)
        except BaseException as e:  # surfaced by the learner's loop
            self.error = e


class FleetMonitor:
    """Fleet membership read from the shared mailbox: this rank, the world,
    and each peer's last-publish age (the file's mtime, so a torn file
    still has an age) and version (`read_version`). A peer that never
    published, or whose age exceeds `stale_after_s`, is stale, and
    `snapshot()["ok"]` is False: the serving gateway's `/healthz` under
    `--distributed` then answers 503."""

    def __init__(self, mailbox_dir: str, rank: int, world: int, stale_after_s: float = 30.0):
        self.mailbox_dir = mailbox_dir
        self.rank = int(rank)
        self.world = int(world)
        self.stale_after_s = float(stale_after_s)

    def snapshot(self) -> dict:
        now = time.time()
        peers: dict[str, dict] = {}
        stale: list[int] = []
        for peer in range(self.world):
            if peer == self.rank:
                continue
            path = params_file(self.mailbox_dir, peer)
            entry: dict = {"published": False, "age_s": None, "version": None}
            try:
                entry["age_s"] = round(now - os.stat(path).st_mtime, 3)
                entry["published"] = True
            except OSError:
                pass
            if entry["published"]:
                entry["version"] = read_version(self.mailbox_dir, peer)
            if not entry["published"] or entry["age_s"] > self.stale_after_s:
                stale.append(peer)
            peers[str(peer)] = entry
        return {"rank": self.rank, "world": self.world, "stale_after_s": self.stale_after_s,
                "peers": peers, "stale": stale, "ok": not stale}


# ---------------------------------------------------------------------------
# sync mode's consistency check
# ---------------------------------------------------------------------------


def params_fingerprint(params) -> float:
    """An order-stable float64 digest of a parameter tree: the sum of its
    leaf sums (tensors summed in float64 on their device, numpy leaves in
    float64 on the host). Ranks holding bitwise-equal parameters compute
    the same float, so `make_consistency_check`'s min == max holds exactly;
    one differing bit anywhere almost surely moves it."""
    leaves = list(params.values()) if isinstance(params, Mapping) else list(params)
    if leaves and isinstance(leaves[0], torch.Tensor):
        with torch.no_grad():
            return float(torch.stack([t.detach().double().sum() for t in leaves]).sum())
    return float(sum(np.sum(np.asarray(v, np.float64)) for v in leaves))


def make_consistency_check(group, device) -> Callable[[float, float, float], tuple]:
    """`check(version, fingerprint, vote) -> (version_sum, fp_max, fp_min,
    vote_sum)` over the group's ranks, outside any graph: one SUM
    all-reduce of `[version, vote]` and one MAX all-reduce of
    `[fingerprint, -fingerprint]`, float64 on `device`.

    - `version_sum == world · version` holds iff every rank carries the
      same count (small integers: the float64 sum is exact).
    - The fingerprint compares by max == min == local, exact at any world
      size, where a sum of identical floats would round (three ranks).
    - A nonzero vote sum is the fleet's agreed stop: every rank sees the
      same sum, so a wall-bounded run stops after the same iteration on
      every rank and none is left alone in a collective."""
    import torch.distributed as dist

    def check(version: float, fingerprint: float, vote: float) -> tuple:
        sums = torch.tensor([version, vote], dtype=torch.float64, device=device)
        extremes = torch.tensor([fingerprint, -fingerprint], dtype=torch.float64, device=device)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(extremes, op=dist.ReduceOp.MAX, group=group)
        (vsum, votes), (fp_max, neg_min) = sums.tolist(), extremes.tolist()
        return vsum, fp_max, -neg_min, votes

    return check


# ---------------------------------------------------------------------------
# the per-process driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Gossip mode's knobs (unused in sync mode)."""

    every: int = 1        # consumed blocks between exchanges
    weight: float = 0.5   # the peer's mixing weight in [0, 1]
    poll_s: float = 0.05  # the mailbox thread's poll cadence


def train_multihost(
    pools,
    cfg,
    num_iterations: int,
    *,
    rank: int,
    world: int,
    mode: str = "sync",
    duration_s: Optional[float] = None,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    queue_depth: int = 4,
    max_staleness: Optional[int] = 8,
    updates_per_block: int = 1,
    correction: str = "vtrace",
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    gossip: GossipConfig = GossipConfig(),
    mailbox_dir: Optional[str] = None,
    device="cuda",
    iteration_hook=None,
):
    """One process's share of the multi-process actor-learner (module
    docstring): `len(pools)` actor threads feed the local queue, and the
    learner consumes blocks in `mode` "sync" or "gossip".

    `seed` must be the same on every rank: the initial parameters and the
    learner's generator (the minibatch permutations, which the sync update
    needs equal on every rank) come from it; the actors' streams are
    decorrelated per (rank, actor). With `duration_s` the run is
    wall-bounded (`num_iterations` a cap): in sync mode the stop is voted
    through the consistency check, gossip ranks stop on their own clock.

    Sync mode needs the process group of `world` ranks started
    (`distributed_init`); gossip mode with `world > 1` needs a
    `mailbox_dir` shared by the ranks. Each update is one CUDA graph on the
    card (`host_loop.HostUpdate`, "thread_local" capture; warmed before the
    actors start under a warm-up plan naming
    `ppo.make_async_update_step`, else at its first calls: the same on
    every rank). Before each replay the learner enqueues a copy of its
    parameters and publishes it to its actors after (the update's input,
    as `ppo.train_host_async` does). `iteration_hook(it, run)` is called
    after each block's updates with the `host_loop.HostRun`.

    Returns `(params, history, summary)`: the final parameters as the numpy
    mirror's tree, the logged rows (queue and staleness gauges, and
    `version_sum`/`version_ok`/`fingerprint_ok` in sync mode or
    `gossip_peer`/`gossip_lag` at a gossip mix) and the summary (JAX's
    keys, plus `check_ms`, the consistency check's median host ms a block,
    in sync mode)."""
    from actor_critic_tpu_torch import resolve_device, telemetry
    from actor_critic_tpu_torch.algos import host_loop, ppo
    from actor_critic_tpu_torch.algos.common import named_carried
    from actor_critic_tpu_torch.algos.traj_queue import (
        ActorService,
        PolicyPublisher,
        TrajQueue,
        consume_block,
        validate_pools,
    )
    from actor_critic_tpu_torch.models import host_actor

    if mode not in ("sync", "gossip"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "sync" and correction != "vtrace":
        raise ValueError(
            "sync mode runs the V-trace-corrected data-parallel update (make_async_update_fn "
            "with a group); correction='none' is only available in gossip mode or the "
            "single-host async driver")
    if mode == "gossip" and world > 1 and not mailbox_dir:
        raise ValueError("gossip mode needs a shared mailbox_dir")
    if updates_per_block < 1:
        raise ValueError("updates_per_block must be >= 1")
    spec, E_a = validate_pools(pools)
    device = resolve_device(device)
    group = None
    if mode == "sync":
        import torch.distributed as dist

        ranks = dist.get_world_size() if dist.is_initialized() else 1
        if not dist.is_initialized() or ranks != world:
            raise ValueError(f"sync mode: the process group has {ranks} rank(s) for "
                             f"world={world} — was distributed_init called?")
        group = mesh.world_group()

    net, opt_state = ppo.init_host_params(spec, cfg, seed, device)
    if not host_actor.supports_mirror(host_actor.mirror_params(net)):
        raise ValueError("multi-host mode needs the numpy actor mirror (MLP torso)")
    generator = torch.Generator(device=device).manual_seed(seed)
    schedule = ppo.make_schedule(cfg, device)
    iteration = torch.zeros(1, dtype=torch.int64, device=device)
    host_policy = host_actor.make_ppo_host_policy(spec, cfg)
    host_value = host_actor.make_ppo_host_value(spec, cfg)

    def make_act_fn(actor_params, rng):
        def act(o):
            action, logp, value = host_policy(actor_params, o, rng)
            return action, {"log_prob": logp, "value": value}

        return act

    block_extras = None
    if correction == "none":
        # The GAE update's bootstraps come from the behaviour parameters
        # that gave the recorded values (ppo.train_host_async's contract).
        def block_extras(actor_params, last_obs, block):
            T_, E_ = block["reward"].shape
            fo = block["final_obs"]
            fv = host_value(actor_params, fo.reshape(T_ * E_, *fo.shape[2:])).reshape(T_, E_)
            return {"final_values": fv, "bootstrap_value": host_value(actor_params, last_obs)}

    queue = TrajQueue(depth=queue_depth, max_staleness=max_staleness, policy="drop_oldest",
                      gauge_name=f"traj_queue_host{rank}")
    feed = host_loop.AsyncFeed(queue, cfg.rollout_steps, device)
    update_step = ppo.make_async_update_step(spec, cfg, True, correction, rho_bar, c_bar, group)

    def body() -> dict[str, torch.Tensor]:
        return update_step(net, opt_state, schedule, generator, feed.buffers.static, iteration)

    publisher = PolicyPublisher(host_actor.mirror_params(net), version=0)
    stop, gate = threading.Event(), threading.Event()
    gate.set()
    actors = [
        # Decorrelated across the fleet: the rank strides by a large prime
        # over the per-actor prime stride (JAX's streams).
        ActorService(i, pool, queue, publisher, cfg.rollout_steps, make_act_fn,
                     rng=np.random.default_rng(seed + 0x5EED + rank * 1_000_003 + i * 7919),
                     stop=stop, block_extras=block_extras, gate=gate)
        for i, pool in enumerate(pools)
    ]
    snapshot = host_actor.MirrorSnapshot(net, pin=device.type == "cuda")
    update = host_loop.HostUpdate(
        body, generator, capture_error_mode="thread_local",
        name="multihost.sync_update" if group is not None else "ppo.async_update",
        carried=lambda: named_carried({"params": net, "opt_state": opt_state,
                                       "block": feed.buffers.static}, ""))
    clock = host_loop.IterationClock(device)
    run = host_loop.HostRun(feed.buffers, snapshot, update,
                            {"params": net, "opt_state": opt_state}, clock, queue, gate)
    # Every rank plans the same warm-up from the same flags, so the eager
    # calls and the capture (and their collectives) match across ranks.
    host_loop.warm_update("ppo.make_async_update_step", update, feed.buffers,
                          ppo.async_block_spec(spec, cfg, len(pools), correction), gate)

    params = dict(net.named_parameters())
    check = mailbox = writer = None
    if group is not None:
        check = make_consistency_check(group, device)
    elif world > 1:
        mailbox = ParamMailbox()
        writer = FileMailboxWriter(mailbox_dir, rank, world, template=param_names(net),
                                   mailbox=mailbox, stop=stop, poll_s=gossip.poll_s)
        # The initial parameters, so the peers' first reads succeed.
        write_params(mailbox_dir, rank, 0, param_leaves(net))
        writer.start()

    history: list = []
    metrics: dict = {}
    trackers = host_loop.MergedEpisodeTracker([a.tracker for a in actors])
    summary = {"rank": rank, "world": world, "mode": mode, "version_consistent": True,
               "fingerprint_consistent": True, "gossip_mixes": 0, "gossip_skips": 0,
               "gossip_lag_max": 0}
    check_s: list[float] = []
    t_start = time.perf_counter()
    deadline = None if duration_s is None else t_start + float(duration_s)
    consumed_blocks = 0
    try:
        for a in actors:
            a.start()
        for it in range(num_iterations):
            telemetry.profiler_tick()
            for a in actors:
                if a.error is not None:
                    raise RuntimeError(f"host {rank} actor {a.actor_id} died") from a.error
            if writer is not None and writer.error is not None:
                raise RuntimeError(f"host {rank} mailbox writer died") from writer.error
            with telemetry.span("iteration", it=it + 1):
                queue.set_consumer_version(it)
                with telemetry.span("queue_wait", it=it + 1):
                    block = consume_block(queue, actors, context=f"host {rank} ")
                clock.start(("wait_s", "dispatch_s"))
                t0 = time.perf_counter()
                wait0 = feed.wait_s
                clock.mark()
                host_loop.stage_block(feed, block)
                iteration.fill_(it)
                clock.mark()
                snapshot.enqueue()
                with telemetry.span("update", dispatch="async"):
                    metrics = host_loop.run_updates(update, updates_per_block, gate)
                clock.mark()
                if iteration_hook is not None:
                    iteration_hook(it + 1, run)
                feed.done(block)
                waited = feed.wait_s - wait0
                clock.add("dispatch_s", time.perf_counter() - t0 - waited)
                clock.add("wait_s", waited + host_loop.publish_snapshot(snapshot, publisher, it))
                version = it + 1
                extra: dict = {}
                if check is not None:
                    vote = 1.0 if deadline is not None and time.perf_counter() >= deadline else 0.0
                    fp = params_fingerprint(params)
                    tc = time.perf_counter()
                    vsum, fp_max, fp_min, votes = check(float(version), fp, vote)
                    check_s.append(time.perf_counter() - tc)
                    stop_after = votes > 0
                    v_ok = vsum == world * float(version)
                    fp_ok = fp_max == fp_min == fp
                    summary["version_consistent"] &= v_ok
                    summary["fingerprint_consistent"] &= fp_ok
                    extra.update(version_sum=vsum, version_ok=v_ok, fingerprint_ok=fp_ok)
                else:
                    stop_after = deadline is not None and time.perf_counter() >= deadline
                    if mailbox is not None and version % gossip.every == 0:
                        writer.set_round(version // gossip.every)
                        deposit = mailbox.take()
                        if deposit is not None:
                            peer_version, peer, peer_params = deposit
                            lag = max(version - peer_version, 0)
                            # Between two replays, in stream order after this
                            # block's: the graph reads the mixed tensors.
                            mix_params(params, peer_params, gossip.weight)
                            summary["gossip_mixes"] += 1
                            summary["gossip_lag_max"] = max(summary["gossip_lag_max"], lag)
                            extra.update(gossip_peer=peer, gossip_lag=lag)
                        else:
                            summary["gossip_skips"] += 1
                        write_params(mailbox_dir, rank, version, param_leaves(net))
                extra.update(host_loop.async_row(it, block, queue, actors, cfg.rollout_steps * E_a))
                host_loop.maybe_log(
                    it, log_every, metrics, trackers, history, log_fn, extra=extra,
                    num_iterations=0 if deadline is not None else num_iterations,
                    force=it == 0, clock=clock)
                consumed_blocks = version
                if stop_after:
                    break
    finally:
        host_loop.stop_actors(stop, actors, queue)
        if writer is not None:
            writer.join(timeout=5.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_start
    consumed = consumed_blocks * cfg.rollout_steps * E_a
    summary.update(
        consumed_blocks=consumed_blocks,
        wall_s=round(wall, 3),
        consumed_env_steps=consumed,
        consumed_steps_per_s=round(consumed / wall, 1) if wall > 0 else 0.0,
        collected_env_steps=sum(a.steps_collected for a in actors),
        learner_idle_s=round(queue.stats()["learner_idle_s"], 3),
    )
    if check_s:
        summary["check_ms"] = round(1e3 * float(np.median(check_s)), 3)
    return host_actor.mirror_params(net), history, summary
