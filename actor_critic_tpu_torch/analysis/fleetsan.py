"""fleetsan: deterministic multi-process chaos sanitizer for the mailbox,
gossip and gateway stack (counterpart of `actor_critic_tpu/analysis/fleetsan.py`).

racesan makes THREAD interleavings seeded and replayable; fleetsan lifts
the same contract to PROCESS granularity. A seeded `ChaosScheduler` steps
a fleet of simulated hosts, each one driving the port's own protocol
objects (`parallel/multihost.py`: `write_params`/`read_params`,
`FileMailboxWriter.poll_once` with its thread never started,
`ParamMailbox`, `gossip_peer`, `mix_params`; `serving/policy_store.py`:
`PolicyStore.swap`; `serving/fleet_proxy.py`:
`MailboxPolicySyncer.poll_once`), one atomic action at a time,
interleaving publishes at their crash points and injecting faults from a
seeded menu:

- **SIGKILL mid-publish**: the victim writes its temporary file and dies
  before the rename (the window `os.replace` protects);
- **restart and rejoin**: a dead rank comes back, resumes its version
  clock from its own published file, and must diffuse through the ring
  again within a bounded number of rounds (time to recover, in rounds per
  schedule; `run_process_chaos` measures it in seconds);
- **torn files**: a published snapshot truncated to a seeded byte count;
  consumers must read None and retry, and the next publish repairs it;
- **reordered delivery**: a stale complete snapshot re-placed over a newer
  one; per-peer version clocks must refuse to regress;
- **duplicate snapshots**: the same version delivered again; latest-wins
  hands it to the learner at most once.

Every parse of every mailbox file is checked at every interleave point:
payloads encode `(rank, version)` into a uniform fill (`_encode`), so a
torn file that still parses, a cross-rank tempfile collision and a version
regression are detected at the read. Reverted modes reproduce the bug
classes: `writer="direct"` (no tmp + rename: caught on every schedule),
`writer="shared_tmp"` (one tmp name for all ranks: the collision is found
within a few seeds and replays from its seed) and `poller="naive"` (a
consumer without per-peer clocks: the reorder injector regresses the
gateway on every schedule).

The schedule is decided by Python's `random.Random(seed)` and by the sizes
of the mailbox files, and the port writes JAX's file format (`leaf<i>` and
`version` in an `.npz`, a pid-named tmp, `os.replace`): a seed gives the
JAX package's schedule, trace and counts. The port's mailbox names its
leaves (`read_params` and `FileMailboxWriter` take the parameter names as
their template where JAX's take a tree) and mixes into torch tensors in
place; nothing else differs.

`run_process_chaos` is the real-process injector: it spawns a gossip fleet
of `python -m actor_critic_tpu_torch.parallel.launch --worker` processes
on `device` (the card unless "cpu"), SIGKILLs one rank mid-run, restarts
it and measures the wall time until its first republished snapshot.

    python -m actor_critic_tpu_torch.analysis.fleetsan --device cpu       # quick profile
    python -m actor_critic_tpu_torch.analysis.fleetsan --scenario fleet --writer direct
    python -m actor_critic_tpu_torch.analysis.fleetsan --scenario process  # real workers, card

Exit codes: 0 clean, 1 violation (a protocol break or an unbounded
recovery: the sanitizer working), 2 crash or usage error.
"""

from __future__ import annotations

import io
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np

_SHAPE = (2, 2)
# The mailbox's leaf names for `_payload`'s tree (the port's template).
_TEMPLATE = ("w",)


class FleetSanError(RuntimeError):
    """A detected protocol violation, or a schedule that failed to recover
    within its liveness bound."""


def _encode(rank: int, version: int) -> float:
    """The uniform fill of rank's version-v snapshot: a payload is a
    function of (rank, version), so any parse can be verified without other
    state, and a foreign or torn payload mismatches at once."""
    return float(rank * 1000 + version)


def _payload(rank: int, version: int) -> dict:
    return {"w": np.full(_SHAPE, _encode(rank, version), np.float32)}


def _npz_bytes(version: int, payload: dict) -> bytes:
    """The bytes `write_params` would publish for `payload` (the reverted
    writers write them without its tmp + rename)."""
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf{i}": v for i, v in enumerate(payload.values())},
             version=np.asarray(int(version), np.int64))
    return buf.getvalue()


def _uniform_as(w, value: float) -> bool:
    w = np.asarray(w)
    return bool(np.all(w == w.flat[0])) and float(w.flat[0]) == value


# ---------------------------------------------------------------------------
# simulated hosts (the port's protocol objects, a scripted learner)
# ---------------------------------------------------------------------------


class _SimHost:
    """One rank of the simulated fleet: a scripted learner loop over the
    port's mailbox objects. `actions()` yields one atomic action at a time;
    the scheduler interleaves hosts between actions, and a publish is split
    at its crash and interleave points."""

    def __init__(self, rank: int, world: int, mailbox_dir: str, writer: str = "atomic",
                 on_publish: Optional[Callable[["_SimHost"], None]] = None):
        from actor_critic_tpu_torch.parallel.multihost import (
            FileMailboxWriter,
            ParamMailbox,
            read_params,
        )

        self.on_publish = on_publish or (lambda host: None)
        self.rank = int(rank)
        self.world = int(world)
        self.dir = mailbox_dir
        self.writer = writer
        self.mailbox = ParamMailbox()
        # Its thread is never started: the scheduler drives poll_once (the
        # real consume logic) itself.
        self.poller = FileMailboxWriter(mailbox_dir, rank, world, template=_TEMPLATE,
                                        mailbox=self.mailbox, stop=threading.Event())
        # Restart and rejoin: the version clock resumes from this rank's own
        # published file, as a restarted process's does.
        own = read_params(mailbox_dir, rank, _TEMPLATE)
        self.version = own[0] if own is not None else 0
        self.taken: dict[int, int] = {}  # per-peer consume clock
        self.takes = 0
        self.deposits = 0

    # -- publish variants (each yields at its interleave points) ------------

    def _publish_atomic(self):
        from actor_critic_tpu_torch.parallel.multihost import write_params

        write_params(self.dir, self.rank, self.version, _payload(self.rank, self.version))
        self.on_publish(self)
        yield "publish"

    def _publish_direct(self):
        """REVERTED writer: the consumed path written in place, torn at the
        interleave point, where the checker reads the half-written file on
        every schedule."""
        from actor_critic_tpu_torch.parallel.multihost import params_file

        path = params_file(self.dir, self.rank)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = _npz_bytes(self.version, _payload(self.rank, self.version))
        # torchlint: disable=mailbox-protocol (the reverted direct writer under test)
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
        yield "publish:half"
        with open(path, "ab") as f:
            f.write(data[len(data) // 2:])
        self.on_publish(self)
        yield "publish:done"

    def _publish_shared_tmp(self):
        """REVERTED writer: one tmp name for the whole mailbox, so two ranks
        publishing at once rename each other's payloads into place."""
        from actor_critic_tpu_torch.parallel.multihost import params_file

        path = params_file(self.dir, self.rank)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = os.path.join(self.dir, "pending.tmp")
        # torchlint: disable=mailbox-protocol (the reverted shared-tmp writer under test)
        with open(tmp, "wb") as f:
            f.write(_npz_bytes(self.version, _payload(self.rank, self.version)))
        yield "publish:tmp"
        try:
            os.replace(tmp, path)
        except FileNotFoundError:
            # The collision's other face: another rank renamed our shared tmp
            # into ITS path, so our payload went out under a foreign rank.
            raise FleetSanError(
                f"rank {self.rank}: shared tmp vanished mid-publish — a concurrent rank "
                "renamed it into its own path (tempfile collision: tmp names must be "
                "process-unique)")
        self.on_publish(self)
        yield "publish:done"

    def publish_kill(self):
        """SIGKILL mid-publish: the tmp lands, the rename never runs; the
        stale tmp must be harmless and the published file must still hold
        the previous complete snapshot."""
        from actor_critic_tpu_torch.parallel.multihost import params_file

        path = params_file(self.dir, self.rank)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # torchlint: disable=mailbox-protocol (a writer killed before its fsync
        # and rename: the fault under test)
        with open(f"{path}.tmp.{os.getpid()}", "wb") as f:
            f.write(_npz_bytes(self.version, _payload(self.rank, self.version)))

    # -- one learner round --------------------------------------------------

    def actions(self, verify: Callable[["_SimHost", tuple], None]):
        self.version += 1
        publish = {"atomic": self._publish_atomic, "direct": self._publish_direct,
                   "shared_tmp": self._publish_shared_tmp}.get(self.writer)
        if publish is None:
            raise ValueError(f"unknown writer mode {self.writer!r}")
        yield from publish()
        self.poller.set_round(self.version)
        if self.poller.poll_once():
            self.deposits += 1
        yield "poll"
        out = self.mailbox.take()
        if out is not None:
            verify(self, out)
            self.takes += 1
        yield "take"


# ---------------------------------------------------------------------------
# the chaos scheduler
# ---------------------------------------------------------------------------


class ChaosScheduler:
    """Seeded process-granularity scheduler: each global round every live
    host contributes its action generator, the controller its fault
    actions, and the seeded RNG picks who advances next, so a seed replays
    its interleaving and its faults. No wall clock: time to recover is
    counted in rounds."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.trace: list[tuple] = []

    def interleave(self, gens: dict[str, Any], round_: int) -> None:
        """Advance the named generators one action at a time in seeded order
        until all are exhausted. `gens` is worked on IN PLACE, so a fault
        action can remove another participant mid-round (a SIGKILLed host
        stops at its current action)."""
        while gens:
            name = sorted(gens)[self.rng.randrange(len(gens))]
            try:
                tag = next(gens[name])
                self.trace.append((round_, name, tag))
            except StopIteration:
                gens.pop(name, None)


def _tear(path: str, rng: random.Random) -> None:
    """Truncate `path` to a seeded byte count in [1, size)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(rng.randrange(1, max(size, 2)))


def _replace_with(path: str, data: bytes) -> None:
    """Re-place `path` with `data` atomically (the reorder and duplicate
    injectors: a stale complete snapshot delivered late)."""
    tmp = f"{path}.tmp.reorder"
    # torchlint: disable=mailbox-protocol (the injector of a late stale
    # snapshot: one process, no crash to survive)
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)  # torchlint: disable=mailbox-protocol (the same injector)


# ---------------------------------------------------------------------------
# fleet exerciser
# ---------------------------------------------------------------------------


def exercise_fleet(seed: int, world: int = 3, rounds: int = 10, writer: str = "atomic",
                   faults: bool = True, recover_bound: int = 12) -> dict:
    """One seeded chaos schedule over a simulated gossip fleet of `world`
    ranks sharing a real on-disk mailbox. A detection raises FleetSanError;
    a clean schedule returns the report (its trace the same for every run
    of the seed)."""
    import torch

    from actor_critic_tpu_torch.parallel.multihost import mix_params, params_file, read_params

    sched = ChaosScheduler(seed)
    report: dict = {
        "seed": seed, "world": world, "rounds": rounds, "writer": writer,
        "takes": 0, "deposits": 0, "faults": [], "kills": 0,
        "recover_rounds": [], "violations": 0,
    }
    with tempfile.TemporaryDirectory(prefix="fleetsan_") as mailbox:
        # rank -> newest version fully published (set by the publish actions
        # themselves, so a file torn AFTER a publish is never re-marked
        # complete); rank -> True while an injected fault tore the file.
        complete: dict[int, int] = {}
        injector_torn: dict[int, bool] = {r: False for r in range(world)}

        def on_publish(host: _SimHost) -> None:
            complete[host.rank] = host.version
            injector_torn[host.rank] = False

        hosts: dict[int, Optional[_SimHost]] = {
            r: _SimHost(r, world, mailbox, writer=writer, on_publish=on_publish)
            for r in range(world)
        }
        pending: dict[int, tuple[int, int]] = {}  # rank -> (restart round, version at kill)
        dead: dict[int, tuple[int, int]] = {}  # rank -> (revive round, version)
        saved: dict[int, bytes] = {}  # reorder and duplicate ammunition

        def violation(msg: str) -> FleetSanError:
            report["violations"] += 1
            return FleetSanError(f"seed {seed}: {msg}")

        def verify(host: _SimHost, out: tuple) -> None:
            version, peer, params = out
            if version <= host.taken.get(peer, -1):
                raise violation(
                    f"host {host.rank} took version {version} from peer {peer} after "
                    f"{host.taken[peer]} — per-peer monotonicity violated (reordered/duplicate "
                    "delivery reached the learner)")
            host.taken[peer] = version
            w = np.asarray(params["w"])
            if not _uniform_as(w, _encode(peer, version)):
                raise violation(
                    f"host {host.rank} took a corrupt snapshot claiming (peer={peer}, "
                    f"v={version}): uniform={bool(np.all(w == w.flat[0]))}, "
                    f"value={float(w.flat[0])!r}, expected {_encode(peer, version)} — torn "
                    "write or cross-rank tempfile collision")
            # The mixing itself must keep the fill uniform.
            own = {"w": torch.from_numpy(_payload(host.rank, host.version)["w"])}
            mw = mix_params(own, params, 0.5)["w"]
            if not bool(torch.all(mw == mw.flatten()[0])):
                raise violation("mix_params broke uniformity")
            # Fresh post-restart news from a killed rank closes its window.
            if peer in pending and version > pending[peer][1]:
                restart_round, _ = pending.pop(peer)
                report["recover_rounds"].append(max(round_now[0] - restart_round, 0))

        def check_files() -> None:
            """The torn-publish detector, run at EVERY interleave point: a
            rank that completed a publish always presents a parseable
            snapshot whose payload matches its (rank, version), unless an
            injected fault (not the writer under test) tore it."""
            for r in range(world):
                if injector_torn[r] or r not in complete:
                    continue
                out = read_params(mailbox, r, _TEMPLATE)
                if out is None:
                    raise violation(
                        f"rank {r}'s mailbox file is unreadable although version "
                        f"{complete[r]} was fully published — the writer tore the consumed "
                        "path (atomic write→fsync→rename violated)")
                version, tree = out
                w = np.asarray(tree["w"])
                if not _uniform_as(w, _encode(r, version)):
                    raise violation(
                        f"rank {r}'s mailbox file claims version {version} but carries value "
                        f"{float(w.flat[0])!r} (expected {_encode(r, version)}) — a foreign "
                        "rank's payload was renamed into place (tempfile collision)")

        def checked(gen):
            """A host generator with the file checker at each of its points."""
            for tag in gen:
                check_files()
                yield tag

        def chaos_actions(round_: int):
            """The controller's seeded faults for this round."""
            if not faults:
                return
            live = [r for r, h in hosts.items() if h is not None]
            roll = sched.rng.random()
            if roll < 0.25 and len(live) > 1 and not dead and not pending:
                victim = live[sched.rng.randrange(len(live))]
                host = hosts[victim]
                host.version += 1
                host.publish_kill()  # tmp written, the rename never runs
                hosts[victim] = None
                # SIGKILL is immediate: the victim's generator must not run on
                # this round as a zombie (a full publish after "dying" would
                # mask a stuck peer and zero the recovery window).
                round_gens.pop(f"host{victim}", None)
                dead[victim] = (round_ + 1 + sched.rng.randrange(2), host.version - 1)
                report["kills"] += 1
                report["faults"].append((round_, "kill", victim))
                yield f"kill:host{victim}"
            elif roll < 0.45 and complete:
                ranks = sorted(complete)
                victim = ranks[sched.rng.randrange(len(ranks))]
                try:
                    _tear(params_file(mailbox, victim), sched.rng)
                    injector_torn[victim] = True
                    complete.pop(victim, None)
                    report["faults"].append((round_, "torn", victim))
                    yield f"torn:host{victim}"
                except OSError:
                    pass
            elif roll < 0.60 and complete:
                # Save a complete snapshot now; re-placing it later is the
                # reorder and duplicate fault.
                ranks = sorted(complete)
                victim = ranks[sched.rng.randrange(len(ranks))]
                try:
                    with open(params_file(mailbox, victim), "rb") as f:
                        saved[victim] = f.read()
                    report["faults"].append((round_, "save", victim))
                    yield f"save:host{victim}"
                except OSError:
                    pass
            elif roll < 0.80 and saved:
                ranks = sorted(saved)
                victim = ranks[sched.rng.randrange(len(ranks))]
                _replace_with(params_file(mailbox, victim), saved[victim])
                report["faults"].append((round_, "replay", victim))
                yield f"replay:host{victim}"

        round_now = [0]
        # This round's interleave set, shared with chaos_actions so a kill
        # can remove the victim's generator mid-round.
        round_gens: dict[str, Any] = {}
        for round_ in range(rounds + recover_bound):
            round_now[0] = round_
            # Revive due ranks. The version clock resumes from the rank's own
            # file, floored at its pre-kill value (the consumed-block clock
            # rides the local checkpoint: a torn or stale mailbox file must not
            # rewind it below what peers saw, or their clocks mute it).
            for r, (due, v_at_kill) in sorted(dead.items()):
                if round_ >= due:
                    h = _SimHost(r, world, mailbox, writer=writer, on_publish=on_publish)
                    h.version = max(h.version, v_at_kill)
                    hosts[r] = h
                    pending[r] = (round_, v_at_kill)
                    dead.pop(r)
                    sched.trace.append((round_, "chaos", f"restart:host{r}"))
            if round_ >= rounds and not pending and not dead:
                break  # the drain is over: every kill recovered
            round_gens.clear()
            round_gens.update({f"host{r}": checked(h.actions(verify))
                               for r, h in hosts.items() if h is not None})
            if round_ < rounds:
                round_gens["chaos"] = chaos_actions(round_)
            sched.interleave(round_gens, round_)
        if pending:
            raise FleetSanError(
                f"seed {seed}: rank(s) {sorted(pending)} restarted but their fresh snapshots "
                f"never reached a peer within {recover_bound} drain rounds — ring diffusion "
                "broken (time-to-recover unbounded)")
        report["takes"] = sum(h.takes for h in hosts.values() if h is not None)
        report["deposits"] = sum(h.deposits for h in hosts.values() if h is not None)
    report["trace"] = list(sched.trace)
    report["trace_len"] = len(sched.trace)
    return report


# ---------------------------------------------------------------------------
# gateway swap exerciser
# ---------------------------------------------------------------------------


class _StubSwapEngine:
    """A torch-free engine for the swap path: `prepare_params` snapshots and
    freezes, so the store's install contract is the device engine's."""

    max_rows = 8

    def prepare_params(self, params: Any) -> Any:
        out = {k: np.array(v) for k, v in params.items()}
        for v in out.values():
            v.flags.writeable = False
        return out

    def act(self, params: Any, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs)[:, 0] * params["w"].flat[0]


def _stale_replay(sched: ChaosScheduler, report: dict, path_of: Callable[[], str],
                  versions: int, saved: dict, duplicate: bool):
    """The gateway and replica fault script, with seeded placement: save an
    early complete snapshot, maybe tear the live file mid-stream, then
    replay the stale save after the final publish (and, with `duplicate`,
    once more), so every schedule exercises the regression path."""
    for _ in range(versions * 4):
        if report["published"] >= 2:
            break
        yield "idle"
    path = path_of()
    with open(path, "rb") as f:
        saved[0] = f.read()
    report["faults"].append("save")
    yield "save"
    if sched.rng.random() < 0.5:
        _tear(path, sched.rng)
        report["faults"].append("torn")
        yield "torn"
    for _ in range(versions * 4):
        if report["published"] >= versions:
            break
        yield "idle"
    _replace_with(path, saved[0])
    report["faults"].append("replay")
    yield "replay"
    if duplicate:
        _replace_with(path, saved[0])
        report["faults"].append("duplicate")
        yield "duplicate"


def exercise_gateway(seed: int, versions: int = 8, poller: str = "guarded") -> dict:
    """One seeded chaos schedule over the serve-while-training swap path: a
    publisher rank publishes `(version, params)` snapshots through the file
    mailbox; a gateway-side consumer polls them (through the real
    `FileMailboxWriter.poll_once` + `ParamMailbox` when `poller="guarded"`)
    and installs fresh versions into a real `PolicyStore` by `swap`. The
    controller tears files and replays stale snapshots. Invariants: the
    resident version never regresses, and its params match the version
    they claim. `poller="naive"` is the REVERTED consumer (read then swap,
    no per-peer clock), which the replay regresses on every schedule."""
    from actor_critic_tpu_torch.parallel.multihost import (
        FileMailboxWriter,
        ParamMailbox,
        params_file,
        read_params,
        write_params,
    )
    from actor_critic_tpu_torch.serving.policy_store import PolicyStore

    if poller not in ("guarded", "naive"):
        raise ValueError(f"unknown poller mode {poller!r}")
    sched = ChaosScheduler(seed)
    report = {"seed": seed, "poller": poller, "swaps": 0, "published": 0, "faults": [],
              "violations": 0}
    with tempfile.TemporaryDirectory(prefix="fleetsan_gw_") as mailbox:
        store = PolicyStore()
        store.register("default", _StubSwapEngine(), _payload(0, 0))
        pmailbox = ParamMailbox()
        consumer = FileMailboxWriter(mailbox, rank=1, world=2, template=_TEMPLATE,
                                     mailbox=pmailbox, stop=threading.Event())
        saved: dict[int, bytes] = {}
        last_version = [0]

        def install(version: int, params: Any) -> None:
            handle = store.swap("default", params, version=version)
            if handle.version < last_version[0]:
                report["violations"] += 1
                raise FleetSanError(
                    f"seed {seed}: gateway swapped BACK from version {last_version[0]} to "
                    f"{handle.version} — a reordered/duplicate snapshot regressed the resident "
                    "policy (per-peer version clock missing at the consume site)")
            w = np.asarray(handle.params["w"])
            if not _uniform_as(w, _encode(0, version)):
                report["violations"] += 1
                raise FleetSanError(
                    f"seed {seed}: resident policy at version {version} carries value "
                    f"{float(w.flat[0])!r}, expected {_encode(0, version)} — torn install")
            last_version[0] = handle.version
            report["swaps"] += 1

        def poll_step() -> None:
            """ONE consumer poll, after EVERY scheduler action."""
            if poller == "guarded":
                if consumer.poll_once():
                    out = pmailbox.take()
                    if out is not None:
                        install(out[0], out[2])
            else:
                # REVERTED consumer: whatever the file says now is swapped in.
                out = read_params(mailbox, 0, _TEMPLATE)
                if out is not None:
                    install(*out)

        def publisher():
            for v in range(1, versions + 1):
                write_params(mailbox, 0, v, _payload(0, v))
                report["published"] = v
                yield f"publish:{v}"

        live: dict[str, Any] = {
            "publisher": publisher(),
            "chaos": _stale_replay(sched, report, lambda: params_file(mailbox, 0), versions,
                                   saved, duplicate=True),
        }
        while live:
            name = sorted(live)[sched.rng.randrange(len(live))]
            try:
                tag = next(live[name])
                sched.trace.append((0, name, tag))
            except StopIteration:
                del live[name]
                continue
            poll_step()
            sched.trace.append((0, "gateway", "poll"))
        # Drain: a torn or stale final file is repaired by publishing the
        # newest version again (what the next training step would do).
        for _ in range(versions * 20):
            if last_version[0] >= versions:
                break
            write_params(mailbox, 0, versions, _payload(0, versions))
            poll_step()
        if last_version[0] < versions:
            raise FleetSanError(
                f"seed {seed}: gateway never converged to version {versions} (stuck at "
                f"{last_version[0]}) — the swap path lost the newest snapshot")
    report["trace"] = list(sched.trace)
    report["trace_len"] = len(sched.trace)
    return report


# ---------------------------------------------------------------------------
# replica-fleet swap exerciser
# ---------------------------------------------------------------------------


def exercise_replica_fleet(seed: int, versions: int = 8, replicas: int = 3) -> dict:
    """One seeded replica-kill-mid-swap schedule over the scale-out
    propagation path: a trainer rank publishes snapshots through the file
    mailbox while N replica gateways consume them through the real
    `MailboxPolicySyncer.poll_once` (its thread never started) into N real
    `PolicyStore`s. The controller injects the gateway's fault script plus a
    replica SIGKILL at a seeded point, and a later restart with a cold store
    and a reset version clock (a respawned serve process).

    Invariants, checked after EVERY action on the polled replica: the
    resident params match the version they claim; a replica's version never
    regresses within one process lifetime; every replica, the restarted one
    too, converges to the final version within the bounded drain."""
    from actor_critic_tpu_torch.parallel.multihost import params_file, write_params
    from actor_critic_tpu_torch.serving.fleet_proxy import MailboxPolicySyncer
    from actor_critic_tpu_torch.serving.policy_store import PolicyStore

    sched = ChaosScheduler(seed)
    report = {"seed": seed, "replicas": replicas, "swaps": 0, "published": 0, "kills": 0,
              "faults": [], "violations": 0}
    with tempfile.TemporaryDirectory(prefix="fleetsan_rf_") as mailbox:

        def make_replica() -> dict:
            store = PolicyStore()
            store.register("default", _StubSwapEngine(), _payload(0, 0))
            return {
                "store": store,
                # The stub's tree is the mailbox's named leaves as they are.
                "syncer": MailboxPolicySyncer(store, "default", mailbox, rank=0,
                                              template=_TEMPLATE, convert=dict),
                # Newest resident version THIS process lifetime (a restart
                # resets it).
                "last": 0,
            }

        fleet = {i: make_replica() for i in range(replicas)}

        def check(idx: int, rep: dict) -> None:
            handle = rep["store"].get("default")
            if handle.version < rep["last"]:
                report["violations"] += 1
                raise FleetSanError(
                    f"seed {seed}: replica {idx} regressed from version {rep['last']} to "
                    f"{handle.version} — a reordered/duplicate snapshot got past the syncer's "
                    "version clock")
            w = np.asarray(handle.params["w"])
            if handle.version > 0 and not _uniform_as(w, _encode(0, handle.version)):
                report["violations"] += 1
                raise FleetSanError(
                    f"seed {seed}: replica {idx} serves version {handle.version} with value "
                    f"{float(w.flat[0])!r}, expected {_encode(0, handle.version)} — a torn "
                    "policy reached the store")
            rep["last"] = handle.version

        def poll(idx: int) -> None:
            rep = fleet.get(idx)
            if rep is None:  # killed: nothing to poll
                return
            if rep["syncer"].poll_once():
                report["swaps"] += 1
            check(idx, rep)

        def publisher():
            for v in range(1, versions + 1):
                write_params(mailbox, 0, v, _payload(0, v))
                report["published"] = v
                yield f"publish:{v}"

        def killer():
            """SIGKILL one replica at a seeded point and restart it a seeded
            number of actions later, cold: if the mailbox holds the stale
            replay then, the rejoiner swaps it in, and must still converge."""
            victim = sched.rng.randrange(replicas)
            for _ in range(sched.rng.randrange(1, versions * 2)):
                yield "idle"
            fleet.pop(victim, None)
            report["kills"] += 1
            report["faults"].append(f"kill:{victim}")
            yield f"kill:{victim}"
            for _ in range(sched.rng.randrange(1, versions)):
                yield "idle"
            fleet[victim] = make_replica()
            report["faults"].append(f"restart:{victim}")
            yield f"restart:{victim}"

        saved: dict[int, bytes] = {}
        live: dict[str, Any] = {
            "publisher": publisher(),
            "chaos": _stale_replay(sched, report, lambda: params_file(mailbox, 0), versions,
                                   saved, duplicate=False),
            "killer": killer(),
        }
        while live:
            name = sorted(live)[sched.rng.randrange(len(live))]
            try:
                tag = next(live[name])
                sched.trace.append((0, name, tag))
            except StopIteration:
                del live[name]
                continue
            # ONE seeded replica polls per action.
            idx = sched.rng.randrange(replicas)
            poll(idx)
            sched.trace.append((0, f"replica{idx}", "poll"))
        # Drain: repair the final file as the next publish would, and poll
        # every survivor until the fleet converges (bounded).
        for _ in range(versions * 20):
            if all(r["last"] >= versions for r in fleet.values()):
                break
            write_params(mailbox, 0, versions, _payload(0, versions))
            for idx in sorted(fleet):
                poll(idx)
        laggards = {i: r["last"] for i, r in fleet.items() if r["last"] < versions}
        if laggards:
            raise FleetSanError(
                f"seed {seed}: replicas never converged to version {versions}: {laggards} — "
                "the propagation path lost the newest snapshot")
    report["trace"] = list(sched.trace)
    report["trace_len"] = len(sched.trace)
    return report


# ---------------------------------------------------------------------------
# sweep + the quick profile
# ---------------------------------------------------------------------------


def exercise_sweep(seeds: Iterable[int], scenario: Callable[[int], dict]) -> dict:
    reports = [scenario(seed) for seed in seeds]
    return {
        "schedules": len(reports),
        "takes": sum(r.get("takes", 0) for r in reports),
        "deposits": sum(r.get("deposits", 0) for r in reports),
        "swaps": sum(r.get("swaps", 0) for r in reports),
        "kills": sum(r.get("kills", 0) for r in reports),
        "faults": sum(len(r.get("faults", ())) for r in reports),
        "recover_rounds_max": max((x for r in reports for x in r.get("recover_rounds", ())),
                                  default=0),
        "violations": sum(r.get("violations", 0) for r in reports),
    }


def quick_profile(schedules: int = 40, seed0: int = 0) -> dict:
    """The fast profile: `schedules` seeded schedules split between the
    gossip fleet (atomic writer, the full fault menu, recovery bounded) and
    the gateway swap (guarded poller); every one must sweep clean. Files
    only, no device."""
    half = max(schedules // 2, 1)
    fleet = exercise_sweep(range(seed0, seed0 + half),
                           lambda s: exercise_fleet(s, writer="atomic", faults=True))
    gateway = exercise_sweep(range(seed0, seed0 + (schedules - half)),
                             lambda s: exercise_gateway(s, poller="guarded"))
    return {
        "schedules": fleet["schedules"] + gateway["schedules"],
        "fleet": fleet,
        "gateway": gateway,
        "violations": fleet["violations"] + gateway["violations"],
    }


# ---------------------------------------------------------------------------
# the real-process injector
# ---------------------------------------------------------------------------


def run_process_chaos(
    world: int = 2,
    duration_s: float = 8.0,
    kill_after_s: float = 3.0,
    restart_after_s: float = 0.5,
    kill_rank: int = 1,
    timeout_s: float = 180.0,
    seed: int = 0,
    telemetry_dir: Optional[str] = None,
    device: str = "cuda",
    env: str = "",
) -> dict:
    """SIGKILL a REAL gossip worker mid-run and measure the wall time to
    recover: spawn `world` gossip workers (`python -m
    actor_critic_tpu_torch.parallel.launch --worker --mode gossip`, each a
    small PPO learner on `device`) against a shared mailbox, SIGKILL rank
    `kill_rank` `kill_after_s` in (mid-publish in expectation: gossip
    publishes every consumed block), restart it after `restart_after_s`,
    and time until its FIRST post-restart snapshot lands in the mailbox.
    `env` is the workers' pool (`--env`; default the sleep-padded CartPole,
    which needs gymnasium; the C++ engine's `native:CartPole-v1` where it
    is missing).

    With `telemetry_dir` every worker records under `<dir>/host<rank>`; the
    kill clock starts once the victim's flight ring holds records, and the
    victim's ring is harvested into `flight_dump_sigkill_harvest.json`
    before the restart zeroes it. The record carries each worker's summary
    line, with the kernels' launches on the card (`launches`)."""
    from actor_critic_tpu_torch.parallel import launch
    from actor_critic_tpu_torch.parallel.multihost import params_file
    from actor_critic_tpu_torch.telemetry import flight

    def spawn(rank: int, dur: float, mailbox: str):
        cmd = [
            sys.executable, "-m", "actor_critic_tpu_torch.parallel.launch", "--worker",
            "--rank", str(rank), "--processes", str(world),
            "--mode", "gossip", "--mailbox-dir", mailbox,
            "--duration-s", str(dur), "--iterations", "0",
            "--rollout-steps", "8", "--num-envs", "2", "--actors", "1",
            "--sleep-s", "0.004", "--epochs", "1", "--minibatches", "1",
            "--seed", str(seed), "--device", device,
        ]
        if env:
            cmd += ["--env", env]
        if telemetry_dir:
            cmd += ["--telemetry-dir", telemetry_dir]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=launch.worker_env(), cwd=launch.ROOT)

    def ring_of(rank: int) -> str:
        return os.path.join(telemetry_dir, f"host{rank}", flight.RING_FILENAME)

    mailbox = tempfile.mkdtemp(prefix="fleetsan_chaos_")
    record: dict = {"world": world, "killed_rank": kill_rank, "kill_after_s": kill_after_s,
                    "restart_after_s": restart_after_s, "duration_s": duration_s,
                    "device": device}
    procs: dict[int, subprocess.Popen] = {}
    try:
        t0 = time.monotonic()
        for r in range(world):
            procs[r] = spawn(r, duration_s, mailbox)
        if telemetry_dir:
            # Start the kill clock once the victim records: a worker's start
            # (torch, the card, the session) can dwarf kill_after_s, and a
            # kill before the flight ring exists proves nothing.
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                if flight.harvest(ring_of(kill_rank)) or procs[kill_rank].poll() is not None:
                    break
                time.sleep(0.05)
        time.sleep(kill_after_s)
        victim = procs[kill_rank]
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        t_kill = time.monotonic()
        record["killed_at_s"] = round(t_kill - t0, 3)
        if telemetry_dir:
            # The post-mortem harvest, BEFORE the restart recreates (zeroes)
            # the rank's ring: every record here survived SIGKILL in the
            # mmap'd ring alone.
            records = flight.harvest(ring_of(kill_rank))
            if not records:
                raise FleetSanError(
                    f"SIGKILL'd rank {kill_rank} left no harvestable flight-ring records at "
                    f"{ring_of(kill_rank)} — the crash recorder lost the victim's final seconds")
            record["flight_dump"] = flight.write_dump(
                os.path.join(telemetry_dir, f"host{kill_rank}",
                             "flight_dump_sigkill_harvest.json"),
                records, reason="sigkill_harvest",
                meta={"rank": kill_rank, "seed": seed, "world": world})
            record["flight_records"] = len(records)
        time.sleep(restart_after_s)
        path = params_file(mailbox, kill_rank)
        try:
            mtime_before = os.stat(path).st_mtime
        except OSError:
            mtime_before = 0.0
        remaining = max(duration_s - (time.monotonic() - t0), 2.0)
        procs[kill_rank] = spawn(kill_rank, remaining, mailbox)
        t_rec = None
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if os.stat(path).st_mtime > mtime_before:
                    t_rec = time.monotonic()
                    break
            except OSError:
                pass
            if procs[kill_rank].poll() is not None:
                break  # the restart died: surfaced below
            time.sleep(0.05)
        if t_rec is None:
            restarted = procs[kill_rank]
            err = restarted.communicate()[1] if restarted.poll() is not None else ""
            tail = "\n".join((err or "").strip().splitlines()[-8:])
            raise FleetSanError(
                f"killed rank {kill_rank} never republished within {timeout_s:.0f}s of restart "
                f"— rejoin broken{': ' + tail if tail else ''}")
        record["time_to_recover_s"] = round(t_rec - t_kill, 3)
        summaries = {}
        for r, p in sorted(procs.items()):
            try:
                out, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                raise FleetSanError(f"worker {r} hung past {timeout_s:.0f}s after the chaos "
                                    "window")
            line = next((ln for ln in reversed(out.strip().splitlines()) if ln.startswith("{")),
                        None)
            if p.returncode != 0 or line is None:
                tail = (err or out).strip().splitlines()[-8:]
                raise FleetSanError(f"worker {r} failed rc={p.returncode}: " + "\n".join(tail))
            summaries[r] = json.loads(line)
        record["survivor_gossip_mixes"] = sum(s.get("gossip_mixes", 0)
                                              for r, s in summaries.items() if r != kill_rank)
        record["restarted_consumed_blocks"] = summaries[kill_rank].get("consumed_blocks", 0)
        record["consumed_blocks"] = {r: s.get("consumed_blocks", 0)
                                     for r, s in summaries.items()}
        record["launches"] = {r: s["launches"] for r, s in summaries.items()
                              if "launches" in s}
        record["ok"] = (record["survivor_gossip_mixes"] > 0
                        and record["restarted_consumed_blocks"] > 0)
        return record
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(mailbox, ignore_errors=True)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """The CLI (JAX's `scripts/fleetsan.py`, with `--device` and `--env`)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m actor_critic_tpu_torch.analysis.fleetsan",
        description="deterministic multi-process chaos sanitizer for the mailbox/gossip/gateway "
        "stack")
    p.add_argument("--schedules", type=int, default=30,
                   help="seeded chaos schedules to sweep (default 30, the quick profile: half "
                   "fleet, half gateway)")
    p.add_argument("--seed0", type=int, default=0,
                   help="first seed of the sweep (a violation names its seed for replay)")
    p.add_argument("--scenario", choices=("all", "fleet", "gateway", "replica", "process"),
                   default="all",
                   help="which unit to exercise (default: the quick profile; 'replica' the "
                   "replica-kill-mid-swap schedule over N MailboxPolicySyncer replicas; "
                   "'process' spawns REAL gossip workers and SIGKILLs one)")
    p.add_argument("--writer", choices=("atomic", "direct", "shared-tmp"), default="atomic",
                   help="fleet publish mode: 'direct'/'shared-tmp' are the reverted writers "
                   "(expected exit 1)")
    p.add_argument("--poller", choices=("guarded", "naive"), default="guarded",
                   help="gateway consume mode: 'naive' is the reverted consumer without "
                   "per-peer clocks (expected exit 1)")
    p.add_argument("--world", type=int, default=3,
                   help="fleet ranks, or replicas (default 3: ring rotation needs >= 3 to tell "
                   "per-peer clocks from a global one)")
    p.add_argument("--duration-s", type=float, default=8.0,
                   help="process scenario: each worker's wall window")
    p.add_argument("--flight-dump", default="", metavar="DIR",
                   help="ALSO run one short real-SIGKILL schedule with per-host telemetry under "
                   "DIR and harvest the victim's flight ring into "
                   "DIR/host<rank>/flight_dump_*.json (exit 1 if the ring is empty)")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the real workers learn (default: the card); the simulated "
                   "schedules touch files only")
    p.add_argument("--env", default="",
                   help="the real workers' env pool (default: the sleep-padded CartPole, which "
                   "needs gymnasium; e.g. native:CartPole-v1 without it)")
    args = p.parse_args(argv)

    try:
        if args.scenario == "all":
            out = quick_profile(schedules=args.schedules, seed0=args.seed0)
        elif args.scenario == "fleet":
            out = exercise_sweep(
                range(args.seed0, args.seed0 + args.schedules),
                lambda s: exercise_fleet(s, world=args.world,
                                         writer=args.writer.replace("-", "_")))
        elif args.scenario == "gateway":
            out = exercise_sweep(range(args.seed0, args.seed0 + args.schedules),
                                 lambda s: exercise_gateway(s, poller=args.poller))
        elif args.scenario == "replica":
            out = exercise_sweep(range(args.seed0, args.seed0 + args.schedules),
                                 lambda s: exercise_replica_fleet(s, replicas=args.world))
        else:
            out = run_process_chaos(duration_s=args.duration_s, seed=args.seed0,
                                    device=args.device, env=args.env)
        if args.flight_dump:
            # One short real kill and restart with telemetry on: a SIGKILL'd
            # rank's flight ring must be harvestable post-mortem.
            os.makedirs(args.flight_dump, exist_ok=True)
            chaos = run_process_chaos(duration_s=6.0, kill_after_s=2.5, seed=args.seed0,
                                      telemetry_dir=args.flight_dump, device=args.device,
                                      env=args.env)
            out = dict(out)
            out.update(flight_dump=chaos.get("flight_dump"),
                       flight_records=chaos.get("flight_records"),
                       flight_ttr_s=chaos.get("time_to_recover_s"))
    except FleetSanError as e:
        # A violation names its seed: rerun that seed to replay it.
        print(f"fleetsan: VIOLATION DETECTED: {e}", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"fleetsan: error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.flight_dump and not args.json:
        print(f"fleetsan: flight dump harvested — {out.get('flight_dump')} "
              f"({out.get('flight_records')} ring records, TTR {out.get('flight_ttr_s')}s)")
    if args.json:
        print(json.dumps(out, indent=2, default=str))
    elif args.scenario == "process":
        print(f"fleetsan: host kill/restart clean — time-to-recover "
              f"{out.get('time_to_recover_s')}s (survivor mixes "
              f"{out.get('survivor_gossip_mixes')})")
    else:
        print(f"fleetsan: {out.get('schedules', 0)} chaos schedule(s) clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
