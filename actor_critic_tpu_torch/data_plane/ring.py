"""The device trajectory ring (counterpart of
`actor_critic_tpu/data_plane/ring.py`).

The host `TrajQueue` (`algos/traj_queue.py`) costs one host-to-device
copy of every consumed block on the LEARNER's path. This ring keeps the
trajectory data on the card instead (IMPACT's per-block reuse, arxiv
1912.00167, pays most when the block is already resident):

- **Storage**: one `[depth, K, E, ...]` tensor per block key on the card,
  at the codec's storage dtype (`replay/quantize.py` kinds, chosen per key
  by `codecs.traj_codecs`), and per slot the stats its block was encoded
  with, its behaviour version and its put sequence (`RingState`).
- **Actors enqueue encoded blocks.** `put` runs on the actor's thread: it
  folds the block into the numpy stats (calibrate, then freeze), encodes
  it with the numpy codecs (`data_plane/codecs.py`), claims a slot, writes
  the bytes into that slot's pinned staging buffer and copies them to
  `storage[slot]` on the slot's own stream, then records the slot's
  enqueue event. The copy first waits on the slot's release event, so it
  never overwrites a block the learner may still read, and the staging
  buffer is rewritten only after the slot's last copy out of it has run.
- **The learner gathers and decodes inside its update.** It writes the
  slot index into one device scalar (`select`, a fill kernel: no
  host-to-device copy), makes its stream wait on the slot's enqueue
  event, and replays its update, which reads the slot by `index_select`
  and decodes it (`gather_block`). After the last replay that reads the
  slot it records the slot's release event (`release`).

JAX orders its enqueue and gather by dispatch under one lock (its `run()`
seam); here the order is kept by those two events on two streams, so the
learner's consume path holds no lock across a dispatch and moves no block
bytes to the card.

Semantics carry over from `TrajQueue`: `policy="drop_oldest"` reclaims the
oldest PENDING slot when the ring is full (never a leased one; counted),
`policy="block"` is the strict mode, and `max_staleness` drops blocks whose
version aged past the bound at `get`. With the all-`raw` `fp32` codec the
decoded block is the host block bit for bit.

One difference from JAX: each slot carries the stats ITS block was encoded
with, and decodes with them. JAX decodes a queued block with the ring's
newest stats, which may have widened since the encode while the stats are
still calibrating; here a block always decodes through its own encode's
stats. After the freeze the two are the same. The `i8` decode is
`q · (scale / 127) + mean` as two operations, the numpy mirror's
expression (`codecs.np_decode`), so the two agree bit for bit.

On the CPU (the tests) every copy is synchronous and there are no streams
or events.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from actor_critic_tpu_torch.data_plane import codecs as np_codecs
from actor_critic_tpu_torch.replay import quantize


class ArraySpec(NamedTuple):
    """The shape and numpy dtype of one block array (JAX's
    `jax.ShapeDtypeStruct` in the block specs)."""

    shape: tuple[int, ...]
    dtype: np.dtype


def array_spec(shape, dtype) -> ArraySpec:
    return ArraySpec(tuple(int(d) for d in shape), np.dtype(dtype))


class RingState(NamedTuple):
    """The device half of the ring: encoded block storage, and per slot the
    stats its block was encoded with (a `quantize.QuantStats` of [depth]
    tensors per key; placeholders for stat-free codecs, so the structure
    is the same in every mode), its behaviour version and its put
    sequence (-1 where never written)."""

    storage: dict[str, torch.Tensor]
    quant: dict[str, quantize.QuantStats]
    versions: torch.Tensor  # int64 [depth]
    seqs: torch.Tensor      # int64 [depth]


class RingLease(NamedTuple):
    """A consumed block's handle: the slot to gather (leased until
    `release`) and the bookkeeping of the learner's log rows."""

    slot: int
    version: int
    actor_id: int
    seq: int


def torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def storage_dtype(kind: str, dtype) -> np.dtype:
    """The numpy dtype a leaf is stored at on the card."""
    return np_codecs.storage_np_dtype(kind, np.dtype(dtype))


def _ring_tables(block_spec: dict, depth: int, codec_kinds: dict, device: torch.device):
    """(storage by key, the float32 stats table [depth, keys, 2], the int64
    table [depth, 2 + keys] of version, sequence and stats counts)."""
    storage = {
        name: torch.zeros((depth, *spec.shape),
                          dtype=torch_dtype(storage_dtype(codec_kinds[name], spec.dtype)),
                          device=device)
        for name, spec in block_spec.items()
    }
    stats = torch.zeros((depth, len(block_spec), 2), dtype=torch.float32, device=device)
    stats[:, :, 1] = np_codecs._EPS
    meta = torch.full((depth, 2 + len(block_spec)), -1, dtype=torch.int64, device=device)
    meta[:, 2:] = 0
    return storage, stats, meta


def _state_of(storage: dict, stats: torch.Tensor, meta: torch.Tensor) -> RingState:
    quant = {
        name: quantize.QuantStats(mean=stats[:, k, 0], scale=stats[:, k, 1], count=meta[:, 2 + k])
        for k, name in enumerate(storage)
    }
    return RingState(storage=storage, quant=quant, versions=meta[:, 0], seqs=meta[:, 1])


def init_ring(block_spec: dict, depth: int, codec_kinds: dict,
              device: torch.device | str = "cpu") -> RingState:
    """A zeroed ring of `depth` blocks shaped like `block_spec` (name →
    `ArraySpec`). The per-slot stats and the version and sequence columns
    are views of two tables (one float32, one int64), so a put writes a
    slot's bookkeeping with two copies."""
    return _state_of(*_ring_tables(block_spec, depth, codec_kinds, torch.device(device)))


def decode_leaf(kind: str, stats: quantize.QuantStats, q: torch.Tensor) -> torch.Tensor:
    """A stored leaf → float32 (raw passes its dtype through). The int8
    codecs divide by a float32 tensor of 127 and multiply and add as two
    operations, as the numpy mirror does, so that host and card agree bit
    for bit; the rest is `quantize.decode`."""
    if kind == "i8":
        return q.to(torch.float32) * (stats.scale / torch.full_like(stats.scale, 127.0)) \
            + stats.mean
    if kind == "i8_unit":
        return q.to(torch.float32) / torch.full((), 127.0, device=q.device)
    return quantize.decode(kind, stats, q)


def gather_block(state: RingState, slot: torch.Tensor | int, codec_kinds: dict) -> dict:
    """The slot's block, decoded, by key: inside the learner's update
    (`slot` is a [1] int64 device tensor a CUDA graph reads, or an int)."""
    storage = state.storage
    if not isinstance(slot, torch.Tensor):
        slot = torch.tensor([slot], dtype=torch.int64,
                            device=next(iter(storage.values())).device)
    out = {}
    for name, store in storage.items():
        q = store.index_select(0, slot)[0]
        kind, stats = codec_kinds[name], None
        if kind in quantize.STAT_KINDS:
            st = state.quant[name]
            stats = quantize.QuantStats(mean=st.mean.index_select(0, slot)[0],
                                        scale=st.scale.index_select(0, slot)[0],
                                        count=st.count.index_select(0, slot)[0])
        out[name] = decode_leaf(kind, stats, q)
    return out


class DeviceTrajRing:
    """The host-side coordinator of the device ring: `TrajQueue`'s
    producer/consumer protocol (`put`/`get`/`release`/
    `set_consumer_version`/`stats`/`close`) over storage on `device`.
    `traj_queue.ActorService` pushes into it unchanged; the learner calls
    `select(lease)` before the update that gathers the slot from `state`
    through `slot_index`, and `release(lease)` after the last one.

    `codec` is a `codecs.traj_codecs` mode ("fp32"/"f16"/"int8") or an
    explicit per-key kind dict. `transfer_pad_s` pads every enqueue with a
    wall sleep on the actor's thread (a testbed knob for a slow link)."""

    def __init__(self, depth: int, block_spec: dict, codec: Any = "fp32",
                 max_staleness: Optional[int] = None, policy: str = "drop_oldest",
                 transfer_pad_s: float = 0.0, device: torch.device | str = "cpu",
                 gauge_name: str = "device_ring", register_gauge: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if policy not in ("drop_oldest", "block"):
            raise ValueError(f"unknown policy {policy!r}")
        if max_staleness is not None and max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 or None")
        self.depth = int(depth)
        self.max_staleness = max_staleness
        self.policy = policy
        self.transfer_pad_s = float(transfer_pad_s)
        self.device = torch.device(device)
        self._spec = {name: array_spec(leaf.shape, leaf.dtype) for name, leaf in block_spec.items()}
        self._names = list(self._spec)
        self.codecs = (np_codecs.traj_codecs(codec, self._spec) if isinstance(codec, str)
                       else dict(codec))
        self._np_stats = {name: np_codecs.np_init_stats(self.codecs[name], ())
                          for name in self._names}
        self._stat_keys = [n for n, k in self.codecs.items() if k in quantize.STAT_KINDS]
        # Transitions a put folds into each key's calibration clock: blocks
        # are time-major, so every [K, E, ...] key holds K·E transitions and
        # the [E, ...] keys (last_obs, bootstrap_value) E. The modal leading
        # pair across the spec is (K, E).
        pairs = [tuple(leaf.shape[:2]) for leaf in self._spec.values() if len(leaf.shape) >= 2]
        modal = max(set(pairs), key=pairs.count) if pairs else None
        self._transitions_per_put = {
            name: int(modal[0] * modal[1] if modal is not None and tuple(leaf.shape[:2]) == modal
                      else (leaf.shape[0] if leaf.shape else 1))
            for name, leaf in self._spec.items()
        }
        self._storage_dtypes = {name: storage_dtype(self.codecs[name], leaf.dtype)
                                for name, leaf in self._spec.items()}
        storage, self._stat_table, self._meta_table = _ring_tables(
            self._spec, depth, self.codecs, self.device)
        self._state = _state_of(storage, self._stat_table, self._meta_table)
        self.slot_index = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            # Per slot: a stream, pinned staging at the storage dtypes, and
            # the enqueue and release events. All made here, before any
            # actor runs, so an actor's put allocates nothing.
            # From the high-priority pool: torch hands out its 32 streams of a
            # pool round robin, so a normal-priority slot stream may be the
            # stream the learner captures its update on, and an actor's put
            # during that capture would join it.
            self._streams = [torch.cuda.Stream(self.device, priority=-1) for _ in range(depth)]
            self._staging = [
                {name: torch.empty(leaf.shape, dtype=torch_dtype(self._storage_dtypes[name]),
                                   pin_memory=True)
                 for name, leaf in self._spec.items()}
                for _ in range(depth)]
            self._stat_staging = [torch.empty(self._stat_table.shape[1:], dtype=torch.float32,
                                              pin_memory=True) for _ in range(depth)]
            self._meta_staging = [torch.empty(self._meta_table.shape[1:], dtype=torch.int64,
                                              pin_memory=True) for _ in range(depth)]
            self._enqueued = [torch.cuda.Event() for _ in range(depth)]
            self._released = [torch.cuda.Event() for _ in range(depth)]
            self._enqueue_recorded = [False] * depth
            self._release_recorded = [False] * depth
        self._cv = threading.Condition()
        self._free: list[int] = list(range(depth))
        self._pending: deque[RingLease] = deque()
        self._leased: set[int] = set()
        self._writing: set[int] = set()
        self._seq = 0
        self._consumer_version = 0
        self._puts = 0
        self._gets = 0
        self._drops_full = 0
        self._drops_stale = 0
        self._last_staleness = 0
        self._max_staleness_seen = 0
        self._idle_s = 0.0
        self._enqueue_bytes = 0
        self._closed = False
        self._gauge_key: Optional[str] = None
        if register_gauge:
            from actor_critic_tpu_torch.telemetry import sampler

            self._gauge_key = sampler.register_gauge(gauge_name, self.stats)

    @property
    def state(self) -> RingState:
        return self._state

    # -- byte accounting ---------------------------------------------------

    def bytes_per_block(self) -> int:
        """Encoded bytes one enqueue copies to the card."""
        return sum(int(np.prod(leaf.shape, dtype=np.int64)) * self._storage_dtypes[n].itemsize
                   for n, leaf in self._spec.items())

    def raw_bytes_per_block(self) -> int:
        """The same block's bytes at its own dtypes: what the host plane
        copies to the card for every consumed block."""
        return sum(int(np.prod(leaf.shape, dtype=np.int64)) * leaf.dtype.itemsize
                   for leaf in self._spec.values())

    # -- producer ----------------------------------------------------------

    def put(self, arrays: dict[str, np.ndarray], version: int, actor_id: int = 0,
            timeout: Optional[float] = None) -> bool:
        """Encode `arrays` on the host and copy them into a ring slot on the
        card. True once enqueued; False when no slot freed within `timeout`
        (under `policy="block"`, or drop-oldest with every slot leased), or
        the ring is closed. The caller's arrays are free to reuse at once."""
        with self._cv:
            if self._closed:
                return False
            for name in self._stat_keys:
                if name in arrays:
                    self._np_stats[name] = np_codecs.np_update_stats(
                        self.codecs[name], self._np_stats[name], arrays[name],
                        num_transitions=self._transitions_per_put[name])
            # np_update_stats returns new arrays, so this snapshot stays
            # valid while other actors go on calibrating.
            stats = dict(self._np_stats)
        encoded = {
            name: np_codecs.np_encode(self.codecs[name], stats[name], arrays[name]).astype(
                self._storage_dtypes[name], copy=False)
            for name in self._names
        }
        if self.transfer_pad_s > 0:
            time.sleep(self.transfer_pad_s)
        nbytes = sum(v.nbytes for v in encoded.values())
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed:
                    return False
                slot = self._claim_slot_locked()
                if slot is not None:
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(0.1 if remaining is None else min(0.1, remaining))
            seq = self._seq
            self._seq += 1
            self._writing.add(slot)
        try:
            # The slot is this thread's alone until it is pending.
            self._write_slot(slot, encoded, stats, int(version), seq)
        except BaseException:
            with self._cv:
                self._writing.discard(slot)
                self._free.append(slot)
                self._cv.notify_all()
            raise
        with self._cv:
            self._writing.discard(slot)
            self._pending.append(RingLease(int(slot), int(version), int(actor_id), seq))
            self._puts += 1
            self._enqueue_bytes += nbytes
            self._cv.notify_all()
        return True

    def _bookkeeping(self, stats: dict, version: int, seq: int) -> tuple[np.ndarray, np.ndarray]:
        stat_row = np.zeros((len(self._names), 2), np.float32)
        meta_row = np.zeros(2 + len(self._names), np.int64)
        meta_row[:2] = version, seq
        for k, name in enumerate(self._names):
            stat_row[k] = stats[name]["mean"], stats[name]["scale"]
            meta_row[2 + k] = stats[name]["count"]
        return stat_row, meta_row

    def _write_slot(self, slot: int, encoded: dict, stats: dict, version: int, seq: int) -> None:
        stat_row, meta_row = self._bookkeeping(stats, version, seq)
        if not self._cuda:
            with torch.no_grad():
                for name in self._names:
                    self._state.storage[name][slot].copy_(torch.from_numpy(encoded[name]))
                self._stat_table[slot].copy_(torch.from_numpy(stat_row))
                self._meta_table[slot].copy_(torch.from_numpy(meta_row))
            return
        if self._enqueue_recorded[slot]:
            # The staging buffer is rewritten only after the slot's last copy
            # out of it has run (a pinned copy reads its source late).
            self._enqueued[slot].synchronize()
        staging = self._staging[slot]
        for name in self._names:
            np.copyto(staging[name].numpy(), encoded[name])
        np.copyto(self._stat_staging[slot].numpy(), stat_row)
        np.copyto(self._meta_staging[slot].numpy(), meta_row)
        stream = self._streams[slot]
        with torch.no_grad(), torch.cuda.stream(stream):
            if self._release_recorded[slot]:
                # Never overwrite a block before the learner's last read of it.
                stream.wait_event(self._released[slot])
            for name in self._names:
                self._state.storage[name][slot].copy_(staging[name], non_blocking=True)
            self._stat_table[slot].copy_(self._stat_staging[slot], non_blocking=True)
            self._meta_table[slot].copy_(self._meta_staging[slot], non_blocking=True)
            self._enqueued[slot].record(stream)
        self._enqueue_recorded[slot] = True

    def _claim_slot_locked(self) -> Optional[int]:
        """A writable slot, or None when the caller must wait: free slots
        first; under drop-oldest a full ring reclaims its oldest PENDING
        block (leased slots are never overwritten); under `policy="block"`
        a full ring always waits."""
        if self.policy == "block":
            if self._in_flight() < self.depth and self._free:
                return self._free.pop()
            return None
        if self._free:
            return self._free.pop()
        if self._pending:
            old = self._pending.popleft()
            self._drops_full += 1
            return old.slot
        return None  # every slot leased or being written: wait for a release

    def _in_flight(self) -> int:
        return len(self._pending) + len(self._leased) + len(self._writing)

    # -- consumer ----------------------------------------------------------

    def set_consumer_version(self, version: int) -> None:
        with self._cv:
            self._consumer_version = int(version)

    def get(self, timeout: Optional[float] = None) -> Optional[RingLease]:
        """The oldest fresh-enough block's lease (its slot unwritable until
        `release`), or None after `timeout`; TrajQueue.get's staleness
        drops."""
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.monotonic()
        with self._cv:
            try:
                while True:
                    while self._pending:
                        lease = self._pending.popleft()
                        lag = self._consumer_version - lease.version
                        if self.max_staleness is not None and lag > self.max_staleness:
                            self._free.append(lease.slot)
                            self._drops_stale += 1
                            self._cv.notify_all()
                            continue
                        self._leased.add(lease.slot)
                        self._gets += 1
                        self._last_staleness = max(lag, 0)
                        self._max_staleness_seen = max(self._max_staleness_seen,
                                                       self._last_staleness)
                        return lease
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        return None
                    self._cv.wait(0.1 if remaining is None else min(0.1, remaining))
            finally:
                self._idle_s += time.monotonic() - t0

    def select(self, lease: RingLease) -> None:
        """Point `slot_index` at the lease's slot (a fill kernel on the
        current stream) and make the current stream wait for the slot's
        enqueue: call before the updates that gather it."""
        self.slot_index.fill_(lease.slot)
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(self._enqueued[lease.slot])

    def release(self, lease: RingLease) -> None:
        """Return a leased slot to the writable pool. Call after the LAST
        update that reads it has been enqueued: the release event recorded
        here on the current stream is what a later put of the slot waits
        on."""
        if self._cuda:
            self._released[lease.slot].record(torch.cuda.current_stream(self.device))
            self._release_recorded[lease.slot] = True
        with self._cv:
            self._leased.discard(lease.slot)
            self._free.append(lease.slot)
            self._cv.notify_all()

    # -- checkpoint (the stats survive, the storage is never saved) ---------

    def quant_host(self) -> dict:
        """The host-side quantizer stats as a numpy tree: the only part of
        the ring a checkpoint holds (trajectory blocks are transient)."""
        with self._cv:
            return {name: {k: np.asarray(v) for k, v in st.items()}
                    for name, st in self._np_stats.items()}

    def install_quant(self, tree: dict) -> None:
        """Adopt restored stats: later puts encode (and their slots decode)
        with the run's own standardization."""
        with self._cv:
            self._np_stats = {
                name: {"mean": np.asarray(st["mean"], np.float32),
                       "scale": np.asarray(st["scale"], np.float32),
                       "count": np.asarray(st["count"], np.int32)}
                for name, st in tree.items()
            }

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        with self._cv:
            return len(self._pending)

    def codec_mix(self) -> str:
        return ",".join(f"{n}:{self.codecs[n]}" for n in sorted(self.codecs))

    def stats(self) -> dict:
        """TrajQueue's row (depth, staleness, drops, learner idle) and the
        ring's bytes: per block encoded and raw, copied by enqueues so far,
        and by the learner's consume path (none: only the slot index is
        written, by a fill kernel)."""
        with self._cv:
            return {
                "capacity": self.depth,
                "depth": len(self._pending),
                "leased": len(self._leased),
                "puts": self._puts,
                "gets": self._gets,
                "drops_full": self._drops_full,
                "drops_stale": self._drops_stale,
                "observe_staleness": self._last_staleness,
                "staleness_max": self._max_staleness_seen,
                "learner_idle_s": round(self._idle_s, 3),
                "slots": self.depth,
                "bytes_per_block": self.bytes_per_block(),
                "raw_bytes_per_block": self.raw_bytes_per_block(),
                "enqueue_bytes": self._enqueue_bytes,
                "consume_transfer_bytes": 0,
                "codec_mix": self.codec_mix(),
            }

    def close(self) -> None:
        with self._cv:
            self._closed = True
            gauge_key, self._gauge_key = self._gauge_key, None
            self._cv.notify_all()
        if gauge_key is not None:
            from actor_critic_tpu_torch.telemetry import sampler

            sampler.unregister_gauge(gauge_key)


# -- the warm-up registry (utils/compile_cache.py) ---------------------------
from actor_critic_tpu_torch.utils import compile_cache as _compile_cache  # noqa: E402


@_compile_cache.register_warmup("ring.make_enqueue")
def _warmup_enqueue(ctx):
    """An actor's enqueue (`DeviceTrajRing.put`) is a few plain copies on the
    slot's stream, never captured: nothing to warm."""
    return None
