"""Crash flight recorder: a bounded mmap'd ring of the last N telemetry
records per process (a copy of `actor_critic_tpu/telemetry/flight.py`,
with the same ring layout: a ring written by either package harvests in
the other).

A SIGKILLed process exposes the observability gap this closes: a killed
process's line-buffered JSONL sinks keep everything up to the
last flush, but the question a postmortem actually asks — *what was the
process doing in its final seconds* — needs the records that were still
in flight. The recorder keeps a fixed-size ring of recent spans, health
events, and gauge ticks in a file-backed ``mmap`` (MAP_SHARED): every
``record()`` lands in the kernel page cache immediately, so the ring
survives the PROCESS dying by any means, including SIGKILL, and a
survivor can ``harvest()`` it from the dead process's telemetry directory.
(Page cache, not storage: a machine losing power is the checkpoint
layer's problem, not this one's.)

Ring layout (little-endian):

    [0:8)    magic  b"ACFR0001"
    [8:12)   u32 slot_size
    [12:16)  u32 nslots
    [16:24)  u64 seq  — records ever written; slot = (seq-1) % nslots
    then nslots slots of slot_size bytes, each
    [0:4)    u32 payload length (0 = never written)
    [4:4+len) UTF-8 JSON record, truncated to fit

The writer fills the slot BEFORE bumping ``seq`` so a reader that races
a live writer sees at most one torn slot, and a torn slot fails JSON
decode and is skipped — harvest never propagates garbage.

``dump()`` turns the ring into a durable (fsynced) ``flight_dump_*.json``
— called on watchdog stall, divergence, and fatal signals by the
session wiring; ``harvest()`` + ``write_dump()`` do the same for a ring
whose owner is already dead.
"""

from __future__ import annotations

import itertools
import json
import mmap
import os
import signal
import struct
import threading
import time
from typing import Optional

from actor_critic_tpu_torch.utils.numguard import safe_json_row

_MAGIC = b"ACFR0001"
_HEADER = struct.Struct("<8sII")   # magic, slot_size, nslots
_SEQ = struct.Struct("<Q")
_SEQ_OFF = _HEADER.size
_RING_OFF = _SEQ_OFF + _SEQ.size
_LEN = struct.Struct("<I")

DEFAULT_SLOTS = 512
DEFAULT_SLOT_SIZE = 768
RING_FILENAME = "flight.ring"


class FlightRecorder:
    """Writer side: one per process, owning one ring file."""

    def __init__(
        self,
        path: str | os.PathLike,
        slots: int = DEFAULT_SLOTS,
        slot_size: int = DEFAULT_SLOT_SIZE,
        meta: Optional[dict] = None,
    ):
        self.path = os.fspath(path)
        self._slots = int(slots)
        self._slot_size = int(slot_size)
        if self._slots < 8 or self._slot_size < 64:
            raise ValueError("ring too small to be a useful recorder")
        self._lock = threading.Lock()
        self._closed = False
        size = _RING_OFF + self._slots * self._slot_size
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # O_CREAT without O_TRUNC + explicit truncate: recreate the ring
        # fresh for THIS process (a stale ring from a previous run must
        # not mix its records into this run's final-seconds window).
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._mm[0:_RING_OFF] = (
            _HEADER.pack(_MAGIC, self._slot_size, self._slots)
            + _SEQ.pack(0)
        )
        # Dump bookkeeping + identifying metadata (seed, rank, ...)
        # recorded as slot 0 so even a harvested ring names its run.
        self._meta = dict(meta or {})
        # Dump numbering via itertools.count: next() is atomic at the C
        # level, and dump() must stay lock-free — it runs inside fatal
        # signal handlers that may have interrupted a record() holding
        # self._lock on this very thread (a plain Lock would deadlock).
        self._dump_count = itertools.count(1)
        if self._meta:
            self.record("meta", **self._meta)

    # -- write side ---------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one record. Never raises (a telemetry mirror must not
        take the instrumented path down); oversize payloads truncate by
        dropping fields, keeping at least {t, kind}."""
        if self._closed:
            return
        row = {"t": round(time.time(), 6), "kind": kind, **fields}
        try:
            data = safe_json_row(row, default=str).encode()
        except Exception:
            return
        limit = self._slot_size - _LEN.size
        if len(data) > limit:
            try:
                data = safe_json_row(
                    {"t": row["t"], "kind": kind, "truncated": True},
                    default=str,
                ).encode()[:limit]
            except Exception:
                return
        try:
            with self._lock:
                if self._closed:
                    return
                seq = _SEQ.unpack_from(self._mm, _SEQ_OFF)[0]
                off = _RING_OFF + (seq % self._slots) * self._slot_size
                self._mm[off:off + _LEN.size] = _LEN.pack(len(data))
                self._mm[off + _LEN.size:off + _LEN.size + len(data)] = data
                # seq LAST: a harvester racing this write sees the old
                # count (missing the newest record) or the new count
                # with the slot already complete — never a half-record
                # counted as valid.
                _SEQ.pack_into(self._mm, _SEQ_OFF, seq + 1)
        except (ValueError, OSError):
            pass  # closed mmap / ENOSPC on a hole-y fs: drop the record

    def mirror(self, evt: dict) -> None:
        """SpanTracer mirror hook: one completed span/flow event dict
        becomes a compact ring record (args ride along — they carry the
        trace ids a postmortem joins on)."""
        kind = "span" if evt.get("ph") == "X" else "trace_evt"
        fields = {
            k: evt[k] for k in ("name", "ph", "ts", "dur", "args")
            if k in evt
        }
        self.record(kind, **fields)

    def record_gauges(self, row: dict) -> None:
        """ResourceSampler mirror hook: one sampler row (flattened to
        numbers only — device dicts and nested gauges are the sinks'
        job; the ring wants the trend, cheap)."""
        flat = {}
        for k, v in row.items():
            if isinstance(v, bool) or k == "ts":
                continue
            if isinstance(v, (int, float)):
                flat[k] = v
            elif isinstance(v, dict):
                for fk, fv in v.items():
                    if not isinstance(fv, bool) and isinstance(
                        fv, (int, float)
                    ):
                        flat[f"{k}_{fk}"] = fv
        self.record("gauges", **flat)

    # -- dump side ----------------------------------------------------------

    def dump(self, reason: str, directory: Optional[str] = None) -> str:
        """Write the ring's current contents as a durable JSON dump next
        to the ring (or into `directory`); returns the dump path ("" on
        failure — the stall path must never raise)."""
        try:
            records = _decode(bytes(self._mm))
            out_dir = directory or os.path.dirname(self.path) or "."
            path = os.path.join(
                out_dir,
                f"flight_dump_{reason}_{next(self._dump_count)}.json",
            )
            return write_dump(path, records, reason=reason, meta=self._meta)
        except Exception:
            return ""

    def install_signal_dump(
        self, signals: tuple = (signal.SIGTERM,), directory: Optional[str] = None
    ) -> None:
        """Chain a dump onto fatal-signal delivery (main thread only —
        signal.signal raises elsewhere, reported as a no-op). SIGKILL
        needs no handler: that is what post-mortem harvest() is for."""
        for sig in signals:
            try:
                prev = signal.getsignal(sig)

                def _handler(signum, frame, _prev=prev):
                    self.dump(f"signal_{signum}", directory)
                    if callable(_prev):
                        _prev(signum, frame)
                    else:
                        signal.signal(signum, signal.SIG_DFL)
                        signal.raise_signal(signum)

                signal.signal(sig, _handler)
            except (ValueError, OSError):
                pass  # not the main thread / unsupported signal

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                self._mm.flush()
                self._mm.close()
            except (ValueError, OSError):
                pass


# -- read side (works on a live or dead process's ring) ----------------------


def _decode(buf: bytes) -> list[dict]:
    if len(buf) < _RING_OFF:
        return []
    magic, slot_size, nslots = _HEADER.unpack_from(buf, 0)
    if magic != _MAGIC or slot_size <= _LEN.size or nslots <= 0:
        return []
    if len(buf) < _RING_OFF + nslots * slot_size:
        return []
    seq = _SEQ.unpack_from(buf, _SEQ_OFF)[0]
    n = min(seq, nslots)
    records: list[dict] = []
    # Oldest surviving record first: slots [seq-n, seq) in write order.
    for s in range(seq - n, seq):
        off = _RING_OFF + (s % nslots) * slot_size
        length = _LEN.unpack_from(buf, off)[0]
        if not 0 < length <= slot_size - _LEN.size:
            continue
        raw = buf[off + _LEN.size:off + _LEN.size + length]
        try:
            rec = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            continue  # torn slot (writer died mid-write): skip, keep rest
        if isinstance(rec, dict):
            records.append(rec)
    return records


def harvest(ring_path: str | os.PathLike) -> list[dict]:
    """Decode a ring file — typically a DEAD process's (one killed
    by SIGKILL): returns its surviving records oldest-first.
    Empty list when the file is missing/foreign/empty."""
    try:
        with open(ring_path, "rb") as f:
            buf = f.read()
    except OSError:
        return []
    return _decode(buf)


def write_dump(
    path: str | os.PathLike,
    records: list[dict],
    reason: str = "harvest",
    meta: Optional[dict] = None,
) -> str:
    """Durably (write + fsync + rename) persist harvested records as a
    flight dump run_report.py renders. Returns the final path."""
    path = os.fspath(path)
    body = {
        "flight_dump": True,
        "reason": reason,
        "dumped_at": round(time.time(), 3),
        "meta": dict(meta or {}),
        "records": records,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(body, f, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def find_dumps(directory: str | os.PathLike) -> list[str]:
    """flight_dump_*.json paths under `directory` (sorted) — the
    run_report/tier-1 discovery helper."""
    directory = os.fspath(directory)
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(
        os.path.join(directory, n)
        for n in names
        if n.startswith("flight_dump_") and n.endswith(".json")
    )
