"""The port's crash flight recorder (`actor_critic_tpu_torch/telemetry/
flight.py`, JAX's `telemetry/flight.py` and its tests): the bounded mmap
ring keeps exactly the last N records across wrap, survives the owner
dying WITHOUT close() (SIGKILL), skips torn slots instead of misparsing
them, and dumps/harvests into the `flight_dump_*.json` files
`scripts/run_report.py` renders. The ring layout is JAX's: a ring written
by either package harvests in the other, and their dumps are the same
files."""

import json
import os
import signal
import struct
import subprocess
import sys

import pytest

from actor_critic_tpu.telemetry import flight as jflight
from actor_critic_tpu_torch import telemetry
from actor_critic_tpu_torch.telemetry import flight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ring(tmp_path, mod=flight, **kw):
    kw.setdefault("slots", 16)
    kw.setdefault("slot_size", 256)
    return mod.FlightRecorder(tmp_path / mod.RING_FILENAME, **kw)


def test_ring_keeps_last_n_records_across_wrap(tmp_path):
    rec = _ring(tmp_path)
    for i in range(40):
        rec.record("tick", i=i)
    got = flight.harvest(rec.path)
    assert len(got) == 16  # ring capacity, not 40
    assert [r["i"] for r in got] == list(range(24, 40))  # oldest first
    assert all(r["kind"] == "tick" and "t" in r for r in got)
    rec.close()


def test_harvest_without_close_survives_owner_death(tmp_path):
    """The SIGKILL contract, end to end: a child process writes records and
    is SIGKILLed mid-life (no close, no flush, no exit handler); the parent
    harvests the ring file afterwards."""
    ring = tmp_path / flight.RING_FILENAME
    code = (
        "import signal\n"
        "from actor_critic_tpu_torch.telemetry import flight\n"
        f"r = flight.FlightRecorder({str(ring)!r}, slots=16, slot_size=256,"
        " meta={'who': 'victim'})\n"
        "for i in range(10):\n"
        "    r.record('work', i=i)\n"
        "print('READY', flush=True)\n"
        "signal.pause()\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                            cwd=ROOT)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.kill()  # SIGKILL: no python code runs after this
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    got = flight.harvest(ring)
    assert [r["kind"] for r in got] == ["meta"] + ["work"] * 10
    assert got[0]["who"] == "victim"
    assert [r["i"] for r in got[1:]] == list(range(10))


def test_torn_slot_is_skipped_not_misparsed(tmp_path):
    rec = _ring(tmp_path)
    for i in range(5):
        rec.record("tick", i=i)
    rec.close()
    # Record 2's payload corrupted in place: valid length, garbage JSON.
    with open(rec.path, "r+b") as f:
        buf = bytearray(f.read())
        off = 24 + 2 * 256  # header+seq, slot 2
        (length,) = struct.unpack_from("<I", buf, off)
        buf[off + 4:off + 4 + length] = b"\xff" * length
        f.seek(0)
        f.write(buf)
    got = flight.harvest(rec.path)
    assert [r["i"] for r in got] == [0, 1, 3, 4]  # slot 2 dropped, rest kept


def test_harvest_rejects_missing_and_foreign_files(tmp_path):
    assert flight.harvest(tmp_path / "nope.ring") == []
    junk = tmp_path / "junk.ring"
    junk.write_bytes(b"not a ring at all" * 10)
    assert flight.harvest(junk) == []


def test_oversize_record_truncates_to_marker(tmp_path):
    rec = _ring(tmp_path)
    rec.record("fat", blob="x" * 4096)
    (got,) = flight.harvest(rec.path)
    assert got["kind"] == "fat" and got["truncated"] is True
    assert "blob" not in got
    rec.close()


def test_record_never_raises_after_close(tmp_path):
    rec = _ring(tmp_path)
    rec.close()
    rec.record("tick", i=1)  # a silent no-op
    rec.close()  # idempotent


def test_init_zeroes_a_stale_ring(tmp_path):
    a = _ring(tmp_path)
    a.record("old_run", i=1)
    a.close()
    b = _ring(tmp_path)  # same path: the previous run's records vanish
    b.record("new_run", i=2)
    assert [r["kind"] for r in flight.harvest(b.path)] == ["new_run"]
    b.close()


def test_mirror_and_gauge_hooks_shape_records(tmp_path):
    rec = _ring(tmp_path)
    rec.mirror({"name": "serve_request", "ph": "X", "ts": 1.0, "dur": 250.0,
                "args": {"trace": "abc"}, "pid": 7})
    rec.mirror({"name": "req", "ph": "s", "ts": 2.0, "id": 9})
    rec.record_gauges({"ts": 123.0, "rss_bytes": 100, "alive": True,
                       "serving": {"queue_depth": 3, "policy": "default"}})
    span, flow, gauges = flight.harvest(rec.path)
    assert span["kind"] == "span" and span["name"] == "serve_request"
    assert span["args"]["trace"] == "abc" and "pid" not in span
    assert flow["kind"] == "trace_evt" and flow["ph"] == "s"
    assert gauges["kind"] == "gauges"
    assert gauges["rss_bytes"] == 100
    assert gauges["serving_queue_depth"] == 3
    assert "ts" not in gauges and "alive" not in gauges
    assert "serving_policy" not in gauges  # non-numeric leaf dropped
    rec.close()


def test_dump_writes_durable_json_and_find_dumps_sees_it(tmp_path):
    rec = _ring(tmp_path, meta={"rank": 3})
    for i in range(4):
        rec.record("tick", i=i)
    path = rec.dump("stall")
    assert os.path.basename(path) == "flight_dump_stall_1.json"
    body = json.load(open(path))
    assert body["flight_dump"] is True and body["reason"] == "stall"
    assert body["meta"] == {"rank": 3}
    assert [r["kind"] for r in body["records"]] == ["meta"] + ["tick"] * 4
    rec.dump("stall")
    assert [os.path.basename(p) for p in flight.find_dumps(tmp_path)] == [
        "flight_dump_stall_1.json", "flight_dump_stall_2.json"]
    # JAX's discovery helper reads the port's dumps, and the other way round.
    assert jflight.find_dumps(tmp_path) == flight.find_dumps(tmp_path)
    rec.close()


def test_signal_dump_chains_to_previous_handler(tmp_path):
    rec = _ring(tmp_path)
    rec.record("about_to_die")
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        rec.install_signal_dump(signals=(signal.SIGUSR1,))
        os.kill(os.getpid(), signal.SIGUSR1)
        dumps = flight.find_dumps(tmp_path)
        assert len(dumps) == 1 and "signal_" in dumps[0]
        assert seen == [signal.SIGUSR1]  # the previous handler still ran
    finally:
        signal.signal(signal.SIGUSR1, prev)
        rec.close()


def test_session_mirrors_spans_and_dumps_on_divergence(tmp_path):
    """TelemetrySession wiring: completed spans and health events mirror
    into the ring, and a durable event (divergence, stall) dumps it to a
    `flight_dump_*.json` beside the other sinks."""
    with telemetry.TelemetrySession(tmp_path, run_info={"seed": 5}, sample_resources=False,
                                    serve_port=None) as s:
        assert s.flight is not None
        with telemetry.span("update", it=3):
            pass
        s.event("divergence", metric="loss", value="nan")
    records = flight.harvest(tmp_path / flight.RING_FILENAME)
    kinds = [r["kind"] for r in records]
    assert kinds[0] == "meta" and records[0]["seed"] == 5
    assert "span" in kinds and "event_divergence" in kinds
    assert next(r for r in records if r["kind"] == "span")["name"] == "update"
    dumps = flight.find_dumps(tmp_path)
    assert len(dumps) == 1 and "divergence" in dumps[0]
    body = json.load(open(dumps[0]))
    assert body["reason"] == "divergence"
    assert any(r.get("kind") == "span" for r in body["records"])


def test_session_flight_off_switch(tmp_path):
    with telemetry.TelemetrySession(tmp_path, sample_resources=False, serve_port=None,
                                    flight=False) as s:
        assert s.flight is None
    assert not (tmp_path / flight.RING_FILENAME).exists()


@pytest.mark.parametrize("writer,reader", [(flight, jflight), (jflight, flight)],
                         ids=["port_to_jax", "jax_to_port"])
def test_ring_written_by_one_package_harvests_in_the_other(tmp_path, writer, reader):
    """Same magic, header, slot format and wrap: the last 16 of 40 records
    (a wrapped ring), a gauge row and a mirrored span decode identically
    through the other package's `harvest`, and its `write_dump` file is
    the same JSON."""
    rec = _ring(tmp_path, writer, meta={"who": writer.__name__})
    for i in range(37):
        rec.record("tick", i=i, x=i * 0.5)
    rec.mirror({"name": "update", "ph": "X", "ts": 1.5, "dur": 2.0, "args": {"it": 4}})
    rec.record_gauges({"ts": 1.0, "rss_bytes": 7, "traj_queue": {"depth": 2}})
    rec.record("last", ok=True)
    theirs, ours = reader.harvest(rec.path), writer.harvest(rec.path)
    assert theirs == ours and len(theirs) == 16
    assert [r["kind"] for r in theirs[-3:]] == ["span", "gauges", "last"]
    assert theirs[-2]["traj_queue_depth"] == 2
    a = reader.write_dump(tmp_path / "a.json", theirs, reason="harvest", meta={"m": 1})
    b = writer.write_dump(tmp_path / "b.json", ours, reason="harvest", meta={"m": 1})
    ja, jb = json.load(open(a)), json.load(open(b))
    ja.pop("dumped_at"), jb.pop("dumped_at")
    assert ja == jb
    rec.close()
