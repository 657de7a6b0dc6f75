"""The port's stall watchdog (`actor_critic_tpu_torch/utils/watchdog.py`,
JAX's `utils/watchdog.py` and its tests) and the chunk-wall ratchet of
`algos/loop.fused_train_loop` (JAX's `checkpointed_train(stride > 1)`).

The firing path calls os._exit, so it runs in a subprocess (0.5 s
timeout); the keep-alive path runs in-process. The ratchet tests drive
the loop with a stub step (`capturable=False`: the CPU path), whose sleep
stands in for a chunk's device wall; the tests patch
`profiler.compile_event_count`, the capture/build counter the loop reads. `chunk_wall.json` is JAX's format:
each package reads the other's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from actor_critic_tpu.utils import checkpoint as jcheckpoint
from actor_critic_tpu_torch import train
from actor_critic_tpu_torch.algos.loop import fused_train_loop
from actor_critic_tpu_torch.telemetry import profiler
from actor_critic_tpu_torch.utils import checkpoint, watchdog
from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class _State:
    """What the loop reads of a state: `ep_return` (its device) and, for
    a checkpoint, the carried tensors and the generator."""

    ep_return: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(1))
    n: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros((), dtype=torch.int64))
    generator: torch.Generator = dataclasses.field(default_factory=torch.Generator)


def _run(step_fn, iterations, chunk, state=None, **kw):
    state = state or _State()

    def step(s):
        step_fn(s)
        s.n += 1
        return s, {"loss": torch.zeros(())}

    return fused_train_loop(lambda env, cfg: step, None, None, None, iterations, state=state,
                            chunk=chunk, device="cpu", **kw)


def test_fires_exit_42_on_stall():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import time\n"
         "from actor_critic_tpu_torch.utils.watchdog import StallWatchdog\n"
         "StallWatchdog(0.5, startup_grace_s=0.0).start()\n"
         "time.sleep(30)\n"  # a 'wedged device call'; the watchdog must kill us
         "print('unreachable')\n"],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == watchdog.STALL_EXIT_CODE == 42, (proc.returncode, proc.stderr)
    assert "stall-watchdog" in proc.stderr
    assert "unreachable" not in proc.stdout


def test_beats_keep_it_alive_and_stop_disarms():
    # A generous timeout/beat ratio (15x): this watchdog is ARMED in the
    # pytest process, and a firing would os._exit the whole session.
    w = watchdog.StallWatchdog(3.0, startup_grace_s=0.0).start()
    try:
        for _ in range(8):
            time.sleep(0.2)
            watchdog.beat()  # the module-level beat reaches the armed instance
    finally:
        w.stop()
    assert w not in watchdog._ACTIVE
    time.sleep(0.5)  # disarmed: no exit even without beats


def test_cli_stall_timeout_clean_run(tmp_path, capsys):
    """--stall-timeout armed around a healthy run does not interfere, and is
    disarmed when the run ends."""
    assert train.main(["--preset", "a2c_cartpole", "--set", "num_envs=8", "--set",
                       "rollout_steps=4", "--iterations", "3", "--quiet", "--log-every", "1",
                       "--metrics", str(tmp_path / "m.jsonl"), "--stall-timeout", "120",
                       "--device", "cpu"]) == 0
    assert not watchdog.armed()
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["iterations"] == 3


def test_armed_and_ensure_timeout_at_least():
    """A completed chunk's measured wall widens armed watchdogs, never
    narrows them."""
    assert not watchdog.armed()
    w = watchdog.StallWatchdog(5.0, startup_grace_s=0.0).start()
    try:
        assert watchdog.armed()
        watchdog.ensure_timeout_at_least(2.0)  # below current: no-op
        assert w.timeout_s == 5.0
        watchdog.ensure_timeout_at_least(9.0)  # above: raises
        assert w.timeout_s == 9.0
        watchdog.ensure_timeout_at_least(9.0)  # equal: no-op
        assert w.timeout_s == 9.0
    finally:
        w.stop()
    assert not watchdog.armed()
    watchdog.ensure_timeout_at_least(99.0)  # disarmed: nothing to touch


def test_chunked_loop_widens_watchdog_from_real_chunk_wall(monkeypatch):
    """The loop times each chunk and raises an armed watchdog to 3x the
    wall, from the SECOND dispatch on: the first (on the card the eager
    warm-up, on the CPU the process's first-call costs) only extends the
    grace. No capture or build moves the counter here."""
    monkeypatch.setattr(profiler, "compile_event_count", lambda: 0)
    # The default startup grace shields the first chunk; the ratchet must
    # then widen the armed 0.4 s timeout past the 0.25 s chunk wall.
    w = watchdog.StallWatchdog(0.4).start()
    try:
        state, _ = _run(lambda s: time.sleep(0.125), 4, chunk=2)
        assert int(state.n) == 4
        assert w.timeout_s >= 0.6, w.timeout_s  # 3 x ~0.25 s (second dispatch)
    finally:
        w.stop()


def test_chunked_loop_first_dispatch_never_ratchets_and_wall_persists(tmp_path, monkeypatch):
    """(a) the first dispatch never drives the ratchet; (b) the clean chunk
    wall persists to `<ckpt dir>/chunk_wall.json`; (c) a resumed process
    widens its armed watchdog from it before any dispatch."""
    monkeypatch.setattr(profiler, "compile_event_count", lambda: 0)
    calls = []

    def slow_first(s):
        time.sleep(0.25 if not calls else 0.025)  # dispatch 1 "warms up"
        calls.append(1)

    w = watchdog.StallWatchdog(0.4).start()  # the default grace shields chunk 1
    try:
        state, _ = _run(slow_first, 6, chunk=2, ckpt=Checkpointer(tmp_path / "ck"),
                        save_every=2)
        assert int(state.n) == 6 and len(calls) == 6
        # The ~0.28 s first dispatch did NOT ratchet (3 x 0.28 would show);
        # the 0.05 s chunks ratchet 0.15 < 0.4, a no-op.
        assert w.timeout_s == 0.4, w.timeout_s
    finally:
        w.stop()
    with open(tmp_path / "ck" / checkpoint.CHUNK_WALL_FILE) as f:
        wall = json.load(f)["chunk_wall_s"]
    assert 0 < wall < 0.3, wall  # the steady wall, not the first one

    w2 = watchdog.StallWatchdog(0.01).start()
    try:
        state, _ = _run(slow_first, 6, chunk=2, ckpt=Checkpointer(tmp_path / "ck"),
                        save_every=2, resume=True)
        assert len(calls) == 6  # nothing re-ran
        assert w2.timeout_s >= 3.0 * wall - 1e-6, w2.timeout_s
    finally:
        w2.stop()


def test_chunked_loop_ratchet_consumes_compile_events(monkeypatch):
    """A dispatch that captured or built (the capture/build counter moved) extends the grace
    instead of ratcheting its inflated wall into the timeout, also on a
    later dispatch at the same k."""
    count = [0]
    monkeypatch.setattr(profiler, "compile_event_count", lambda: count[0])
    calls = []

    def step(s):
        calls.append(1)
        if len(calls) <= 4:
            if len(calls) % 2:
                count[0] += 1  # dispatches 1 AND 2 "capture"
            time.sleep(0.15)
        else:
            time.sleep(0.025)

    w = watchdog.StallWatchdog(0.4).start()
    try:
        state, _ = _run(step, 6, chunk=2)
        assert int(state.n) == 6
        # Ratcheting dispatch 2 would give 3 x 0.3 = 0.9 s; the counter
        # shields it, and the clean 0.05 s dispatch ratchets a no-op.
        assert w.timeout_s == 0.4, w.timeout_s
    finally:
        w.stop()


@pytest.mark.parametrize("writer,reader", [(checkpoint, jcheckpoint), (jcheckpoint, checkpoint)],
                         ids=["port_to_jax", "jax_to_port"])
def test_chunk_wall_file_round_trips_both_ways(tmp_path, writer, reader):
    """Each package's `_persist_chunk_wall` writes what the other's
    `_read_chunk_wall` reads, keeps the larger wall, and both read a
    foreign or non-positive file as nothing learned."""
    path = str(tmp_path / "chunk_wall.json")
    writer._persist_chunk_wall(path, 1.2345)
    assert abs(reader._read_chunk_wall(path) - 1.2345) < 1e-3
    writer._persist_chunk_wall(path, 0.5)  # smaller: kept the larger
    reader._persist_chunk_wall(path, 0.7)
    assert writer._read_chunk_wall(path) == reader._read_chunk_wall(path) > 1.0
    reader._persist_chunk_wall(path, 2.0)
    assert writer._read_chunk_wall(path) == 2.0
    for body in ("[1, 2]", "3.0", '{"chunk_wall_s": 0}', '{"chunk_wall_s": true}', "{"):
        with open(path, "w") as f:
            f.write(body)
        assert writer._read_chunk_wall(path) is None and reader._read_chunk_wall(path) is None
