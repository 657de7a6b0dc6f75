"""The port's run telemetry (`actor_critic_tpu_torch/telemetry/`; JAX's
`tests/test_telemetry.py`, case for case), and its parity with JAX's:

- the span tracer emits VALID Chrome-trace events whose phase spans nest
  inside their iteration span, from a real 3-iteration host PPO run;
- the resource sampler writes monotone-timestamp rows, with a CPU device
  row that has no byte fields (absent, never zero);
- the health monitors fire on synthetic regressions and divergence, stay
  quiet on clean runs, and give JAX's events on the same feed;
- the stall watchdog's exit-42 diagnosis names the open span and, with a
  session, writes a durable `stall` event first (a subprocess, 0.5 s);
- `scripts/run_report.py` (JAX's, unedited) renders what the port writes:
  the phase breakdown, health, resources, resume segments, the compile
  attribution of captures and builds, worker lanes, the CLI;
- the fused loop emits an `update` span per dispatch, a `log` span per
  dispatch and a `checkpoint` span at every save boundary, also without a
  checkpointer;
- the same small command line through JAX's `train.py` and the port's
  `train.main --device cpu` (fused A2C with `--chunk 2`, and host PPO on a
  native env) gives the same sequence of span names and argument keys and
  the same event kinds apart from `compile`.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from actor_critic_tpu.telemetry.health import DivergenceMonitor as JDivergenceMonitor
from actor_critic_tpu.telemetry.health import ThroughputMonitor as JThroughputMonitor
from actor_critic_tpu_torch import telemetry, train
from actor_critic_tpu_torch.telemetry import profiler
from actor_critic_tpu_torch.telemetry.health import DivergenceMonitor, ThroughputMonitor
from actor_critic_tpu_torch.telemetry.sampler import ResourceSampler, sample_row

ROOT = Path(__file__).parent.parent
_spec = importlib.util.spec_from_file_location("run_report", ROOT / "scripts" / "run_report.py")
run_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run_report)


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(autouse=True)
def _no_static_findings(monkeypatch):
    """The report's "Static findings" section runs the repo's linter over the
    whole working tree (tens of seconds); it reports on the tree, not on a
    telemetry directory, so these tests leave it out."""
    monkeypatch.setattr(run_report, "static_findings", lambda: [])


# ---------------------------------------------------------------- spans


def test_spans_from_host_loop_are_valid_nested_chrome_trace(tmp_path):
    """A 3-iteration PPO host run under an installed session leaves a
    spans.jsonl whose every line is a Chrome Trace Event Format entry and
    whose phase spans (env_step, host_to_device, update, log) sit inside an
    iteration span by ts/dur containment."""
    from actor_critic_tpu_torch.algos import ppo
    from actor_critic_tpu_torch.envs.host_pool import HostEnvPool

    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=8, epochs=1, num_minibatches=1, hidden=(16,))
    pool = HostEnvPool("CartPole-v1", num_envs=2, seed=0, backend="native")
    with telemetry.TelemetrySession(tmp_path, sample_resources=False):
        ppo.train_host(pool, cfg, num_iterations=3, seed=0, log_every=1, device="cpu")
    pool.close()

    events = _read_jsonl(tmp_path / "spans.jsonl")
    assert events, "no span events written"
    for e in events:
        assert e["ph"] in ("M", "X", "i"), e
        assert "name" in e and "pid" in e and "tid" in e, e
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0, e
    json.loads(json.dumps({"traceEvents": events}))

    complete = [e for e in events if e["ph"] == "X"]
    iters = [e for e in complete if e["name"] == "iteration"]
    assert len(iters) == 3, [e["name"] for e in complete]
    for phase in ("env_step", "host_to_device", "update", "log"):
        kids = [e for e in complete if e["name"] == phase]
        assert len(kids) == 3, (phase, [e["name"] for e in complete])
        for kid in kids:
            assert any(parent["ts"] - 1 <= kid["ts"]
                       and kid["ts"] + kid["dur"] <= parent["ts"] + parent["dur"] + 1
                       for parent in iters), (phase, kid, iters)

    report = run_report.render(str(tmp_path))
    assert "| update |" in report and "| env_step |" in report, report
    run_report.write_trace(events, str(tmp_path / "trace.json"))
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"]


def test_run_report_renders_a_port_run_with_its_budget_table(tmp_path):
    """The report of a port session's directory keeps every section of a JAX
    run's, the committed perf-budget table included."""
    with telemetry.TelemetrySession(tmp_path, sample_resources=False):
        with telemetry.span("iteration", it=1):
            with telemetry.span("update", dispatch="async"):
                pass
    report = run_report.render(str(tmp_path))
    for section in ("## Events & health", "## Phase breakdown", "## Resources",
                    "## Recompile attribution"):
        assert section in report
    assert "`ppo_update_host`" in "\n".join(run_report.perf_budget_table())


def test_span_stack_tracked_without_session():
    """Spans keep the open-span stack with NO session installed (the
    watchdog reads it in runs launched without --telemetry-dir)."""
    assert telemetry.current() is None
    assert telemetry.open_spans() == []
    with telemetry.span("update", it=1):
        with telemetry.span("inner"):
            assert telemetry.open_spans() == ["update", "inner"]
            name, open_s = telemetry.last_open_span()
            assert name == "inner" and open_s >= 0
    assert telemetry.open_spans() == []
    telemetry.instant("env_step")  # a no-op, must not raise
    telemetry.observe(1, {"loss": 0.0})


def test_span_stacks_are_per_thread():
    """Actor threads open spans concurrently with the learner: each thread
    has its OWN stack, `open_spans` reports the calling thread only, and
    `last_open_span` (the watchdog's view) sees the most recently entered
    phase across all threads."""
    import threading

    entered, release = threading.Event(), threading.Event()
    seen_in_thread: list = []

    def worker():
        with telemetry.span("env_step", steps=1):
            seen_in_thread.append(telemetry.open_spans())
            entered.set()
            release.wait(5.0)

    t = threading.Thread(target=worker, daemon=True)
    with telemetry.span("update"):
        t.start()
        assert entered.wait(5.0)
        time.sleep(0.01)
        assert telemetry.open_spans() == ["update"]
        assert seen_in_thread == [["env_step"]]
        assert telemetry.last_open_span()[0] == "env_step"
        release.set()
        t.join(5.0)
        assert telemetry.open_spans() == ["update"]
    assert telemetry.open_spans() == []
    assert telemetry.last_open_span() is None  # the worker's stack reclaimed


# -------------------------------------------------------------- sampler


def test_sampler_rows_are_monotone(tmp_path):
    path = tmp_path / "resources.jsonl"
    with open(path, "a", buffering=1) as fh:
        s = ResourceSampler(fh, interval_s=0.02).start()
        time.sleep(0.12)
        s.stop()
    rows = _read_jsonl(path)
    assert len(rows) >= 3  # start sample + >=1 tick + stop sample
    ts = [r["ts"] for r in rows]
    assert ts == sorted(ts)
    rec = [r["recompiles"] for r in rows]
    assert rec == sorted(rec) and all(isinstance(c, int) for c in rec)
    assert all(r["rss_bytes"] > 0 for r in rows if "rss_bytes" in r)


def test_session_plumbs_sampler_cadence(tmp_path):
    """`--telemetry-sample-s` overrides the 5 s default through
    TelemetrySession(resource_interval_s=...)."""
    with telemetry.TelemetrySession(tmp_path, resource_interval_s=0.02) as s:
        assert s.sampler is not None and s.sampler._interval == 0.02
        time.sleep(0.1)
    assert len(_read_jsonl(tmp_path / "resources.jsonl")) >= 3


def test_sample_row_shape():
    """A process that has not touched CUDA reports one CPU device row WITHOUT
    byte fields: absent allocator stats are absent, never zeros (JAX's row
    for a backend without memory_stats)."""
    row = sample_row()
    assert set(row) >= {"ts", "recompiles", "devices"}
    assert row["devices"] == [{"id": 0, "platform": "cpu"}]


# --------------------------------------------------------------- health


def test_throughput_monitor_confirms_fires_once_and_rearms():
    fired = []
    m = ThroughputMonitor(lambda kind, **f: fired.append((kind, f)), drop_threshold=0.5,
                          warmup_observations=2)
    t = 0.0
    for it in range(1, 8):  # a steady 1 iter/s: quiet
        t += 1.0
        m.observe(it, {}, t)
    assert fired == []
    t += 10.0  # 0.1 iter/s, 90% below the EMA, but UNCONFIRMED
    m.observe(8, {}, t)
    assert fired == []
    t += 10.0  # the second sub-floor window in a row: fires once
    m.observe(9, {}, t)
    assert [k for k, _ in fired] == ["throughput_regression"]
    assert fired[0][1]["iters_per_s"] < fired[0][1]["ema_iters_per_s"]
    t += 10.0  # still slow: ALREADY tripped, no second event
    m.observe(10, {}, t)
    assert len(fired) == 1
    for it in range(11, 40):  # recovery re-arms...
        t += 1.0
        m.observe(it, {}, t)
    t += 30.0  # ...so a second CONFIRMED regression fires again
    m.observe(40, {}, t)
    t += 30.0
    m.observe(41, {}, t)
    assert [k for k, _ in fired] == ["throughput_regression"] * 2


def test_throughput_monitor_quiet_on_checkpoint_blips():
    fired = []
    m = ThroughputMonitor(lambda kind, **f: fired.append(kind), drop_threshold=0.5,
                          warmup_observations=2)
    t = 0.0
    for it in range(1, 30):
        t += 5.0 if it % 7 == 0 else 1.0  # a save blip every 7th window
        m.observe(it, {}, t)
    assert fired == []


def test_throughput_monitor_threshold_boundary():
    """drop_threshold=0.5 with the EMA frozen (alpha 0): a sustained rate
    just ABOVE half the baseline stays quiet, just BELOW fires."""
    for rate_frac, should_fire in ((0.55, False), (0.45, True)):
        fired = []
        m = ThroughputMonitor(lambda kind, **f: fired.append(kind), drop_threshold=0.5,
                              warmup_observations=2, ema_alpha=0.0)
        t = 0.0
        for it in range(1, 10):
            t += 1.0
            m.observe(it, {}, t)
        for it in range(10, 16):
            t += 1.0 / rate_frac
            m.observe(it, {}, t)
        assert bool(fired) == should_fire, (rate_frac, fired)


def test_divergence_monitor_collapse_boundary():
    for value, should_fire in ((11.0, False), (9.0, True)):
        fired = []
        m = DivergenceMonitor(lambda kind, **f: fired.append(kind), collapse_frac=0.1)
        m.observe(0, {"avg_return_ema": 100.0})
        m.observe(1, {"avg_return_ema": value})
        assert bool(fired) == should_fire, (value, fired)


def test_divergence_monitor_nonfinite_loss():
    fired = []
    m = DivergenceMonitor(lambda kind, **f: fired.append((kind, f)))
    for it in range(5):
        m.observe(it, {"loss": 0.5, "critic_loss": 0.1})
    assert fired == []
    m.observe(5, {"loss": float("nan")})
    m.observe(6, {"loss": math.inf})  # one event covers the run
    assert len(fired) == 1
    kind, f = fired[0]
    assert kind == "divergence" and f["reason"] == "non_finite_loss"


def test_divergence_monitor_return_collapse():
    fired = []
    m = DivergenceMonitor(lambda kind, **f: fired.append((kind, f)), collapse_frac=0.1)
    for it, r in enumerate([10.0, 120.0, 200.0, 190.0, 150.0]):
        m.observe(it, {"avg_return_ema": r})
    assert fired == []
    m.observe(5, {"avg_return_ema": 5.0})  # < 10% of the best 200
    assert [k for k, _ in fired] == ["divergence"]
    assert fired[0][1]["reason"] == "return_collapse"
    m.observe(6, {"avg_return_ema": 4.0})
    assert len(fired) == 1


def test_divergence_monitor_quiet_below_progress_floor():
    fired = []
    m = DivergenceMonitor(lambda kind, **f: fired.append(kind), min_progress=1.0)
    m.observe(0, {"avg_return_ema": 0.4})
    m.observe(1, {"avg_return_ema": 0.01})
    assert fired == []


def test_monitors_give_jax_events_on_the_same_feed():
    """One feed (a steady rate, a slowdown, a recovery, a return collapse
    and a NaN loss) through both packages' monitors: the same events, in
    the same order, with the same fields."""
    feed, t = [], 0.0
    for it in range(1, 60):
        t += 1.0 if it < 20 or it > 30 else 4.0
        ret = 50.0 + it if it < 40 else 2.0
        row = {"avg_return_ema": ret, "loss": float("nan") if it == 55 else 0.5}
        feed.append((it, row, t))
    events = []
    for thr, div in ((ThroughputMonitor, DivergenceMonitor),
                     (JThroughputMonitor, JDivergenceMonitor)):
        out: list = []
        mons = [thr(lambda k, **f: out.append((k, f)), warmup_observations=2),
                div(lambda k, **f: out.append((k, f)))]
        for it, row, now in feed:
            for m in mons:
                m.observe(it, row, now)
        events.append(out)
    assert events[0] == events[1]
    assert [k for k, _ in events[0]] == ["throughput_regression", "divergence", "divergence"]


def test_session_routes_observe_to_events(tmp_path):
    with telemetry.TelemetrySession(tmp_path, sample_resources=False) as sess:
        sess.observe(1, {"loss": 1.0})
        sess.observe(2, {"loss": float("nan")})
    kinds = [r["kind"] for r in _read_jsonl(tmp_path / "events.jsonl")]
    assert kinds == ["session_start", "divergence", "session_end"]


# ------------------------------------------------------------- watchdog


def test_stall_report_names_open_span(tmp_path):
    with telemetry.TelemetrySession(tmp_path, sample_resources=False):
        with telemetry.span("update", it=7):
            msg = telemetry.stall_report(12.3)
    assert "update" in msg and "12.3" not in msg
    stall = [r for r in _read_jsonl(tmp_path / "events.jsonl") if r["kind"] == "stall"]
    assert len(stall) == 1
    assert stall[0]["phase"] == "update" and stall[0]["stalled_s"] == 12.3
    assert telemetry.stall_report() == ""  # no open span: an empty clause


def test_stall_report_names_deepest_open_span(tmp_path):
    with telemetry.TelemetrySession(tmp_path, sample_resources=False):
        with telemetry.span("iteration", it=3):
            with telemetry.span("env_step", steps=64):
                msg = telemetry.stall_report(7.0)
    assert "'env_step'" in msg and "'iteration'" not in msg, msg
    stall = [r for r in _read_jsonl(tmp_path / "events.jsonl") if r["kind"] == "stall"]
    assert len(stall) == 1 and stall[0]["phase"] == "env_step"


def test_health_events_are_fsynced(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd), real_fsync(fd))[1])
    with telemetry.TelemetrySession(tmp_path, sample_resources=False) as s:
        s.event("session_note")  # lifecycle: no fsync
        assert synced == []
        s.observe(1, {"loss": float("nan")})  # divergence: durable
    assert len(synced) >= 3  # all three sinks


def test_watchdog_exit42_diagnosis_includes_open_span(tmp_path):
    """A process wedged INSIDE a span dies with exit 42, the stderr
    diagnosis names the span, and the stall event and a flight dump are on
    disk despite the os._exit teardown."""
    from actor_critic_tpu_torch.telemetry import flight
    from actor_critic_tpu_torch.utils import watchdog

    proc = subprocess.run(
        [sys.executable, "-c", (
            "import time\n"
            "from actor_critic_tpu_torch import telemetry\n"
            "from actor_critic_tpu_torch.utils.watchdog import StallWatchdog\n"
            f"s = telemetry.TelemetrySession({str(tmp_path)!r}, sample_resources=False)\n"
            "telemetry.set_current(s)\n"
            "StallWatchdog(0.5, startup_grace_s=0.0).start()\n"
            "with telemetry.span('update', it=681):\n"
            "    time.sleep(30)\n"  # the wedged device call
        )],
        capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == watchdog.STALL_EXIT_CODE, (proc.returncode, proc.stderr)
    assert "last open telemetry span: 'update'" in proc.stderr, proc.stderr
    stall = [r for r in _read_jsonl(tmp_path / "events.jsonl") if r["kind"] == "stall"]
    assert len(stall) == 1 and stall[0]["phase"] == "update", stall
    assert len(flight.find_dumps(tmp_path)) == 1


# ------------------------------------------------------------ reporting


def test_run_report_renders_health_and_resources(tmp_path):
    """What a port session writes (spans, a resources row, a divergence,
    a torn final span line) renders: the per-phase share, health, RSS,
    recompiles and the metrics' eval summary."""
    with telemetry.TelemetrySession(tmp_path, resource_interval_s=0.02) as s:
        t0 = time.perf_counter()
        telemetry.complete_span("iteration", t0, 100e-6)
        telemetry.complete_span("update", t0 + 10e-6, 80e-6)
        s.observe(1, {"loss": float("nan")})
    with open(tmp_path / "spans.jsonl", "a") as f:
        f.write('{"torn')  # a stall-kill mid-write must not abort the report
    (tmp_path / "metrics.jsonl").write_text(json.dumps(
        {"iter": 3, "wall_s": 2.0, "loss": 0.5, "env_steps": 300, "eval_return": 21.0}) + "\n")
    report = run_report.render(str(tmp_path))
    assert "divergence" in report
    assert "| update | 1 |" in report
    assert "80.0%" in report
    assert "RSS" in report and "recompiles" in report.lower()
    assert "eval: best 21.0" in report


def test_run_report_stitches_resume_segments(tmp_path):
    """Two port sessions in one directory (a run and its resume after an
    exit 42) render as two segments, their recompile counts summed as
    positive deltas, and `--trace` re-anchors each segment's clock."""
    for leg in range(2):
        with telemetry.TelemetrySession(tmp_path, sample_resources=False):
            with profiler.record_compile(f"stub.train_step[x{leg}]", "x:float32[2]"):
                pass
            with telemetry.span("update", it=leg):
                pass
            if leg == 0:
                telemetry.event("stall", phase="update")
        if leg == 0:
            time.sleep(0.05)
    report = run_report.render(str(tmp_path))
    assert "2 session segments" in report and "stall" in report
    run_report.write_trace(run_report.read_jsonl(str(tmp_path / "spans.jsonl")),
                           str(tmp_path / "trace.json"))
    ts = [e["ts"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]
          if e["ph"] == "X"]
    assert len(ts) == 2 and ts[1] > ts[0] + 0.04e6  # segment 2 after segment 1


def test_read_jsonl_tolerates_torn_final_line(tmp_path, capsys):
    with telemetry.TelemetrySession(tmp_path, sample_resources=False) as s:
        s.event("a")
        s.event("b")
    p = tmp_path / "events.jsonl"
    with open(p, "a") as f:
        f.write('{"kind": "stall", "stalled_s": 3')  # torn: no close, no newline
    rows = run_report.read_jsonl(str(p))
    assert [r["kind"] for r in rows] == ["session_start", "a", "b", "session_end"]
    assert capsys.readouterr().err == ""
    with open(p, "w") as f:
        f.write(json.dumps({"kind": "a"}) + "\n{corrupt\n" + json.dumps({"kind": "c"}) + "\n")
    assert [r["kind"] for r in run_report.read_jsonl(str(p))] == ["a", "c"]
    assert "1 undecodable" in capsys.readouterr().err


def test_run_report_recompile_attribution_and_slowest_spans(tmp_path):
    """The port's compile events (two captures of one step at different
    shapes, a build and a cache hit) group into the attribution table
    naming the distinct signatures; the slowest-spans table ranks raw
    durations; a profile window becomes a link."""
    with telemetry.TelemetrySession(tmp_path, sample_resources=False) as s:
        for n in (8, 16):
            x = torch.zeros(n, 3)
            with profiler.record_compile("a2c.train_step[x1]", profiler.signature_of({"x": x})):
                time.sleep(0.01)
        profiler.record_build("gae.cu", 2.5, "sm_90a")
        profiler.record_build("gae.cu", 0.0, "sm_90a", cache_hit=True)
        t0 = time.perf_counter()
        telemetry.complete_span("update", t0, 10e-6)
        telemetry.complete_span("checkpoint", t0, 40.0)
        telemetry.complete_span("update", t0, 30e-6)
        s.event("profile_done", path=str(tmp_path / "profile_001"), wall_s=1.5)
    report = run_report.render(str(tmp_path))
    assert "## Recompile attribution" in report
    assert "| `a2c.train_step[x1]` | 2 | 0 |" in report, report
    assert "| `gae.cu` | 2 | 1 | 2.50s" in report, report
    assert "2 argument signatures" in report
    assert "x:float32[8,3]" in report and "x:float32[16,3]" in report
    slow_sec = report.split("## Slowest spans")[1].split("##")[0]
    assert slow_sec.splitlines()[4].startswith("| 1 | checkpoint | 40.00s")
    assert "## Profile captures" in report and "profile_001" in report
    assert "| **compile**" not in report and "| **profile_done**" not in report


def test_phase_breakdown_separates_worker_lanes(tmp_path):
    """Spans the tracer relays from other processes (`complete_foreign`,
    their own pid lanes) do not enter the share table: they get their own
    per-pid summary line."""
    with telemetry.TelemetrySession(tmp_path, sample_resources=False) as s:
        t0 = time.perf_counter()
        telemetry.complete_span("iteration", t0, 100e-6)
        telemetry.complete_span("env_step", t0 + 5e-6, 90e-6)
        epoch = time.time()
        s.tracer.complete_foreign_many([
            ("env_step_worker", epoch + 10e-6 * i, 80e-6, pid, 0, {"worker": pid - 100})
            for pid in (100, 101, 102, 103) for i in range(2)])
    lines = "\n".join(run_report.phase_breakdown(_read_jsonl(tmp_path / "spans.jsonl")))
    assert "| env_step_worker" not in lines
    assert "4 worker process(es)" in lines and "pid 100: 2 steps" in lines
    assert "90.0%" in lines and "360" not in lines


def test_run_report_cli(tmp_path):
    d = tmp_path / "t"
    with telemetry.TelemetrySession(d, sample_resources=False):
        with telemetry.span("update"):
            pass
    out = tmp_path / "report.md"
    assert run_report.main([str(d), "--trace", "-o", str(out)]) == 0
    assert "# Run report" in out.read_text()
    assert json.load(open(d / "trace.json"))["traceEvents"]


def test_fused_loop_emits_update_log_and_checkpoint_spans(tmp_path):
    """The fused loop emits an update span per dispatch, a log span per
    dispatch and a checkpoint span at every save boundary EVEN with
    ckpt=None (`saved` False), so checkpointed and checkpoint-free runs
    compare phase for phase."""
    from actor_critic_tpu_torch.algos.loop import fused_train_loop

    class _State:
        ep_return = torch.zeros(1)
        n = 0

    def step(s):
        s.n += 1
        return s, {"loss": torch.zeros(())}

    with telemetry.TelemetrySession(tmp_path, sample_resources=False):
        state, _ = fused_train_loop(lambda env, cfg: step, None, None, None, 3, state=_State(),
                                    log_fn=lambda it, m: None, device="cpu")
    assert state.n == 3
    complete = [e for e in _read_jsonl(tmp_path / "spans.jsonl") if e["ph"] == "X"]
    names = [e["name"] for e in complete]
    assert names.count("update") == 3 and names.count("log") == 3, names
    ck = [e for e in complete if e["name"] == "checkpoint"]
    assert len(ck) == 1 and ck[0]["args"]["saved"] is False, ck


# ------------------------------------------------- the CLIs against JAX's


def _trace_shape(directory):
    """(ph, name, arg keys) of every non-metadata span event, in file
    order, and the event kinds apart from `compile`."""
    spans = [(e["ph"], e["name"], tuple(sorted(e.get("args", {}))))
             for e in _read_jsonl(Path(directory) / "spans.jsonl") if e["ph"] != "M"]
    kinds = [e["kind"] for e in _read_jsonl(Path(directory) / "events.jsonl")
             if e["kind"] != "compile"]
    return spans, kinds


@pytest.mark.parametrize("argv", [
    ["--preset", "a2c_cartpole", "--set", "num_envs=8", "--set", "rollout_steps=8",
     "--iterations", "6", "--chunk", "2", "--save-every", "2", "--log-every", "2"],
    ["--algo", "ppo", "--env", "native:CartPole-v1", "--set", "num_envs=2", "--set",
     "rollout_steps=8", "--set", "epochs=1", "--set", "num_minibatches=1", "--set",
     "hidden=16", "--iterations", "3", "--log-every", "1"],
], ids=["fused_a2c_chunk2", "host_ppo_native"])
def test_cli_trace_matches_jax(argv, tmp_path, capsys):
    """The same command line through JAX's `train.py` and the port's
    `train.main --device cpu`, each with `--telemetry-dir`: the same span
    names with the same argument keys in the same order, the same event
    kinds apart from `compile`, and `scripts/run_report.py` renders both.
    Both runs are unwarmed: JAX's CLI skips its warm-up without a cache
    directory, which the port's warm-up does not need, so the port's is
    turned off with the flag both CLIs take."""
    import train as jtrain

    common = argv + ["--quiet", "--telemetry-sample-s", "0.05", "--no-warmup"]
    assert jtrain.main(common + ["--telemetry-dir", str(tmp_path / "jax"),
                                 "--metrics", str(tmp_path / "jax.jsonl")]) == 0
    assert train.main(common + ["--telemetry-dir", str(tmp_path / "port"),
                                "--metrics", str(tmp_path / "port.jsonl"),
                                "--device", "cpu"]) == 0
    capsys.readouterr()
    jax_spans, jax_kinds = _trace_shape(tmp_path / "jax")
    port_spans, port_kinds = _trace_shape(tmp_path / "port")
    assert port_spans == jax_spans
    assert port_kinds == jax_kinds == ["session_start", "session_end"]
    for d in ("jax", "port"):
        assert run_report.main([str(tmp_path / d), "-o", str(tmp_path / f"{d}.md")]) == 0
