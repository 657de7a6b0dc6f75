"""The port's live run introspection (`actor_critic_tpu_torch/telemetry/
exporter.py` and `profiler.py`; JAX's `tests/test_exporter.py`), all on an
EPHEMERAL port (serve_port=0):

- `/metrics` is valid Prometheus text with steps/s, the recompile counter
  (captures and builds), registered sampler gauges and the last observe()
  row; a closed session renders `up 0` alone;
- `/healthz` reports the open span and the watchdog's staleness, and goes
  503 exactly when an armed watchdog is past its timeout outside grace;
- `/profile?iters=N` (and SIGUSR2) arm a windowed torch.profiler capture
  that the loop's tick starts and stops, leaving a trace directory under
  the telemetry dir plus profile_start/profile_done events; a CUDA-graph
  capture closes an open window first;
- the compile record (the counterpart of JAX's compile listener, driven by
  a stub capture and a stub build) gives `compile` events whose signatures
  name what changed, and counts cache hits apart;
- the CLI refuses `--telemetry-port` without `--telemetry-dir`, a zero
  sample cadence and a non-loopback bind, and a live CPU run answers
  `/metrics` and `/healthz` while it trains.
"""

import json
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from actor_critic_tpu_torch import telemetry, train
from actor_critic_tpu_torch.telemetry import profiler
from actor_critic_tpu_torch.telemetry.exporter import render_metrics
from actor_critic_tpu_torch.utils import watchdog as watchdog_mod

_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$")


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _session(tmp_path, **kw):
    kw.setdefault("sample_resources", False)
    kw.setdefault("serve_port", 0)
    return telemetry.TelemetrySession(tmp_path, **kw)


# ---------------------------------------------------------------- /metrics


def test_metrics_is_valid_prometheus_text_with_rates(tmp_path):
    with _session(tmp_path) as s:
        telemetry.observe(1, {"loss": 0.5, "env_steps": 100})
        time.sleep(0.02)
        telemetry.observe(3, {"loss": 0.25, "env_steps": 300})
        status, body = _get(s.exporter.url + "/metrics")
    assert status == 200
    samples = {}
    for line in body.splitlines():
        if line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE ")), line
            continue
        assert _PROM_LINE.match(line), line
        name_part, value = line.rsplit(" ", 1)
        samples[name_part] = float(value)
    assert samples["actor_critic_up"] == 1
    assert samples["actor_critic_recompiles_total"] >= 0
    assert samples["actor_critic_rss_bytes"] > 0
    assert samples["actor_critic_env_steps_per_s"] > 0
    assert samples["actor_critic_iters_per_s"] > 0
    assert samples['actor_critic_train_metric{metric="loss"}'] == 0.25
    assert samples["actor_critic_train_iteration"] == 3


def test_metrics_includes_registered_gauges(tmp_path):
    from actor_critic_tpu_torch.telemetry import sampler

    key = sampler.register_gauge("probe_queue", lambda: {"depth": 3, "drops_full": 2})
    try:
        with _session(tmp_path) as s:
            body = render_metrics(s)  # a pure render, no socket needed
    finally:
        sampler.unregister_gauge(key)
    assert "actor_critic_probe_queue_depth 3" in body
    assert "actor_critic_probe_queue_drops_full 2" in body


def test_metrics_drops_nan_training_values(tmp_path):
    with _session(tmp_path) as s:
        telemetry.observe(1, {"loss": float("nan"), "ok": 1.0})
        body = render_metrics(s)
    assert 'metric="ok"' in body
    assert 'metric="loss"' not in body  # NaN would break scrapers


# ---------------------------------------------------------------- /healthz


def test_healthz_reports_open_span_and_ok(tmp_path):
    with _session(tmp_path) as s:
        with telemetry.span("update", it=5):
            status, body = _get(s.exporter.url + "/healthz")
    h = json.loads(body)
    assert status == 200 and h["status"] == "ok"
    assert h["open_span"]["name"] == "update" and h["open_span"]["open_s"] >= 0
    assert h["profiler"]["state"] == "idle"


def test_healthz_503_when_watchdog_stalled(tmp_path):
    """An armed watchdog past its timeout outside grace flips /healthz to
    503/stalled. The watchdog is injected un-started (its firing thread
    would os._exit the test runner)."""
    w = watchdog_mod.StallWatchdog(timeout_s=1.0, startup_grace_s=0.0)
    now = time.monotonic()
    w._last = now - 10.0
    w._grace_until = now - 5.0
    watchdog_mod._ACTIVE.append(w)
    try:
        with _session(tmp_path) as s:
            url = s.exporter.url + "/healthz"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(url, timeout=10)
            assert ei.value.code == 503
            h = json.loads(ei.value.read())
            assert h["status"] == "stalled"
            assert h["watchdog"]["staleness_s"] > h["watchdog"]["timeout_s"]
            w.touch()  # a heartbeat brings it back to 200
            status, body = _get(url)
            assert status == 200 and json.loads(body)["status"] == "ok"
    finally:
        watchdog_mod._ACTIVE.remove(w)


def test_unknown_route_404(tmp_path):
    with _session(tmp_path) as s:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(s.exporter.url + "/nope", timeout=10)
        assert ei.value.code == 404


# ---------------------------------------------------------------- /profile


def test_profile_endpoint_captures_a_window(tmp_path):
    import torch

    with _session(tmp_path) as s:
        status, body = _get(s.exporter.url + "/profile?iters=2")
        assert status == 202 and json.loads(body)["state"] == "armed"
        telemetry.profiler_tick()  # the capture starts here
        assert s.profiler.status()["state"] == "active"
        (torch.ones(4) * 2.0).sum()
        telemetry.profiler_tick()
        telemetry.profiler_tick()  # a window of 2 ends: the capture stops
        assert s.profiler.status() == {"state": "idle", "captures": 1}
    events = _read_jsonl(tmp_path / "events.jsonl")
    start = [e for e in events if e["kind"] == "profile_start"]
    done = [e for e in events if e["kind"] == "profile_done"]
    assert len(start) == 1 and len(done) == 1 and start[0]["iters"] == 2
    path = done[0]["path"]
    assert path.startswith(str(tmp_path)) and os.path.isdir(path)
    assert any(os.scandir(path)), "profiler wrote an empty directory"
    names = [e["name"] for e in _read_jsonl(tmp_path / "spans.jsonl") if e.get("ph") == "X"]
    assert "profile" in names


def test_profile_rejects_bad_iters(tmp_path):
    with _session(tmp_path) as s:
        for q in ("iters=0", "iters=abc"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(s.exporter.url + "/profile?" + q, timeout=10)
            assert ei.value.code == 400


def test_arming_twice_keeps_first_window(tmp_path):
    with _session(tmp_path, serve_port=None) as s:
        assert s.profiler.arm(3)["iters"] == 3
        assert s.profiler.arm(50)["iters"] == 3  # a no-op report, no error
        s.profiler._armed_iters = 0  # disarm without starting a capture


@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"), reason="no SIGUSR2 on this platform")
def test_sigusr2_arms_capture(tmp_path):
    from actor_critic_tpu_torch.telemetry.profiler import install_sigusr2

    assert install_sigusr2(iters=4)
    try:
        with _session(tmp_path, serve_port=None) as s:
            os.kill(os.getpid(), signal.SIGUSR2)
            deadline = time.monotonic() + 5.0
            while s.profiler.status()["state"] != "armed" and time.monotonic() < deadline:
                time.sleep(0.01)
            assert s.profiler.status()["state"] == "armed"
            assert s.profiler.status()["iters"] == 4
            s.profiler._arm_seen = s.profiler._arm_requests  # disarm
    finally:
        signal.signal(signal.SIGUSR2, signal.SIG_DFL)


def test_capture_closes_an_open_window(tmp_path):
    """A CUDA-graph capture (here a stub, through the same `record_compile`
    the capture sites use) stops an active window first; the window's
    `profile_done` says so, and a build leaves the window open."""
    with _session(tmp_path, serve_port=None) as s:
        s.profiler.arm(5)
        telemetry.profiler_tick()
        with profiler.record_compile("stub.build", "sm_90a", capture=False):
            pass
        assert s.profiler.status()["state"] == "active"
        with profiler.record_compile("stub.train_step[x1]", "x:float32[4]"):
            pass
        assert s.profiler.status()["state"] == "idle"
    done = [e for e in _read_jsonl(tmp_path / "events.jsonl") if e["kind"] == "profile_done"]
    assert len(done) == 1 and done[0]["cut_by"] == "capture"


# ------------------------------------------------------------ compile record


def test_compile_events_name_the_changed_signature(tmp_path):
    """Two captures of one step at different shapes give `compile` events
    whose signatures DIFFER (the recompile-attribution contract); a build
    that found its library is a cache hit, recorded but not a recompile."""
    import torch

    from actor_critic_tpu_torch.telemetry.sampler import sample_row

    before, events_before = profiler.recompile_count(), profiler.compile_event_count()
    with _session(tmp_path, serve_port=None):
        for n in (7, 13):
            x = torch.ones(n)
            with profiler.record_compile("distinctly_named_step[x1]",
                                         profiler.signature_of({"x": x})):
                x * 3.0
        with profiler.record_compile("gae.cu", "sm_90a", cache_hit=True, capture=False):
            pass
        assert sample_row()["recompiles"] == before + 2
    assert profiler.compile_event_count() == events_before + 3
    comps = [e for e in _read_jsonl(tmp_path / "events.jsonl") if e["kind"] == "compile"]
    steps = [e for e in comps if "distinctly_named_step" in e["name"]]
    assert len(steps) == 2
    sigs = {e["signature"] for e in steps}
    assert sigs == {"x:float32[7]", "x:float32[13]"}
    assert all(e["compile_s"] >= 0 for e in comps)
    assert [e.get("cache_hit") for e in comps] == [None, None, True]


# ------------------------------------------------------------- the CLI


def test_cli_telemetry_port_requires_dir():
    with pytest.raises(SystemExit, match="telemetry-dir"):
        train.main(["--preset", "a2c_cartpole", "--telemetry-port", "0", "--device", "cpu"])
    with pytest.raises(SystemExit, match="sample-s"):
        train.main(["--preset", "a2c_cartpole", "--telemetry-dir", "/tmp/x",
                    "--telemetry-sample-s", "0", "--device", "cpu"])


def test_cli_live_introspection_end_to_end(tmp_path):
    """A CPU `train.main` run with --telemetry-port 0 answers /metrics
    (steps/s, the recompile count) and /healthz while it trains, and its
    exporter goes away with the run."""
    tel = tmp_path / "tel"
    argv = ["--algo", "a2c", "--env", "jax:two_state", "--iterations", "100000",
            "--log-every", "5", "--quiet", "--set", "num_envs=8", "--set", "rollout_steps=4",
            "--set", "hidden=16", "--metrics", str(tmp_path / "m.jsonl"), "--device", "cpu",
            "--telemetry-dir", str(tel), "--telemetry-port", "0", "--stall-timeout", "60"]
    stop = threading.Event()
    result = {}

    def run():
        import actor_critic_tpu_torch.algos.loop as loop_mod

        real = loop_mod.watchdog.beat

        def beat():  # ends the run from the test once it has seen enough
            if stop.is_set():
                raise KeyboardInterrupt
            real()

        loop_mod.watchdog.beat = beat
        try:
            result["rc"] = train.main(argv)
        except KeyboardInterrupt:
            result["rc"] = "stopped"
        finally:
            loop_mod.watchdog.beat = real

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while telemetry.current() is None or telemetry.current().exporter is None:
            assert time.monotonic() < deadline and t.is_alive()
            time.sleep(0.02)
        url = telemetry.current().exporter.url
        body = ""
        while time.monotonic() < deadline:
            _, body = _get(url + "/metrics")
            if "actor_critic_env_steps_per_s" in body:
                break
            time.sleep(0.1)
        assert "actor_critic_env_steps_per_s" in body, body[-2000:]
        assert "actor_critic_recompiles_total" in body
        status, h = _get(url + "/healthz")
        assert status == 200 and json.loads(h)["status"] == "ok"
        assert json.loads(h)["watchdog"]["timeout_s"] == 60
    finally:
        stop.set()
        t.join(30)
    assert result["rc"] == "stopped" and telemetry.current() is None
    assert not watchdog_mod.armed()
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/healthz", timeout=2)


def test_ephemeral_port_reported_on_session_object(tmp_path):
    with _session(tmp_path) as s:
        port = s.exporter_port
        assert port not in (None, 0)
        assert s.exporter.url.endswith(f":{port}")
        status, _ = _get(s.exporter.url + "/healthz")
        assert status == 200
    starts = [e for e in _read_jsonl(tmp_path / "events.jsonl") if e["kind"] == "exporter_start"]
    assert starts and starts[0]["port"] == port
    with _session(tmp_path, serve_port=None) as s2:
        assert s2.exporter_port is None


def test_closed_session_renders_tombstone(tmp_path):
    with _session(tmp_path) as s:
        telemetry.observe(1, {"loss": 0.5})
        live = render_metrics(s)
        assert "actor_critic_up 1" in live and "loss" in live
    dead = render_metrics(s)  # the with-block close()d it
    assert dead.strip().splitlines()[-1] == "actor_critic_up 0"
    assert "loss" not in dead
    assert len(dead.strip().splitlines()) <= 3


def test_histogram_gauge_renders_prometheus_family(tmp_path):
    from actor_critic_tpu_torch.telemetry import histo, sampler

    h = histo.Histogram((1.0, 10.0))
    h.observe_many([0.5, 5.0, 50.0])
    snap = h.snapshot(labels={"policy": "champ"})
    snap["metric"] = "latency_ms"
    key = sampler.register_gauge("serving", lambda: {"requests_total": 3,
                                                     "latency_ms_hist_champ": snap})
    try:
        with _session(tmp_path) as s:
            body = render_metrics(s)
    finally:
        sampler.unregister_gauge(key)
    fam = "actor_critic_serving_latency_ms"
    assert f'{fam}_bucket{{policy="champ",le="1"}} 1' in body
    assert f'{fam}_bucket{{policy="champ",le="+Inf"}} 3' in body
    assert f'{fam}_count{{policy="champ"}} 3' in body
    assert "actor_critic_serving_requests_total 3" in body
    for line in body.splitlines():
        if line and not line.startswith("#"):
            assert _PROM_LINE.match(line), line


def test_concurrent_scrape_during_hot_swap_and_sampler_tick(tmp_path):
    """/metrics scraped continuously while the policy store hot-swaps under
    live traffic and the sampler ticks at 20 ms: every scrape is complete
    Prometheus text with monotone histogram counts, and every request's
    hops land in the gateway's session as flow-linked spans."""
    from actor_critic_tpu_torch import serving

    class _Eng:
        max_rows = 8

        def prepare_params(self, params):
            return {k: np.array(v) for k, v in params.items()}

        def act(self, params, obs):
            return np.asarray(obs)[:, 0] * params["scale"][0]

    store = serving.PolicyStore()
    store.register("default", _Eng(), {"scale": np.ones(1, np.float32)}, slo_ms=50.0)
    session = telemetry.TelemetrySession(tmp_path, resource_interval_s=0.02, serve_port=0)
    gw = serving.ServeGateway(store, port=0, session=session)
    stop = threading.Event()
    try:
        errors: list = []

        def traffic():
            i = 0
            while not stop.is_set():
                req = urllib.request.Request(
                    gw.url + "/v1/act", data=json.dumps({"obs": [[float(i + 1), 0.0]]}).encode(),
                    headers={"Content-Type": "application/json", "x-trace-id": f"t{i}"})
                try:
                    urllib.request.urlopen(req, timeout=10).read()
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))
                    return
                i += 1

        def swapper():
            v = 0
            while not stop.is_set():
                v += 1
                store.swap("default", {"scale": np.full(1, float(v + 1), np.float32)}, version=v)
                time.sleep(0.002)

        threads = [threading.Thread(target=traffic), threading.Thread(target=swapper)]
        for t in threads:
            t.start()
        last_count, scrapes = 0.0, 0
        count_re = re.compile(r'actor_critic_serving_latency_ms_count\{policy="default"\} (\S+)')
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            status, text = _get(gw.url + "/metrics")  # the session's exposition
            assert status == 200 and "actor_critic_up 1" in text
            for line in text.splitlines():
                if line and not line.startswith("#"):
                    assert _PROM_LINE.match(line), line
            m = count_re.search(text)
            if m:
                assert float(m.group(1)) >= last_count  # counters never run backwards
                last_count = float(m.group(1))
            scrapes += 1
        stop.set()
        for t in threads:
            t.join(10)
        assert not errors, errors[:3]
        assert scrapes >= 10 and last_count > 0
    finally:
        stop.set()
        gw.close()
        session.close()
    spans = _read_jsonl(tmp_path / "spans.jsonl")
    names = {e["name"] for e in spans if e["ph"] == "X"}
    assert names >= {"serve_request", "serve_parse", "serve_queue_wait", "serve_dispatch",
                     "serve_respond"}
    t0 = [e for e in spans if e.get("args", {}).get("trace") == "t0"]
    assert {e["name"] for e in t0} >= {"serve_request", "serve_parse", "serve_queue_wait",
                                       "serve_respond"}
    flows = [e for e in spans if e.get("cat") == "flow"]
    assert {e["ph"] for e in flows} == {"s", "t", "f"}


def test_validate_bind_refuses_non_loopback_without_distributed():
    """JAX's gate: a non-loopback host is refused unless the caller states
    a `--distributed` fleet (whose ranks scrape each other), with JAX's
    message; loopback hosts always pass."""
    from actor_critic_tpu.telemetry.exporter import validate_bind as jax_validate_bind
    from actor_critic_tpu_torch.telemetry.exporter import validate_bind

    for host in ("127.0.0.1", "localhost", "::1"):
        assert validate_bind(host) == host
        assert validate_bind(host, distributed=True) == host
    for host in ("0.0.0.0", "10.0.0.7"):
        with pytest.raises(ValueError, match="non-loopback.*--distributed") as port_err:
            validate_bind(host)
        with pytest.raises(ValueError) as jax_err:
            jax_validate_bind(host)
        assert str(port_err.value) == str(jax_err.value)
        assert validate_bind(host, distributed=True) == host  # the fleet's scrape path


def test_cli_telemetry_bind_refused_without_distributed():
    with pytest.raises(SystemExit, match="loopback"):
        train.main(["--preset", "a2c_cartpole", "--telemetry-dir", "/tmp/x",
                    "--telemetry-bind", "0.0.0.0", "--device", "cpu"])
