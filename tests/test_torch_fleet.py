"""The serving fleet on the CPU (`telemetry/fleet.py`,
`serving/fleet_proxy.py`, the gateway's `/fleetz` routes, `serve.py
--distributed` and `--sync-mailbox`, `serve_fleet.py`), against the JAX
package's (tests/test_fleet.py, tests/test_serving_fleet.py):

- announce and discover over the mailbox (atomic, torn reads None), the
  exact reconstruction of histogram snapshots, and `FleetAggregator`'s
  merged views equal to JAX's aggregator's on the same scrape text
  (`/fleetz` JSON and `/fleetz/metrics` text), dead ranks unreachable;
- `/fleetz` through a gateway merging two live replicas' `/metrics`;
- the proxy: round-robin relay, failover when a replica is killed, health
  eviction and readmission, an application 503 relayed verbatim;
- `MailboxPolicySyncer` into a real engine: a newer version swapped (the
  served action the new parameters' eager act), a duplicate, a version
  regression and a torn file dropped, a non-finite snapshot refused while
  the old version keeps serving;
- `serve.main --distributed --sync-mailbox` (fleet membership on
  `/healthz`, `/fleetz`, the syncer's swap) and the `serve_fleet` CLI in
  a subprocess.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from actor_critic_tpu.telemetry import fleet as jfleet
from actor_critic_tpu_torch import serve, serving
from actor_critic_tpu_torch.algos import ppo
from actor_critic_tpu_torch.envs import make_cartpole
from actor_critic_tpu_torch.parallel import multihost
from actor_critic_tpu_torch.telemetry import fleet, histo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(url, body, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        body, status = e.read().decode(), e.code
    try:
        return status, json.loads(body)
    except json.JSONDecodeError:
        return status, body


# ------------------------------------------------------ announce/discover


def test_announce_then_discover_round_trip(tmp_path):
    fleet.announce_endpoint(tmp_path, 0, "http://127.0.0.1:9100")
    fleet.announce_endpoint(tmp_path, 3, "http://127.0.0.1:9103", seed=7)
    want = {0: "http://127.0.0.1:9100", 3: "http://127.0.0.1:9103"}
    assert fleet.discover_endpoints(tmp_path) == want == jfleet.discover_endpoints(tmp_path)
    ann = fleet.read_endpoint(tmp_path, 3)
    assert ann["rank"] == 3 and ann["seed"] == 7 and ann["pid"] > 0
    fleet.announce_endpoint(tmp_path, 0, "http://127.0.0.1:9200")
    assert fleet.discover_endpoints(tmp_path)[0] == "http://127.0.0.1:9200"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "telemetry_endpoint_host0.json", "telemetry_endpoint_host3.json"]


def test_torn_announce_reads_as_none_not_crash(tmp_path):
    with open(fleet.endpoint_file(tmp_path, 2), "w") as f:
        f.write('{"rank": 2, "url"')
    assert fleet.read_endpoint(tmp_path, 2) is None
    assert fleet.discover_endpoints(tmp_path) == {}
    assert fleet.read_endpoint(tmp_path, 99) is None
    assert fleet.discover_endpoints(tmp_path / "nope") == {}


def test_snapshots_from_parsed_round_trips_render():
    h = histo.Histogram((1.0, 2.5, 10.0))
    h.observe_many([0.5, 2.0, 9.0, 50.0])
    snap = h.snapshot(labels={"policy": "champ"})
    text = "\n".join(histo.render_prometheus("serving_latency_ms", snap))
    back = fleet.snapshots_from_parsed(histo.parse_prometheus(text))[
        ("serving_latency_ms", (("policy", "champ"),))]
    assert back["buckets"] == snap["buckets"] and back["count"] == snap["count"]
    assert back["boundaries"] == list(snap["boundaries"])
    assert back["sum"] == pytest.approx(snap["sum"])


# ------------------------------------------------------------- aggregator


def _stubbed(module, rank_texts):
    agg = module.FleetAggregator(endpoints={r: f"http://stub:{r}" for r in rank_texts})
    agg._fetch = lambda url, _t=rank_texts: _t[int(url.rsplit(":", 1)[1])]
    return agg


def _rank_text(scale: int) -> str:
    h = histo.Histogram((1.0, 10.0))
    h.observe_many([0.5] * scale + [5.0] * scale + [50.0] * scale)
    lines = ["actor_critic_up 1", f"actor_critic_serving_requests_total {10 * scale}",
             f"actor_critic_rss_bytes {1000 * scale}"] + histo.render_prometheus(
        "actor_critic_serving_latency_ms", h.snapshot(labels={"policy": "default"}))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("texts", [{0: 2, 1: 3}, {0: 1, 1: None}], ids=["both", "one_dead"])
def test_aggregator_equals_jax_on_the_same_scrapes(texts):
    rank_texts = {r: None if s is None else _rank_text(s) for r, s in texts.items()}
    port, jax_agg = _stubbed(fleet, rank_texts), _stubbed(jfleet, rank_texts)
    z = port.fleetz()
    assert z == jax_agg.fleetz()
    assert port.merged_metrics() == jax_agg.merged_metrics()
    if texts[1] is None:
        assert z["reachable"] == [0] and z["unreachable"] == [1]
        assert z["ranks"]["1"] == {"url": "http://stub:1", "up": False}
        assert z["counters"]["actor_critic_serving_requests_total"] == 10
    else:
        assert z["counters"]["actor_critic_serving_requests_total"] == 50
        (hist,) = z["histograms"].values()
        assert hist["buckets"] == [5, 10, 15] and hist["count"] == 15 and hist["p99"] == 10.0
        samples = {(n, tuple(sorted(lb.items()))): v
                   for n, lb, v in histo.parse_prometheus(port.merged_metrics())}
        assert samples[("actor_critic_rss_bytes", (("agg", "min"), ("rank", "fleet")))] == 2000
        assert samples[("actor_critic_serving_requests_total", (("rank", "fleet"),))] == 50
    json.dumps(z)


def test_discovery_plus_static_endpoints_merge(tmp_path):
    fleet.announce_endpoint(tmp_path, 0, "http://a:1")
    agg = fleet.FleetAggregator(mailbox_dir=str(tmp_path), endpoints={1: "http://b:2"})
    assert agg.endpoints() == {0: "http://a:1", 1: "http://b:2"}


class StubEngine:
    """torch-free engine: action = obs[:, 0] * params['scale'][0]."""

    max_rows = 8

    def prepare_params(self, params):
        return {k: np.array(v) for k, v in params.items()}

    def act(self, params, obs):
        return np.asarray(obs)[:, 0] * params["scale"][0]


def _stub_gateway(scale: float, **kw):
    store = serving.PolicyStore()
    store.register("default", StubEngine(), {"scale": np.full(1, scale, np.float32)})
    return serving.ServeGateway(store, port=0, max_wait_us=0.0, **kw)


def test_fleetz_merges_two_replicas_metrics(tmp_path):
    """Two replicas announced into one mailbox; a third gateway with the
    aggregator serves `/fleetz` and `/fleetz/metrics` over both live
    `/metrics` (the serving gauge's histograms, counted by requests)."""
    reps = [_stub_gateway(1.0), _stub_gateway(2.0)]
    try:
        for rank, gw in enumerate(reps):
            fleet.announce_endpoint(tmp_path, rank, gw.url)
            for i in range(rank + 2):
                assert _post(gw.url + "/v1/act", {"obs": [[float(i), 0.0]]})[0] == 200
        front = _stub_gateway(3.0, aggregator=fleet.FleetAggregator(mailbox_dir=str(tmp_path)))
        try:
            status, z = _get(front.url + "/fleetz")
            assert status == 200 and z["fleet_size"] == 2 and z["reachable"] == [0, 1]
            assert sorted(z["ranks"]) == ["0", "1"]
            want = jfleet.FleetAggregator(mailbox_dir=str(tmp_path)).fleetz()
            assert z["histograms"].keys() == want["histograms"].keys() and z["histograms"]
            status, text = _get(front.url + "/fleetz/metrics")
            assert status == 200 and 'rank="fleet"' in text and 'rank="1"' in text
            status, body = _get(front.url + "/nope")
            assert status == 404 and "/fleetz" in body["routes"]
        finally:
            front.close()
        status, body = _get(reps[0].url + "/fleetz")  # no aggregator: no route
        assert status == 404 and "/fleetz" not in body["routes"]
    finally:
        for gw in reps:
            gw.close()


# ------------------------------------------------------------------ proxy


class _CannedReplica:
    """An upstream with a canned /v1/act answer and a switchable /healthz."""

    def __init__(self, act_status: int = 200, act_body=None):
        self.act_status, self.act_body = act_status, act_body or {"actions": [0.0]}
        self.healthy = True
        replica = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _send(self, status, payload):
                raw = (json.dumps(payload) + "\n").encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                self._send(200 if replica.healthy else 503, {"ok": replica.healthy})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self._send(replica.act_status, replica.act_body)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def test_proxy_relays_round_robin_and_fails_over_on_a_killed_replica():
    gws = [_stub_gateway(3.0), _stub_gateway(3.0)]
    proxy = serving.FleetProxy([gw.url for gw in gws], port=0, policy="round_robin", probe=False)
    try:
        for i in range(4):
            status, body = _post(proxy.url + "/v1/act", {"obs": [[float(i), 0.0]]})
            assert status == 200 and body["actions"] == [pytest.approx(3.0 * i)]
        status, stats = _get(proxy.url + "/proxyz")
        assert stats["relayed"] == 4 and sorted(r["forwards"] for r in stats["replicas"]) == [2, 2]
        gws[1].close()  # connection refused from now on
        for i in range(6):
            status, body = _post(proxy.url + "/v1/act", {"obs": [[float(i), 0.0]]})
            assert status == 200 and body["actions"] == [pytest.approx(3.0 * i)]
        stats = proxy.stats()
        dead = next(r for r in stats["replicas"] if r["url"] == gws[1].url)
        assert not dead["healthy"] and dead["evictions"] >= 1
        assert stats["failovers"] >= 1 and stats["healthy"] == 1
    finally:
        proxy.close()
        gws[0].close()


def test_proxy_health_probe_evicts_and_readmits():
    replica = _CannedReplica(act_body={"actions": [1.5]})
    proxy = serving.FleetProxy([replica.url], port=0, unhealthy_after=2, probe=False)
    try:
        proxy.probe_once()
        assert proxy.stats()["healthy"] == 1
        replica.healthy = False
        proxy.probe_once()
        assert proxy.stats()["healthy"] == 1  # one failure: not yet
        proxy.probe_once()
        assert proxy.stats()["healthy"] == 0
        status, body = _post(proxy.url + "/v1/act", {"obs": [[0.0]]})
        assert status == 503 and "no healthy replica" in body["error"]
        replica.healthy = True
        proxy.probe_once()
        assert proxy.stats()["healthy"] == 1
        assert _post(proxy.url + "/v1/act", {"obs": [[0.0]]}) == (200, {"actions": [1.5]})
    finally:
        proxy.close()
        replica.close()


def test_proxy_relays_app_503_verbatim_without_failover():
    shedding = _CannedReplica(act_status=503, act_body={"error": "shedding", "shed": True})
    proxy = serving.FleetProxy([shedding.url], port=0, probe=False)
    try:
        for _ in range(3):
            assert _post(proxy.url + "/v1/act", {"obs": [[0.0]]}) == (
                503, {"error": "shedding", "shed": True})
        stats = proxy.stats()
        assert stats["failovers"] == 0 and stats["healthy"] == 1
        assert stats["replicas"][0]["forwards"] == 3
    finally:
        proxy.close()
        shedding.close()


# ------------------------------------------------------- mailbox syncer


def _publish(mailbox, version, net):
    multihost.write_params(mailbox, 0, version, multihost.param_leaves(net))


def test_mailbox_syncer_swaps_into_a_real_engine(tmp_path):
    """A training rank's mailbox snapshot (the PPO network's parameters in
    the port's order) reaches the served policy: newer versions swap,
    duplicates, regressions and torn files are dropped, and a non-finite
    snapshot is refused while the last good version keeps serving."""
    mbox = str(tmp_path)
    spec, cfg = make_cartpole().spec, ppo.PPOConfig(hidden=(16, 16))
    engine = serving.PolicyEngine(spec, cfg, buckets=(1, 4), device="cpu")
    store = serving.PolicyStore()
    store.register("default", engine, serving.init_params(spec, cfg, seed=0))
    engine.warm(store.get().params)
    syncer = serving.MailboxPolicySyncer(store, "default", mbox, rank=0)
    assert syncer.poll_once() is False  # nothing published yet
    obs = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)

    nets = [ppo.make_network(spec, cfg, torch.Generator().manual_seed(s)) for s in (1, 2, 3)]
    _publish(mbox, 1, nets[0])
    assert syncer.poll_once() is True and store.get().version == 1
    served = engine.act(store.get().params, obs)
    with torch.no_grad():
        want = nets[0](torch.from_numpy(obs))[0].mode().numpy()
    assert np.array_equal(served, want)
    assert syncer.poll_once() is False  # the same file again

    _publish(mbox, 3, nets[1])
    assert syncer.poll_once() is True and syncer.version == 3
    _publish(mbox, 2, nets[2])  # a stale snapshot re-landing
    assert syncer.poll_once() is False and store.get().version == 3

    path = multihost.params_file(mbox, 0)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert syncer.poll_once() is False and store.get().version == 3

    # A non-finite snapshot: written around the mailbox's own gate, as a
    # faulty publisher would; the swap's numguard refuses it.
    from actor_critic_tpu_torch.utils.numguard import NonFiniteError

    leaves = multihost.param_leaves(nets[2])
    leaves[0][0, 0] = np.nan
    np.savez(path, **{f"leaf{i}": v for i, v in enumerate(leaves)},
             version=np.asarray(4, np.int64))
    with pytest.raises(NonFiniteError):
        syncer.poll_once()
    assert store.get().version == 3
    with torch.no_grad():
        want = nets[1](torch.from_numpy(obs))[0].mode().numpy()
    assert np.array_equal(engine.act(store.get().params, obs), want)
    assert syncer.swaps == 2 and engine.graphs_captured == 0  # the CPU captures nothing


# ------------------------------------------------------------------- CLIs


def test_serve_main_distributed_with_sync_mailbox(tmp_path, monkeypatch, capsys):
    mbox, sync = tmp_path / "fleet", tmp_path / "sync"
    spec, cfg = make_cartpole().spec, ppo.PPOConfig()
    net = ppo.make_network(spec, cfg, torch.Generator().manual_seed(5))
    multihost.write_params(str(sync), 0, 7, multihost.param_leaves(net))
    multihost.write_params(str(mbox), 1, 2, multihost.param_leaves(net))  # the peer rank
    seen = {}

    def checks(running):
        deadline = time.monotonic() + 30
        while running.store.get().version != 7 and time.monotonic() < deadline:
            time.sleep(0.05)
        url = running.gateway.url
        seen["policies"] = _get(url + "/v1/policies")
        seen["healthz"] = _get(url + "/healthz")
        seen["fleetz"] = _get(url + "/fleetz")
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "wait_for_interrupt", checks)
    assert serve.main(["--preset", "ppo_cartpole", "--random-init", "--port", "0", "--device",
                       "cpu", "--buckets", "1,4", "--distributed", "--mailbox-dir", str(mbox),
                       "--rank", "0", "--world", "2", "--telemetry-dir", str(tmp_path / "tel"),
                       "--sync-mailbox", str(sync), "--sync-poll-s", "0.05"]) == 0
    out = capsys.readouterr().out
    assert "policy sync: 'default'" in out and "/fleetz /fleetz/metrics" in out
    assert seen["policies"] == (200, {"policies": {"default": 7}, "default": "default"})
    status, health = seen["healthz"]
    assert status == 200 and health["fleet"]["ok"] and health["fleet"]["world"] == 2
    assert health["fleet"]["peers"]["1"]["version"] == 2
    status, z = seen["fleetz"]
    assert status == 200 and z["reachable"] == [0]  # this rank's own announced exporter
    assert fleet.discover_endpoints(str(mbox))[0].startswith("http://127.0.0.1:")


def test_serve_distributed_flags_are_checked():
    with pytest.raises(SystemExit, match="--mailbox-dir and --world"):
        serve.parse_args(["--preset", "ppo_cartpole", "--distributed"])
    args = serve.parse_args(["--preset", "ppo_cartpole", "--distributed", "--mailbox-dir", "/m",
                             "--world", "2", "--telemetry-bind", "0.0.0.0"])
    assert args.telemetry_bind == "0.0.0.0"  # a fleet's ranks scrape each other
    store = serving.PolicyStore()
    store.register("default", StubEngine(), {"scale": np.ones(1, np.float32)})
    with pytest.raises(SystemExit, match="names no resident policy"):
        serve.start_syncer(serve.parse_args(["--preset", "ppo_cartpole", "--sync-mailbox", "/m",
                                             "--sync-policy", "nope"]), store)


def test_serve_fleet_cli_relays_and_shuts_down():
    gw = _stub_gateway(4.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "actor_critic_tpu_torch.serve_fleet", "--replica", gw.url,
         "--port", "0", "--health-interval", "0.2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("fleet proxy on http://"), line
        url = line.split()[3]
        status, body = _post(url + "/v1/act", {"obs": [[2.0, 0.0]]})
        assert status == 200 and body["actions"] == [8.0] and body["policy"] == "default"
        status, stats = _get(url + "/proxyz")
        assert status == 200 and stats["relayed"] >= 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=20) == 0
        assert "fleet proxy closed" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        gw.close()
