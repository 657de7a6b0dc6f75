"""The port's serving gateway (`actor_critic_tpu_torch/serving/gateway.py`)
over loopback HTTP on the CPU, against the JAX package's
(tests/test_serving.py):

- for the same requests, the port's gateway answers JAX's gateway's status
  codes with JAX's JSON keys: 404 unknown policy or route, 400 bad payload,
  shape or size, 503 on a full queue and on a stalled dispatcher, the swap
  route's 400/404, /healthz and /v1/policies;
- served actions equal the direct act, concurrent mixed-size requests equal
  batch-1 bit for bit (CartPole's discrete actions, JAX's case) with one
  flight worker and with two, trace ids are minted, kept and capped,
  /metrics carries the serving gauges and the SLO histograms, several
  policies route by id, /v1/swap restores a checkpoint (422 for a
  non-finite one), the mirror backend and the sequential baseline serve.

Every HTTP call carries its own timeout and every gateway is closed by its
fixture or a `finally`.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from actor_critic_tpu import serving as jserving
from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu.envs import make_cartpole as jcartpole
from actor_critic_tpu_torch import serving, weights
from actor_critic_tpu_torch.algos import ppo
from actor_critic_tpu_torch.envs import make_cartpole, make_pendulum
from actor_critic_tpu_torch.serving import engine as engine_mod

TIMEOUT = 20.0
BUCKETS = (1, 2, 4, 8)


def _post(url, body, timeout=TIMEOUT, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers.get("x-trace-id")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("x-trace-id")


def _get(url, timeout=TIMEOUT):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class StubEngine:
    """torch-free engine: action = obs[:, 0] * params['scale'][0]."""

    max_rows = 8

    def __init__(self, pad_s: float = 0.0):
        self.pad_s = pad_s

    def prepare_params(self, params):
        return {k: np.array(v) for k, v in params.items()}

    def act(self, params, obs):
        if self.pad_s:
            time.sleep(self.pad_s)
        return np.asarray(obs)[:, 0] * params["scale"][0]


def _cartpole_stores(inflight=1):
    """(JAX store, port store, port engine, numpy params): one CartPole PPO
    policy JAX initialized, resident on both sides."""
    jspec, jcfg = jcartpole().spec, jppo.PPOConfig(hidden=(16, 16))
    jparams = jserving.init_params(jspec, jcfg, "ppo", seed=0)
    np_params = jax.tree.map(np.asarray, jax.device_get(jparams))
    jengine = jserving.PolicyEngine(jspec, jcfg, algo="ppo", buckets=BUCKETS)
    jstore = jserving.PolicyStore()
    jstore.register("default", jengine, jparams)
    engine = serving.PolicyEngine(make_cartpole().spec, ppo.PPOConfig(hidden=(16, 16)),
                                  buckets=BUCKETS, device="cpu", lanes=inflight)
    store = serving.PolicyStore()
    store.register("default", engine, np_params)
    engine.warm(store.get().params)
    return jstore, store, engine, np_params


@pytest.fixture
def both_gateways():
    jstore, store, engine, np_params = _cartpole_stores()
    jgw = jserving.ServeGateway(jstore, port=0, max_wait_us=500.0)
    gw = serving.ServeGateway(store, port=0, max_wait_us=500.0)
    try:
        yield jgw, gw
    finally:
        jgw.close()
        gw.close()


@pytest.fixture(params=[1, 2], ids=["inflight1", "inflight2"])
def port_gateway(request):
    _, store, engine, np_params = _cartpole_stores(inflight=request.param)
    gw = serving.ServeGateway(store, port=0, max_wait_us=1000.0, max_inflight=request.param)
    try:
        yield gw, engine, np_params
    finally:
        gw.close()


# --------------------------------------------------- status-code parity


POSTS = {
    "unknown-policy": ("/v1/act", {"obs": [0.0] * 4, "policy": "ghost"}),
    "missing-obs": ("/v1/act", {}),
    "bad-shape": ("/v1/act", {"obs": [[0.0, 1.0]]}),
    "garbage-obs": ("/v1/act", {"obs": "garbage"}),
    "not-an-object": ("/v1/act", b"[1, 2]"),
    "bad-json": ("/v1/act", b"{nope"),
    "oversized": ("/v1/act", {"obs": [[0.0] * 4] * 9}),
    "single": ("/v1/act", {"obs": [0.1, 0.2, 0.3, 0.4]}),
    "batch": ("/v1/act", {"obs": [[0.1, 0.2, 0.3, 0.4]] * 3, "policy": "default"}),
    "no-route": ("/v1/nope", {"obs": [0.0] * 4}),
    "swap-incomplete": ("/v1/swap", {"policy": "default"}),
    "swap-unknown": ("/v1/swap", {"policy": "ghost", "checkpoint": "/nonexistent/ck"}),
    "swap-missing-dir": ("/v1/swap", {"policy": "default", "checkpoint": "/nonexistent/ck"}),
}


@pytest.mark.parametrize("case", sorted(POSTS))
def test_post_status_and_keys_equal_jax(both_gateways, case):
    jgw, gw = both_gateways
    path, body = POSTS[case]
    js, jbody, jtid = _post(jgw.url + path, body)
    s, b, tid = _post(gw.url + path, body)
    assert s == js, (b, jbody)
    assert sorted(b) == sorted(jbody)
    assert (tid is None) == (jtid is None)
    if s == 200 and path == "/v1/act":
        assert b["actions"] == jbody["actions"] and b["version"] == jbody["version"]


@pytest.mark.parametrize("path", ["/healthz", "/v1/policies", "/nope"])
def test_get_status_and_keys_equal_jax(both_gateways, path):
    jgw, gw = both_gateways
    js, jtext = _get(jgw.url + path)
    s, text = _get(gw.url + path)
    assert s == js
    assert sorted(json.loads(text)) == sorted(json.loads(jtext))
    if path == "/nope":
        assert json.loads(text)["routes"] == json.loads(jtext)["routes"]


def _overflowing(mod, store):
    batcher = mod.MicroBatcher(store, queue_limit=2, start=False)
    batcher.submit(np.zeros((1, 2), np.float32))
    batcher.submit(np.zeros((1, 2), np.float32))
    return batcher


def _stalled(mod, store):
    batcher = mod.MicroBatcher(store, queue_limit=4, start=True)
    batcher.close()
    return batcher


@pytest.mark.parametrize("make_batcher", [_overflowing, _stalled], ids=["overflow", "stalled"])
def test_503_equal_jax(make_batcher):
    gws = []
    try:
        for mod in (jserving, serving):
            store = mod.PolicyStore()
            store.register("default", StubEngine(), {"scale": np.ones(1, np.float32)})
            gws.append(mod.ServeGateway(store, port=0, batcher=make_batcher(mod, store),
                                        request_timeout_s=2.0, stall_after_s=0.2))
        (js, jbody, _), (s, body, _) = (_post(g.url + "/v1/act", {"obs": [[1.0, 2.0]]})
                                        for g in gws)
        assert s == js == 503 and sorted(body) == sorted(jbody)
        if make_batcher is _overflowing:
            assert "capacity" in body["error"]
        (jh, jraw), (h, raw) = (_get(g.url + "/healthz") for g in gws)
        assert h == jh and json.loads(raw)["status"] == json.loads(jraw)["status"]
    finally:
        for g in gws:
            g.close()


# ------------------------------------------------------------ HTTP serving


def test_served_actions_match_direct_act(port_gateway):
    gw, engine, np_params = port_gateway
    obs = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    net = engine_mod.make_actor(engine.spec, engine.cfg)
    net.load_state_dict(weights.from_flax(np_params))
    direct = ppo.make_greedy_act(engine.spec, engine.cfg)(net, torch.from_numpy(obs)).numpy()
    status, body, _ = _post(gw.url + "/v1/act", {"obs": obs.tolist()})
    assert status == 200 and body["policy"] == "default" and body["version"] == 0
    np.testing.assert_array_equal(np.asarray(body["actions"]), direct)
    status, body, _ = _post(gw.url + "/v1/act", {"obs": obs[0].tolist()})
    assert status == 200 and np.asarray(body["actions"]) == direct[0]


def test_concurrent_mixed_sizes_match_batch1_bitwise(port_gateway):
    gw, engine, _ = port_gateway
    rng = np.random.default_rng(3)
    sizes = (1, 3, 2, 1, 4, 6, 8, 2)
    payloads = [rng.normal(size=(n, 4)).astype(np.float32) for n in sizes]
    results: list = [None] * len(sizes)

    def worker(i):
        results[i] = _post(gw.url + "/v1/act", {"obs": payloads[i].tolist()})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    params = gw.store.get().params
    for i, n in enumerate(sizes):
        status, body, _ = results[i]
        assert status == 200, body
        for j in range(n):
            solo = engine.act(params, payloads[i][j:j + 1])
            assert np.asarray(body["actions"], dtype=solo.dtype)[j].tobytes() == solo[0].tobytes()


def test_trace_id_minted_echoed_and_capped(port_gateway):
    gw, *_ = port_gateway
    obs = {"obs": [[0.0, 0.0, 0.0, 0.0]]}
    status, body, tid = _post(gw.url + "/v1/act", obs)
    assert status == 200 and re.fullmatch(r"[0-9a-f]{16}", tid) and body["trace"] == tid
    status, body, tid = _post(gw.url + "/v1/act", obs, headers={"x-trace-id": "deadbeefcafef00d"})
    assert tid == body["trace"] == "deadbeefcafef00d"
    status, body, tid = _post(gw.url + "/v1/act", obs, headers={"x-trace-id": "x" * 500})
    assert status == 200 and len(body["trace"]) <= 64


def test_metrics_and_healthz_surface_serving_gauges(port_gateway):
    gw, *_ = port_gateway
    _post(gw.url + "/v1/act", {"obs": [[0.0, 0.0, 0.0, 0.0]]})
    status, text = _get(gw.url + "/metrics")
    assert status == 200
    for name in ("actor_critic_serving_requests_total", "actor_critic_serving_latency_p99_ms",
                 "actor_critic_serving_requests_default",
                 'actor_critic_serving_latency_ms_bucket{policy="default",le="+Inf"} 1'):
        assert name in text
    status, raw = _get(gw.url + "/healthz")
    health = json.loads(raw)
    assert status == 200 and health["dispatcher"]["alive"] is True
    assert health["policies"] == {"default": 0}
    assert json.loads(_get(gw.url + "/v1/policies")[1])["default"] == "default"


def test_slo_histograms_and_burn_on_metrics():
    store = serving.PolicyStore()
    store.register("default", StubEngine(pad_s=0.002), {"scale": np.ones(1, np.float32)},
                   slo_ms=0.001)
    gw = serving.ServeGateway(store, port=0, max_wait_us=0.0)
    try:
        for _ in range(4):
            assert _post(gw.url + "/v1/act", {"obs": [[1.0, 0.0]]})[0] == 200
        _, text = _get(gw.url + "/metrics")
    finally:
        gw.close()
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            head, val = line.rsplit(" ", 1)
            samples[head] = float(val)
    fam = "actor_critic_serving_latency_ms"
    assert samples[fam + '_bucket{policy="default",le="+Inf"}'] == 4
    assert samples[fam + '_count{policy="default"}'] == 4
    assert samples[fam + '_sum{policy="default"}'] > 0
    assert samples["actor_critic_serving_slo_burn_default"] > 1.0
    assert samples["actor_critic_serving_slo_violations_default"] == 4


def test_ephemeral_ports_and_multi_policy_routing():
    store = serving.PolicyStore()
    eng = StubEngine()
    store.register("champ", eng, {"scale": np.ones(1, np.float32)})
    store.register("canary", eng, {"scale": np.full(1, 3.0, np.float32)})
    a = serving.ServeGateway(store, port=0, max_wait_us=0.0)
    b = serving.ServeGateway(store, port=0)
    try:
        assert a.port != 0 and b.port != 0 and a.port != b.port and str(a.port) in a.url
        status, body, _ = _post(a.url + "/v1/act", {"obs": [[2.0, 0.0]], "policy": "canary"})
        assert status == 200 and body["actions"] == [6.0]
        status, body, _ = _post(a.url + "/v1/act", {"obs": [[2.0, 0.0]]})
        assert status == 200 and body["actions"] == [2.0] and body["policy"] == "champ"
        _, text = _get(a.url + "/metrics")
        assert "actor_critic_serving_requests_champ 1" in text
        assert "actor_critic_serving_requests_canary 1" in text
    finally:
        a.close()
        b.close()


def test_swap_endpoint_roundtrip(tmp_path):
    spec, cfg = make_cartpole().spec, ppo.PPOConfig(hidden=(8, 8))
    engine = serving.PolicyEngine(spec, cfg, buckets=(1, 4), device="cpu")
    p0 = serving.init_params(spec, cfg, "ppo", seed=0)
    p1 = serving.init_params(spec, cfg, "ppo", seed=1)
    serving.export_policy_params(str(tmp_path / "ck"), p1)
    store = serving.PolicyStore()
    store.register("default", engine, p0)
    gw = serving.ServeGateway(store, port=0)
    try:
        status, body, _ = _post(gw.url + "/v1/swap",
                                {"policy": "default", "checkpoint": str(tmp_path / "ck")})
        assert status == 200 and body == {"policy": "default", "version": 1}
        np.testing.assert_array_equal(
            store.get("default").params["params"]["torso"]["dense_0"]["kernel"],
            p1["params"]["torso"]["dense_0"]["kernel"])
        # A checkpoint poisoned on disk: the gate answers 422 and v1 stays.
        state_file = tmp_path / "ck" / "0" / "state.pt"
        saved = torch.load(state_file, weights_only=True)
        saved["tensors"]["params.params.policy.bias"][0] = float("nan")
        torch.save(saved, state_file)
        status, body, _ = _post(gw.url + "/v1/swap",
                                {"policy": "default", "checkpoint": str(tmp_path / "ck")})
        assert status == 422 and "non-finite" in body["error"]
        assert store.get("default").version == 1
    finally:
        gw.close()


def test_mirror_backend_and_sequential_baseline_serve():
    spec, cfg = make_pendulum().spec, ppo.PPOConfig(hidden=(8, 8))
    engine = serving.PolicyEngine(spec, cfg, buckets=(1, 4), backend="mirror")
    params = serving.init_params(spec, cfg, "ppo", seed=0)
    store = serving.PolicyStore()
    store.register("default", engine, params)
    for threaded in (True, False):
        gw = serving.ServeGateway(store, port=0, max_wait_us=200.0, threaded=threaded)
        try:
            status, body, _ = _post(gw.url + "/v1/act", {"obs": [[0.1, 0.2, 0.3]]})
            assert status == 200
            assert np.asarray(body["actions"]).shape == (1, spec.action_dim)
            assert gw.batcher.max_inflight == 1
        finally:
            gw.close()
