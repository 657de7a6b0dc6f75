"""The port's serving engine, policy store and micro-batcher
(`actor_critic_tpu_torch/serving/`) on the CPU, against the JAX package's
(`actor_critic_tpu/serving/`, tests/test_serving.py):

- parity: for params JAX initialized (handed over as numpy, flax's layout),
  the port's `PolicyEngine` serves JAX's `PolicyEngine`'s actions —
  discrete ones exactly, continuous ones within 1e-6 — for PPO (categorical
  and Gaussian), DDPG, TD3 and SAC, at every bucket;
- concurrent mixed-size requests through the micro-batcher answer what
  each row gets from a batch-1 act, with one flight worker and with two
  (two lanes): discrete actions bit for bit, continuous ones within 1e-6
  (torch's BLAS rounds by the bucket's row count), and within one bucket a
  row's action never depends on the other rows, bit for bit;
- JAX's behaviour tests: store routes and immutable handles, batcher
  grouping and ownership, rejects, poisoned pad rows never leaking, mirror
  = device backend, hot swap under in-flight load (a stub, and the real
  engine: every (version, action) pair is that version's), the SLO class
  riding a swap, shed distinct from reject, the swap's finiteness gate;
- params-only checkpoints round trip through the port's Checkpointer;
  `backend="auto"` measures both walls; the sampled stream follows the
  policy's distribution (torch's draws cannot be JAX's threefry ones).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from actor_critic_tpu import serving as jserving
from actor_critic_tpu.algos import ddpg as jddpg
from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu.algos import sac as jsac
from actor_critic_tpu.envs import make_cartpole as jcartpole
from actor_critic_tpu.envs import make_pendulum as jpendulum
from actor_critic_tpu_torch import serving
from actor_critic_tpu_torch.algos import ddpg, ppo, sac
from actor_critic_tpu_torch.envs import make_cartpole, make_pendulum, make_pong
from actor_critic_tpu_torch.models import host_actor
from actor_critic_tpu_torch.serving import engine as engine_mod
from actor_critic_tpu_torch.utils.numguard import NonFiniteError

BUCKETS = (1, 2, 4, 8)
CONT_ATOL = 1e-6  # continuous actions against JAX: float32 sums in another order

# name -> (algo, JAX (spec, cfg), port (spec, cfg))
ARCHS = {
    "ppo-categorical": ("ppo", lambda: (jcartpole().spec, jppo.PPOConfig(hidden=(16, 16))),
                        lambda: (make_cartpole().spec, ppo.PPOConfig(hidden=(16, 16)))),
    "ppo-gaussian": ("ppo", lambda: (jpendulum().spec, jppo.PPOConfig(hidden=(16, 16))),
                     lambda: (make_pendulum().spec, ppo.PPOConfig(hidden=(16, 16)))),
    "ddpg": ("ddpg", lambda: (jpendulum().spec, jddpg.DDPGConfig(hidden=(16, 16))),
             lambda: (make_pendulum().spec, ddpg.DDPGConfig(hidden=(16, 16)))),
    "td3": ("td3", lambda: (jpendulum().spec, jddpg.td3_config(hidden=(16, 16))),
            lambda: (make_pendulum().spec, ddpg.td3_config(hidden=(16, 16)))),
    "sac": ("sac", lambda: (jpendulum().spec, jsac.SACConfig(hidden=(16, 16))),
            lambda: (make_pendulum().spec, sac.SACConfig(hidden=(16, 16)))),
}


def _port(name, **kw):
    algo, _, port = ARCHS[name]
    spec, cfg = port()
    kw.setdefault("buckets", BUCKETS)
    return serving.PolicyEngine(spec, cfg, algo=algo, device="cpu", **kw), spec, cfg


def _jax_params(name, seed=0):
    algo, jax_side, _ = ARCHS[name]
    jspec, jcfg = jax_side()
    params = jserving.init_params(jspec, jcfg, algo, seed=seed)
    return params, jax.tree.map(np.asarray, jax.device_get(params))


def _obs(spec, n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, *spec.obs_shape)).astype(np.float32)


class StubEngine:
    """torch-free engine: action = obs[:, 0] * params['scale'][0]."""

    max_rows = 8

    def __init__(self, pad_s: float = 0.0):
        self.pad_s = pad_s
        self.flush_rows: list[int] = []

    def prepare_params(self, params):
        return {k: np.array(v) for k, v in params.items()}

    def act(self, params, obs):
        if self.pad_s:
            time.sleep(self.pad_s)
        obs = np.asarray(obs)
        self.flush_rows.append(obs.shape[0])
        return obs[:, 0] * params["scale"][0]


# ------------------------------------------------------------ JAX parity


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_engine_acts_equal_jax(name):
    algo, jax_side, _ = ARCHS[name]
    jspec, jcfg = jax_side()
    jparams, np_params = _jax_params(name)
    jengine = jserving.PolicyEngine(jspec, jcfg, algo=algo, buckets=BUCKETS)
    engine, spec, _ = _port(name)
    prepared = engine.prepare_params(np_params)
    assert engine.warm(prepared) == len(BUCKETS)
    for n in (1, 3, 4, 7, 8):
        obs = _obs(spec, n, seed=n)
        ours = engine.act(prepared, obs)
        theirs = jengine.act(jengine.prepare_params(jparams), obs)
        assert ours.shape == theirs.shape
        if spec.discrete:
            np.testing.assert_array_equal(ours, theirs)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=CONT_ATOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_init_params_is_the_trainers_init(name):
    """`init_params(seed)` draws what the trainers' init draws from seed."""
    algo = ARCHS[name][0]
    engine, spec, cfg = _port(name)
    ours = serving.init_params(spec, cfg, algo, seed=3)
    if algo == "ppo":
        module = ppo.init_host_params(spec, cfg, 3, device="cpu")[0]
    else:
        mod = sac if algo == "sac" else ddpg
        module = mod.init_learner(spec.obs_shape, spec.action_dim, cfg,
                                  torch.Generator().manual_seed(3), device="cpu").actor
    want = host_actor.mirror_params(module)
    flat = lambda t: {k: v for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(ours).keys() == flat(want).keys()
    for k, v in flat(ours).items():
        np.testing.assert_array_equal(v, flat(want)[k])


# ------------------------------------------------- batching and concurrency


@pytest.mark.parametrize("inflight", [1, 2])
@pytest.mark.parametrize("name", ["ppo-gaussian", "sac", "ppo-categorical"])
def test_concurrent_mixed_sizes_match_batch1_bitwise(name, inflight):
    engine, spec, _ = _port(name, lanes=inflight)
    store = serving.PolicyStore()
    store.register("default", engine, _jax_params(name)[1])
    batcher = serving.MicroBatcher(store, max_wait_us=2000.0, max_inflight=inflight)
    sizes = (1, 3, 2, 1, 4, 5, 8, 2)
    payloads = [_obs(spec, n, seed=10 + i) for i, n in enumerate(sizes)]
    results: list = [None] * len(sizes)

    def worker(i):
        req = batcher.submit(payloads[i])
        results[i] = batcher.wait(req, timeout=30)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(sizes))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    params = store.get().params
    for i, n in enumerate(sizes):
        actions, version = results[i]
        assert version == 0 and actions.shape[0] == n
        for j in range(n):
            solo = engine.act(params, payloads[i][j:j + 1])
            if spec.discrete:
                assert actions[j].tobytes() == solo[0].tobytes()
            else:
                # Torch's BLAS picks its kernel by the row count (one row
                # takes a matrix-vector path), so a row's last bits depend on
                # the bucket it ran in; XLA's dot did not in JAX's test.
                # Within a bucket rows are independent bit for bit (below).
                np.testing.assert_allclose(actions[j], solo[0], rtol=0, atol=CONT_ATOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_rows_do_not_depend_on_their_neighbours(name):
    """No cross-row contamination: at one bucket, a row's action is the same
    bytes whatever the other rows hold (pad rows included)."""
    engine, spec, _ = _port(name)
    params = engine.prepare_params(_jax_params(name)[1])
    obs = _obs(spec, 8, seed=1)
    base = engine.act(params, obs)
    for seed in range(3):
        other = _obs(spec, 8, seed=100 + seed)
        other[seed] = obs[seed]
        assert engine.act(params, other)[seed].tobytes() == base[seed].tobytes()
    assert engine.act(params, obs[:5])[:5].tobytes() == base[:5].tobytes()


def test_standby_backfill_rows_poisoned_do_not_leak(monkeypatch):
    """Pad rows are dead weight: poisoning them (NaN / ±3e38) moves not a
    byte of the first-n actions."""
    engine, spec, _ = _port("ppo-gaussian")
    params = engine.prepare_params(_jax_params("ppo-gaussian")[1])
    rng = np.random.default_rng(7)
    orig = engine_mod.pad_to_bucket
    for n, fill in ((3, np.nan), (5, 3.0e38), (6, -3.0e38)):
        obs = rng.normal(size=(n, *spec.obs_shape)).astype(np.float32)
        clean = engine.act(params, obs)

        def poisoned(x, buckets, axis=0, _fill=fill):
            out, mask = orig(x, buckets, axis)
            out = np.array(out)
            out[x.shape[0]:] = _fill
            return out, mask

        monkeypatch.setattr(engine_mod, "pad_to_bucket", poisoned)
        dirty = engine.act(params, obs)
        monkeypatch.setattr(engine_mod, "pad_to_bucket", orig)
        assert dirty.shape[0] == n
        assert clean.tobytes() == dirty.tobytes()


def test_batcher_groups_mixed_sizes_and_preserves_order():
    store = serving.PolicyStore()
    eng = StubEngine()
    store.register("default", eng, {"scale": np.ones(1, np.float32)})
    batcher = serving.MicroBatcher(store, start=False, max_wait_us=0.0)
    reqs = [batcher.submit(np.full((n, 3), float(i + 1), np.float32))
            for i, n in enumerate((1, 3, 2, 8, 1))]
    while batcher.queue_depth():
        batcher._flush_once(block=False)
    for i, (req, n) in enumerate(zip(reqs, (1, 3, 2, 8, 1))):
        actions, version = req.result
        assert version == 0
        np.testing.assert_array_equal(actions, np.full(n, float(i + 1), np.float32))
    # The trailing 1 backfills the first flush's slack; the 8 goes alone.
    assert eng.flush_rows == [7, 8]


def test_batcher_owns_the_payload():
    store = serving.PolicyStore()
    store.register("default", StubEngine(), {"scale": np.ones(1, np.float32)})
    batcher = serving.MicroBatcher(store, start=False)
    buf = np.full((2, 3), 7.0, np.float32)
    req = batcher.submit(buf)
    buf.fill(-1.0)
    batcher._flush_once(block=False)
    np.testing.assert_array_equal(req.result[0], [7.0, 7.0])


def test_batcher_rejects_oversized_and_overflow():
    store = serving.PolicyStore()
    store.register("default", StubEngine(), {"scale": np.ones(1, np.float32)})
    batcher = serving.MicroBatcher(store, start=False, queue_limit=2)
    with pytest.raises(ValueError):
        batcher.submit(np.zeros((9, 3), np.float32))
    batcher.submit(np.zeros((1, 3), np.float32))
    batcher.submit(np.zeros((1, 3), np.float32))
    with pytest.raises(serving.QueueFull):
        batcher.submit(np.zeros((1, 3), np.float32))
    assert batcher.metrics.snapshot()["rejected_total"] == 1


def test_percentile_linear_interpolation():
    from actor_critic_tpu.serving.batcher import _percentile as jpct
    from actor_critic_tpu_torch.serving.batcher import _percentile

    for vals in ([], [4.0], [1.0, 2.0], list(range(10)), list(np.linspace(0, 7, 33))):
        for p in (0, 50, 90, 99, 100):
            assert _percentile(vals, p) == jpct(vals, p)
    assert _percentile(list(range(10)), 99) == pytest.approx(8.91)


def test_shed_counter_distinct_from_reject():
    store = serving.PolicyStore()
    store.register("default", StubEngine(), {"scale": np.ones(1, np.float32)}, slo_ms=0.001)
    batcher = serving.MicroBatcher(store, start=False, queue_limit=4,
                                   shed_burn_threshold=1.0, shed_queue_frac=0.5)
    # Burn the budget: a flush whose latency violates the SLO class.
    batcher.metrics.record_flush("default", 1, 1, [5.0], 1.0, slo_ms=0.001)
    assert batcher.metrics.burn_rate("default") >= 1.0
    batcher.submit(np.zeros((1, 2), np.float32))
    batcher.submit(np.zeros((1, 2), np.float32))
    with pytest.raises(serving.Overloaded):
        batcher.submit(np.zeros((1, 2), np.float32))
    snap = batcher.metrics.snapshot()
    assert snap["shed_total"] == 1 and snap["rejected_total"] == 0
    assert snap["slo_burn_default"] >= 1.0 and snap["slo_violations_default"] == 1


# ----------------------------------------------------------- store and swap


def test_policy_store_register_swap_and_routes():
    store = serving.PolicyStore()
    eng = StubEngine()
    store.register("a", eng, {"scale": np.ones(1, np.float32)})
    store.register("b", eng, {"scale": np.full(1, 2.0, np.float32)})
    assert store.default_id == "a"
    assert store.ids() == {"a": 0, "b": 0} and len(store) == 2
    assert store.get().policy_id == "a" and store.get("b").version == 0
    with pytest.raises(serving.UnknownPolicy):
        store.get("nope")
    with pytest.raises(ValueError):
        store.register("a", eng, {"scale": np.ones(1)})
    old = store.get("a")
    new = store.swap("a", {"scale": np.full(1, 5.0, np.float32)})
    assert new.version == 1 and store.get("a").version == 1
    assert float(old.params["scale"][0]) == 1.0 and float(new.params["scale"][0]) == 5.0


def test_slo_class_rides_swap():
    store = serving.PolicyStore()
    store.register("p", StubEngine(), {"scale": np.ones(1, np.float32)}, slo_ms=25.0,
                   max_wait_us=300.0)
    h = store.swap("p", {"scale": np.full(1, 2.0, np.float32)})
    assert (h.slo_ms, h.max_wait_us, h.version) == (25.0, 300.0, 1)


def test_swap_refuses_nonfinite_and_keeps_serving():
    engine, spec, _ = _port("ppo-gaussian")
    _, params = _jax_params("ppo-gaussian")
    store = serving.PolicyStore()
    store.register("default", engine, params)
    bad = jax.tree.map(np.array, params)
    bad["params"]["policy"]["bias"][0] = np.nan
    with pytest.raises(NonFiniteError, match=r"params\['params'\]\['policy'\]\['bias'\]\[0\]"):
        store.swap("default", bad)
    assert store.get().version == 0
    obs = _obs(spec, 2)
    assert np.isfinite(engine.act(store.get().params, obs)).all()
    with pytest.raises(serving.UnknownPolicy):
        store.swap("ghost", bad)


def test_hot_swap_under_in_flight_load_stub():
    """Swaps land mid-traffic: every response is exact for the version it
    claims, versions only move forward."""
    store = serving.PolicyStore()
    store.register("default", StubEngine(pad_s=0.002), {"scale": np.ones(1, np.float32)})
    batcher = serving.MicroBatcher(store, max_wait_us=500.0)
    stop = threading.Event()
    failures: list = []

    def client(c):
        last = -1
        i = 0
        while not stop.is_set():
            fill = float(100 * c + i + 1)
            actions, v = batcher.wait(batcher.submit(np.array([[fill, 0.0], [fill, 0.0]])), 10)
            if list(actions) != [fill * (v + 1.0)] * 2 or v < last:
                failures.append((c, i, actions, v))
                return
            last = v
            i += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    try:
        for t in threads:
            t.start()
        for v in range(1, 5):
            time.sleep(0.03)
            store.swap("default", {"scale": np.full(1, v + 1.0, np.float32)}, version=v)
        time.sleep(0.03)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        batcher.close()
    assert not failures, failures[:3]
    assert store.get("default").version == 4


@pytest.mark.parametrize("inflight", [1, 2])
def test_hot_swap_real_engine_never_serves_a_torn_version(inflight):
    """The real engine under swaps: each version's params are a fresh init,
    and every (version, actions) response equals that version's own act."""
    engine, spec, cfg = _port("ppo-gaussian", lanes=inflight)
    versions = {v: serving.init_params(spec, cfg, "ppo", seed=v) for v in range(6)}
    store = serving.PolicyStore()
    store.register("default", engine, versions[0])
    obs = _obs(spec, 4, seed=5)
    expect = {v: engine.act(engine.prepare_params(p), obs) for v, p in versions.items()}
    assert len({e.tobytes() for e in expect.values()}) == len(versions)
    batcher = serving.MicroBatcher(store, max_wait_us=200.0, max_inflight=inflight)
    stop = threading.Event()
    seen: list = []
    failures: list = []

    def client():
        last = -1
        while not stop.is_set():
            actions, v = batcher.wait(batcher.submit(obs), 10)
            seen.append(v)
            if actions.tobytes() != expect[v].tobytes() or v < last:
                failures.append(v)
                return
            last = v

    threads = [threading.Thread(target=client) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        for v in range(1, 6):
            time.sleep(0.02)
            store.swap("default", versions[v], version=v)
        time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        batcher.close()
    assert not failures and len(set(seen)) >= 2 and max(seen) == 5


def test_gate_holds_flushes_while_clear():
    """Serve-while-training: a flush waits while the learner's gate is
    clear (its update eager or being captured) and runs once it is set."""
    gate = threading.Event()
    gate.set()
    engine, spec, _ = _port("ppo-gaussian", gate=gate)
    params = engine.prepare_params(_jax_params("ppo-gaussian")[1])
    obs = _obs(spec, 3)
    want = engine.act(params, obs)
    gate.clear()
    got: list = []
    t = threading.Thread(target=lambda: got.append(engine.act(params, obs)))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not got
    gate.set()
    t.join(10)
    assert not t.is_alive() and got[0].tobytes() == want.tobytes()


# ----------------------------------------------------------- checkpoints


def test_export_restore_roundtrip(tmp_path):
    engine, spec, cfg = _port("sac")
    p0 = serving.init_params(spec, cfg, "sac", seed=0)
    p1 = serving.init_params(spec, cfg, "sac", seed=1)
    serving.export_policy_params(str(tmp_path / "ck"), p1, step=3)
    got = serving.restore_policy_params(str(tmp_path / "ck"), engine.prepare_params(p0))
    for k in ("mean", "log_std"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got["params"][k][leaf], p1["params"][k][leaf])
    assert got["params"]["torso"]["dense_1"]["kernel"].dtype == np.float32
    with pytest.raises(FileNotFoundError):
        serving.restore_policy_params(str(tmp_path / "missing"), p0)
    bad = jax.tree.map(np.array, p1)
    bad["params"]["mean"]["bias"][0] = np.inf
    with pytest.raises(NonFiniteError):
        serving.export_policy_params(str(tmp_path / "bad"), bad)


def test_swap_from_checkpoint_bumps_version(tmp_path):
    engine, spec, cfg = _port("ppo-categorical")
    p0 = serving.init_params(spec, cfg, "ppo", seed=0)
    p1 = serving.init_params(spec, cfg, "ppo", seed=1)
    serving.export_policy_params(str(tmp_path / "ck"), p1)
    store = serving.PolicyStore()
    store.register("default", engine, p0)
    h = store.swap_from_checkpoint("default", str(tmp_path / "ck"))
    assert h.version == 1
    np.testing.assert_array_equal(h.params["params"]["torso"]["dense_0"]["kernel"],
                                  p1["params"]["torso"]["dense_0"]["kernel"])
    obs = _obs(spec, 5)
    np.testing.assert_array_equal(engine.act(h.params, obs),
                                  engine.act(engine.prepare_params(p1), obs))


# ---------------------------------------------------------- backends


@pytest.mark.parametrize("name", ["ppo-gaussian", "sac", "td3"])
def test_mirror_backend_matches_device_backend(name):
    algo = ARCHS[name][0]
    device, spec, cfg = _port(name)
    mirror = serving.PolicyEngine(spec, cfg, algo=algo, buckets=BUCKETS, backend="mirror")
    _, params = _jax_params(name)
    assert mirror.warm(mirror.prepare_params(params)) == 0
    obs = _obs(spec, 5)
    np.testing.assert_allclose(mirror.act(mirror.prepare_params(params), obs),
                               device.act(device.prepare_params(params), obs),
                               rtol=1e-5, atol=1e-6)
    frozen = mirror.prepare_params(params)
    leaf = frozen["params"]["torso" if algo != "ppo" else "pi_torso"]["dense_0"]["kernel"]
    with pytest.raises(ValueError):
        leaf[0, 0] = 1.0
    with pytest.raises(ValueError):
        serving.PolicyEngine(spec, cfg, algo=algo, backend="mirror", sample=True)


def test_engine_rejects_bad_config():
    spec, cfg = make_cartpole().spec, ppo.PPOConfig(hidden=(8,))
    with pytest.raises(ValueError):
        serving.PolicyEngine(spec, cfg, buckets=(), device="cpu")
    with pytest.raises(ValueError):
        serving.PolicyEngine(spec, cfg, buckets=(0, 4), device="cpu")
    with pytest.raises(ValueError):
        serving.PolicyEngine(spec, cfg, backend="xla", device="cpu")
    with pytest.raises(ValueError):
        serving.PolicyEngine(spec, cfg, lanes=0, device="cpu")
    with pytest.raises(ValueError):
        serving.make_act_program(spec, cfg, algo="ddpg", sample=True)
    with pytest.raises(ValueError):
        serving.make_act_program(spec, cfg, algo="impala")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.PolicyEngine(spec, cfg)  # the card by default, and there is none
    engine = serving.PolicyEngine(spec, cfg, device="cpu")
    with pytest.raises(TypeError, match="prepare_params"):
        engine.act(serving.init_params(spec, cfg), _obs(spec, 1))
    other = serving.init_params(spec, ppo.PPOConfig(hidden=(8, 8)))
    with pytest.raises(ValueError, match="do not fit"):
        engine.prepare_params(other)


def test_auto_backend_measures_both_walls():
    engine, spec, cfg = _port("ppo-gaussian", backend="auto")
    params = serving.init_params(spec, cfg)
    with pytest.raises(RuntimeError, match="unresolved"):
        engine.prepare_params(params)
    choice = engine.resolve_backend(params)
    assert choice in ("device", "mirror") and engine.auto_choice["backend"] == choice
    assert engine.auto_choice["device_ms"] > 0 and engine.auto_choice["mirror_ms"] > 0
    assert engine.resolve_backend(params) == choice
    obs = _obs(spec, 3)
    ref = serving.PolicyEngine(spec, cfg, buckets=BUCKETS, device="cpu")
    np.testing.assert_allclose(engine.act(engine.prepare_params(params), obs),
                               ref.act(ref.prepare_params(params), obs), rtol=1e-5, atol=1e-6)
    sampled = serving.PolicyEngine(spec, cfg, backend="auto", sample=True, device="cpu")
    assert sampled.backend == "device"
    pong = make_pong().spec
    pixel = serving.PolicyEngine(pong, ppo.PPOConfig(), backend="auto", device="cpu",
                                 buckets=(1,))
    assert pixel.resolve_backend(serving.init_params(pong, ppo.PPOConfig())) == "device"
    assert pixel.auto_choice == {"backend": "device", "reason": "no mirror"}


def test_sampled_serving_follows_the_policy_distribution():
    """Sample mode draws from the policy (torch's stream, not JAX's): the
    action frequencies at one obs match its softmax within 3%."""
    engine, spec, cfg = _port("ppo-categorical", sample=True, buckets=(64,))
    params = serving.init_params(spec, cfg, seed=2)
    params["params"]["policy"]["kernel"] *= 200.0  # logits of order 1: a skewed softmax
    prepared = engine.prepare_params(params)
    obs = np.repeat(_obs(spec, 1, seed=4), 64, axis=0)
    draws = np.concatenate([engine.act(prepared, obs) for _ in range(100)])
    net = engine_mod.make_actor(spec, cfg)
    from actor_critic_tpu_torch import weights

    net.load_state_dict(weights.from_flax(params))
    probs = torch.softmax(net(torch.from_numpy(obs[:1]))[0].logits, -1)[0].detach().numpy()
    freq = np.bincount(draws, minlength=spec.action_dim) / draws.size
    np.testing.assert_allclose(freq, probs, atol=0.03)
    assert len({engine.act(prepared, obs[:8]).tobytes() for _ in range(4)}) > 1


@pytest.mark.parametrize("which", ["mlp", "pixel"])
def test_to_flax_inverts_from_flax_on_jax_trees(which):
    """`weights.to_flax` (init_params' layout) gives back JAX's own tree bit
    for bit, conv kernels included."""
    from actor_critic_tpu.envs import make_pong as jpong

    from actor_critic_tpu_torch import weights

    if which == "mlp":
        jspec, spec = jcartpole().spec, make_cartpole().spec
    else:
        jspec, spec = jpong().spec, make_pong().spec
    jparams = jserving.init_params(jspec, jppo.PPOConfig(hidden=(16,)), "ppo", seed=1)
    tree = jax.tree.map(np.asarray, jax.device_get(jparams))
    net = engine_mod.make_actor(spec, ppo.PPOConfig(hidden=(16,)))
    net.load_state_dict(weights.from_flax(tree))
    back = weights.to_flax(net)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    assert flat(back).keys() == flat(tree).keys()
    for k, v in flat(tree).items():
        assert flat(back)[k].dtype == np.float32 and flat(back)[k].flags.c_contiguous
        np.testing.assert_array_equal(flat(back)[k], v)
