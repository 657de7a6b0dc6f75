"""The port's serve CLI (`python -m actor_critic_tpu_torch.serve`, JAX's
`scripts/serve.py`) and serve-while-training (`train.py --serve-port` with
the async learners) on the CPU:

- the CLI's flags build JAX's stores (random init, checkpoints, the default
  route, per-policy SLO classes and windows) and refuse what JAX refuses;
  the flags of later paths exit "not ported yet" with their ROADMAP item;
  `--backend xla` (JAX's name) is `device`; `--set bf16_compute=true`
  serves the bf16 network; `--backend auto` reports its choice; without `--device cpu` it needs the
  card; a subprocess binds port 0, prints it, serves and shuts down on
  SIGINT;
- `train.main` with `ppo_halfcheetah --env native:Pendulum-v1
  --async-actors 2 --serve-port 0` (V-trace) and `sac_humanoid` with one
  actor serve while they train: a polling client sees strictly monotone
  versions, the store ends at consumed blocks + 1, and the served action
  then equals the learner's own greedy act on its final parameters, bit
  for bit; `--serve-port` without `--async-actors` exits as JAX's does.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from actor_critic_tpu_torch import serve, serving, train
from actor_critic_tpu_torch.algos import ppo, sac
from actor_critic_tpu_torch.envs import make_cartpole

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 20.0


@pytest.fixture
def cpu_learner():
    """One intra-op thread and a 0.1 ms GIL switch interval for the async
    learners on the CPU (tests/test_torch_async_host.py says why)."""
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-4)
    yield
    sys.setswitchinterval(interval)
    torch.set_num_threads(threads)


def _args(*extra):
    return serve.parse_args(["--preset", "ppo_cartpole", "--buckets", "1,4", "--device", "cpu",
                             *extra])


# --------------------------------------------------------------- the CLI


@pytest.mark.parametrize("flag", sorted(serve.UNPORTED_FLAGS))
def test_later_paths_are_refused(flag, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(["--preset", "ppo_cartpole", flag, "1"])
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and serve.UNPORTED_FLAGS[flag] in err


def test_backend_xla_is_device():
    """`--backend xla`, the JAX CLI's name (and default), parses to the
    engine's `device` backend, as `device` does; the engine itself keeps
    refusing the name "xla" (tests/test_torch_serving.py)."""
    assert _args("--backend", "xla").backend == _args("--backend", "device").backend == "device"
    assert _args().backend == "device"
    engine, _, _ = serve.build(_args("--backend", "xla", "--random-init"))
    assert engine.backend == "device"


def test_bf16_policy_serves_the_bf16_network(capsys):
    """`--set bf16_compute=true` builds its act buckets from the bf16
    network (the trainer's), whose acts are its eager greedy act's."""
    engine, store, _ = serve.build(_args("--random-init", "--set", "bf16_compute=true"))
    assert engine.cfg.bf16_compute and engine._network().compute_dtype == torch.bfloat16
    obs = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    handle = store.get()
    np.testing.assert_array_equal(engine.act(handle.params, obs),
                                  engine.eager_act(handle.params, obs))


def test_random_init_builds_a_warm_default(capsys):
    engine, store, wait = serve.build(_args("--random-init", "--slo-ms", "50"))
    assert wait == 2000.0 and store.ids() == {"default": 0} and store.default_id == "default"
    assert engine.buckets == (1, 4) and engine.device.type == "cpu"
    assert store.get().slo_ms == 50.0
    assert "warm: 2 act buckets captured" in capsys.readouterr().out
    want = serving.init_params(make_cartpole().spec, ppo.PPOConfig(), "ppo", seed=0)
    np.testing.assert_array_equal(store.get().params["params"]["policy"]["kernel"],
                                  want["params"]["policy"]["kernel"])


def test_checkpoints_default_route_and_classes(tmp_path):
    spec, cfg = make_cartpole().spec, ppo.PPOConfig()
    for seed, name in ((1, "champ"), (2, "canary")):
        serving.export_policy_params(str(tmp_path / name),
                                     serving.init_params(spec, cfg, "ppo", seed=seed))
    engine, store, wait = serve.build(_args(
        "--policy", f"champ={tmp_path / 'champ'}", "--policy", f"canary={tmp_path / 'canary'}",
        "--random-init", "--default", "canary", "--slo-ms", "canary=5", "--slo-ms", "20",
        "--max-wait-us", "champ=100", "--max-wait-us", "700"))
    assert store.default_id == "canary" and set(store.ids()) == {"champ", "canary", "default"}
    assert wait == 700.0
    assert (store.get("canary").slo_ms, store.get("champ").slo_ms) == (5.0, 20.0)
    assert (store.get("champ").max_wait_us, store.get("canary").max_wait_us) == (100.0, None)
    obs = np.random.default_rng(0).normal(size=(4, 4)).astype(np.float32)
    want = serving.init_params(spec, cfg, "ppo", seed=2)
    np.testing.assert_array_equal(engine.act(store.get().params, obs),
                                  engine.act(engine.prepare_params(want), obs))
    # Without --default the first registration (a checkpoint) keeps the route.
    _, store, _ = serve.build(_args("--policy", f"champ={tmp_path / 'champ'}", "--random-init"))
    assert store.default_id == "champ"


@pytest.mark.parametrize("argv,match", [
    ([], "no policies"),
    (["--random-init", "--default", "ghost"], "names no policy"),
    (["--policy", "nodir"], "ID=CKPT_DIR"),
    (["--random-init", "--slo-ms", "ghost=5"], "--slo-ms names no resident policy"),
    (["--random-init", "--max-wait-us", "fast"], r"\[ID=\]US"),
    (["--random-init", "--max-inflight", "0"], "--max-inflight"),
], ids=["none", "default", "policy-format", "slo-id", "wait-format", "inflight"])
def test_bad_selections_exit(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.build(_args(*argv))


def test_algo_without_a_serving_program_exits():
    with pytest.raises(SystemExit, match="unsupported serving algo"):
        serve.build(serve.parse_args(["--preset", "a2c_cartpole", "--random-init",
                                      "--device", "cpu"]))


def test_auto_backend_reports_its_choice(capsys):
    engine, store, _ = serve.build(_args("--random-init", "--backend", "auto"))
    out = capsys.readouterr().out
    assert f"auto backend: {engine.backend}" in out and engine.backend in ("device", "mirror")
    assert store.get().engine is engine


def test_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(serve.parse_args(["--preset", "ppo_cartpole", "--random-init"]))


def test_spec_for_selectors():
    assert serve.spec_for("jax:cartpole", {}).obs_shape == (4,)
    spec = serve.spec_for("native:Pendulum-v1", {})
    assert spec.obs_shape == (3,) and spec.action_dim == 1 and not spec.discrete
    with pytest.raises(SystemExit):
        serve.spec_for("mixture:cartpole", {})


def test_subprocess_binds_port_zero_serves_and_stops():
    proc = subprocess.Popen(
        [sys.executable, "-m", "actor_critic_tpu_torch.serve", "--preset", "ppo_cartpole",
         "--random-init", "--port", "0", "--buckets", "1,4", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        url = None
        deadline = time.monotonic() + 60
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("serving gateway: "):
                url = line.split()[2].removesuffix("/v1/act")
        assert url is not None and not url.endswith(":0")
        req = urllib.request.Request(url + "/v1/act",
                                     data=json.dumps({"obs": [0.1, 0.2, 0.3, 0.4]}).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            body = json.loads(r.read())
        assert body["version"] == 0 and body["actions"] in (0, 1)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=TIMEOUT) == 0
        assert "shutting down" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)


# ---------------------------------------------------- serve-while-training


class _Poller:
    """A client thread polling /v1/act on the sidecar's gateway as soon as it
    is up, recording (version, actions)."""

    def __init__(self, obs):
        self.obs, self.seen, self.errors = obs, [], []
        self.stop = threading.Event()
        self.store = None

    def wrap(self, start):
        def start_serving_sidecar(*a, **k):
            gateway, learner_kwargs = start(*a, **k)
            self.store = gateway.store
            self.thread = threading.Thread(target=self.run, args=(gateway.url,), daemon=True)
            self.thread.start()
            return gateway, learner_kwargs
        return start_serving_sidecar

    def run(self, url):
        body = json.dumps({"obs": self.obs.tolist()}).encode()
        while not self.stop.is_set():
            try:
                with urllib.request.urlopen(urllib.request.Request(url + "/v1/act", data=body),
                                            timeout=5) as r:
                    b = json.loads(r.read())
                self.seen.append((b["version"], b["actions"]))
            except OSError as e:  # the gateway closes as training ends
                self.errors.append(e)
                return
            time.sleep(0.005)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_serve_while_training(algo, monkeypatch, tmp_path, cpu_learner):
    obs = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    poller = _Poller(obs)
    monkeypatch.setattr(train, "start_serving_sidecar", poller.wrap(train.start_serving_sidecar))
    mod = ppo if algo == "ppo" else sac
    learned = {}
    run = mod.train_host_async

    def capture(*a, **k):
        learned["gate"] = k.get("gate")
        out = run(*a, **k)
        learned["module"] = out[0] if algo == "ppo" else out[0].actor
        return out

    monkeypatch.setattr(mod, "train_host_async", capture)
    if algo == "ppo":
        argv = ["--preset", "ppo_halfcheetah", "--async-actors", "2", "--set", "epochs=1",
                "--set", "num_minibatches=4", "--async-correction", "vtrace"]
    else:
        argv = ["--preset", "sac_humanoid", "--async-actors", "1", "--set", "hidden=8,8",
                "--set", "updates_per_iter=2", "--set", "warmup_steps=64"]
    blocks = 4
    try:
        assert train.main(argv + ["--env", "native:Pendulum-v1", "--iterations", str(blocks),
                                  "--serve-port", "0", "--device", "cpu", "--quiet",
                                  "--metrics", str(tmp_path / "m.jsonl")]) == 0
    finally:
        poller.stop.set()
    poller.thread.join(TIMEOUT)
    versions = [v for v, _ in poller.seen]
    assert versions and versions == sorted(versions), versions
    assert poller.store.ids() == {"learner": blocks + 1}
    handle = poller.store.get("learner")
    # The gateway's flushes wait on the learner's own actors' gate.
    assert learned["gate"] is handle.engine.gate and learned["gate"].is_set()
    served = handle.engine.act(handle.params, obs)
    spec = handle.engine.spec
    if algo == "ppo":
        greedy = ppo.make_greedy_act(spec, handle.engine.cfg)
    else:
        greedy = sac.make_greedy_act(spec.action_dim, handle.engine.cfg)
    with torch.no_grad():
        own = greedy(learned["module"], torch.from_numpy(obs)).numpy()
    assert served.tobytes() == own.tobytes()


def test_serve_port_needs_async_actors():
    with pytest.raises(SystemExit, match="pass --async-actors N"):
        train.main(["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1",
                    "--serve-port", "0", "--device", "cpu", "--iterations", "1"])
