"""The warm-up's capture part on the CPU (`utils/compile_cache.py`; on the
card it also captures, which `chip_smoke.py` holds):

- the restore is exact: the eager part (`loop.warm_up` for the fused
  trainers, `HostUpdate.warm` for the host and async updates, run through
  the trainers themselves under a plan that names their entry) leaves
  every tensor, numpy array and generator reachable from the state and
  from the step's closure bitwise as it was, although its eager steps
  wrote them: A2C, PPO, IMPALA, DDPG/TD3, SAC and the mixture fleet; host
  PPO, a host off-policy update, the async PPO update on both data planes
  and the async off-policy update on the device plane;
- warmed equals unwarmed: through `train.main` with `--warmup` and
  `--no-warmup`, a small `a2c_cartpole` with `--chunk 3 --iterations 7`,
  a small host PPO and a small host SAC end in equal checkpoints (every
  carried tensor and the generator) and equal logged metrics, at 0.0.
"""

import dataclasses
import json
import sys
import types

import numpy as np
import pytest
import torch

from actor_critic_tpu_torch import train
from actor_critic_tpu_torch.algos import a2c, ddpg, host_loop, impala, loop, ppo, sac
from actor_critic_tpu_torch.envs import make_cartpole, make_mixture, make_pendulum
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool
from actor_critic_tpu_torch.utils import compile_cache


@pytest.fixture(autouse=True)
def _switch_interval():
    """Actor threads beside a CPU learner: a short GIL switch interval and
    one intra-op thread, as the async tests run them."""
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-4)
    yield
    sys.setswitchinterval(interval)
    torch.set_num_threads(threads)


def reachable(obj, prefix: str = "", seen=None, depth: int = 0) -> dict:
    """Every tensor, numpy array and generator reachable from `obj` by name:
    through modules (parameters and buffers), dataclasses, tuples, lists,
    dicts, function closures and the port's own objects' attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen or depth > 12:
        return {}
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if isinstance(obj, (np.ndarray, torch.Generator)):
        return {prefix: obj}
    out = {}
    if isinstance(obj, torch.nn.Module):
        for k, t in [*obj.named_parameters(), *obj.named_buffers()]:
            out[f"{prefix}.{k}"] = t
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (tuple, list)):
        items = list(enumerate(obj))
    elif isinstance(obj, dict):
        items = list(obj.items())
    elif isinstance(obj, types.FunctionType):
        cells = obj.__closure__ or ()
        items = [(name, c.cell_contents) for name, c in zip(obj.__code__.co_freevars, cells)
                 if _filled(c)]
    elif type(obj).__module__.startswith("actor_critic_tpu_torch") and hasattr(obj, "__dict__"):
        items = list(vars(obj).items())
    else:
        return {}
    for k, v in items:
        out.update(reachable(v, f"{prefix}/{k}", seen, depth + 1))
    return out


def _filled(cell) -> bool:
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


def snapshot(*roots) -> dict:
    out = {}
    for i, root in enumerate(roots):
        for k, v in reachable(root, str(i)).items():
            if isinstance(v, torch.Generator):
                out[k] = v.get_state().clone()
            elif isinstance(v, np.ndarray):
                out[k] = v.copy()
            else:
                out[k] = v.detach().clone()
    return out


def differing(before: dict, after: dict) -> list:
    assert before.keys() == after.keys()
    diff = []
    for k, a in before.items():
        b = after[k]
        same = (np.array_equal(a, b, equal_nan=a.dtype.kind == "f") if isinstance(a, np.ndarray)
                else a.shape == b.shape and torch.equal(a, b))
        if not same:
            diff.append(k)
    return diff


# ------------------------------------------------------------ fused trainers

FUSED = {
    "a2c": (a2c, make_cartpole, a2c.A2CConfig(num_envs=8, rollout_steps=8, hidden=(16,))),
    "ppo": (ppo, make_cartpole, ppo.PPOConfig(num_envs=8, rollout_steps=8, epochs=2,
                                              num_minibatches=2, hidden=(16,))),
    "impala": (impala, make_cartpole, impala.ImpalaConfig(num_envs=8, rollout_steps=8,
                                                          hidden=(16,), actor_refresh_every=2)),
    "td3": (ddpg, make_pendulum, ddpg.td3_config(num_envs=2, steps_per_iter=8,
                                                 updates_per_iter=2, buffer_capacity=64,
                                                 batch_size=8, warmup_steps=8, hidden=(16,))),
    "sac": (sac, make_pendulum, sac.SACConfig(num_envs=2, steps_per_iter=8, updates_per_iter=2,
                                              buffer_capacity=64, batch_size=8, warmup_steps=8,
                                              hidden=(16,))),
    "a2c_mixture": (a2c, lambda: make_mixture("cartpole,pendulum,acrobot,maze", randomize=0.2,
                                              redraw_types=True),
                    a2c.A2CConfig(num_envs=8, rollout_steps=8, hidden=(16,))),
}


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_warm_up_restores_exactly(name):
    mod, make, cfg = FUSED[name]
    env = make()
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    step = mod.make_train_step(env, cfg)
    calls, written = [], []

    def counted(s):
        calls.append(1)
        pre = snapshot(s)
        out = step(s)
        written.append(differing(pre, snapshot(s)))
        return out

    before = snapshot(state, step)
    assert loop.warm_up(counted, state) == {}  # the CPU captures nothing
    assert differing(before, snapshot(state, step)) == []
    # Not vacuous: the eager steps ran and wrote the state.
    assert len(calls) == loop.WARMUP_ITERATIONS and all(written), written
    # And the state goes on as if no warm-up had run.
    twin = mod.init_state(env, cfg, seed=0, device="cpu")
    for s in (state, twin):
        step(s)
    assert differing(snapshot(twin), snapshot(state)) == []


def test_warm_up_restores_when_a_step_raises():
    mod, make, cfg = FUSED["a2c"]
    env = make()
    state = mod.init_state(env, cfg, seed=0, device="cpu")
    step = mod.make_train_step(env, cfg)
    calls = []

    def second_raises(s):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return step(s)

    before = snapshot(state)
    with pytest.raises(RuntimeError, match="boom"):
        loop.warm_up(second_raises, state)
    assert differing(before, snapshot(state)) == []


# ------------------------------------------------------ host and async updates

def _pool(num_envs: int, seed: int = 0, normalize: bool = True, env_id: str = "Pendulum-v1"):
    return HostEnvPool(env_id, num_envs=num_envs, seed=seed, normalize_obs=normalize,
                       normalize_reward=normalize, backend="native")


PPO_CFG = ppo.PPOConfig(num_envs=4, rollout_steps=16, epochs=1, num_minibatches=2,
                        hidden=(16,))
SAC_CFG = sac.SACConfig(num_envs=2, steps_per_iter=8, updates_per_iter=2, buffer_capacity=64,
                        batch_size=8, warmup_steps=0, hidden=(16,))
TD3_CFG = ddpg.td3_config(num_envs=2, steps_per_iter=8, updates_per_iter=2, buffer_capacity=64,
                          batch_size=8, warmup_steps=0, hidden=(16,), replay_dtype="mixed")


def _ppo_host(overlap):
    pool = _pool(4)
    try:
        ppo.train_host(pool, PPO_CFG, 1, device="cpu", log_every=0, overlap=overlap)
    finally:
        pool.close()


def _sac_host():
    pool = _pool(2, normalize=False)
    try:
        sac.train_host(pool, SAC_CFG, 1, device="cpu", log_every=0)
    finally:
        pool.close()


def _ppo_async(plane, correction="vtrace"):
    pools = [_pool(2, seed=i * 100003) for i in range(2)]
    try:
        ppo.train_host_async(pools, PPO_CFG, 1, device="cpu", log_every=0, data_plane=plane,
                             plane_codec="int8" if plane == "device" else "fp32",
                             correction=correction)
    finally:
        for p in pools:
            p.close()


def _td3_async_device():
    pools = [_pool(2, normalize=False)]
    try:
        ddpg.train_host_async(pools, TD3_CFG, 1, device="cpu", log_every=0,
                              data_plane="device", plane_codec="int8")
    finally:
        pools[0].close()


HOST = {
    "ppo.make_host_update_step[overlap]": lambda: _ppo_host(True),
    "ppo.make_host_update_step[device act]": lambda: _ppo_host(False),
    "sac.make_host_ingest_update": _sac_host,
    "ppo.make_async_update_step": lambda: _ppo_async("host"),
    "ppo.make_async_update_step[none]": lambda: _ppo_async("host", "none"),
    "ppo.make_device_update_step": lambda: _ppo_async("device"),
    "device_replay.make_device_ingest_update": _td3_async_device,
}


@pytest.mark.parametrize("case", sorted(HOST))
def test_host_update_warm_restores_exactly(case, monkeypatch):
    """The trainer, under a plan that names its update's entry, runs
    `HostUpdate.warm` before its first iteration (on a zero block staged
    into its static buffers, or the ring's slot); everything the update
    could reach is bitwise as it was after it, though its eager calls
    wrote the learner."""
    entry = case.partition("[")[0]
    seen = {}
    warm = host_loop.HostUpdate.warm

    def spy(self):
        calls, written = [], []
        body = self.body

        def counted():
            calls.append(1)
            pre = snapshot(body, self.generator)
            out = body()
            written.append(differing(pre, snapshot(body, self.generator)))
            return out

        before = snapshot(body, self.generator)
        self.body = counted
        try:
            warm(self)
        finally:
            self.body = body
        seen.update(diff=differing(before, snapshot(body, self.generator)), calls=len(calls),
                    written=written)

    monkeypatch.setattr(host_loop.HostUpdate, "warm", spy)
    runner = compile_cache.WarmupRunner([(entry, compile_cache.Warmup())]).start()
    with compile_cache.running(runner):
        HOST[case]()
    assert runner.done and "error" not in runner.results[0], runner.results
    assert seen["diff"] == []
    assert seen["calls"] == loop.WARMUP_ITERATIONS and all(seen["written"]), seen


# ----------------------------------------------------- warmed = unwarmed, CLI

def _main(argv, tmp_path, tag, capsys):
    ckpt, metrics = tmp_path / f"ck_{tag}", tmp_path / f"m_{tag}.jsonl"
    assert train.main(argv + ["--device", "cpu", "--ckpt-dir", str(ckpt), "--metrics",
                              str(metrics), "--quiet", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    n = rows[-1]["iter"]
    state = torch.load(ckpt / str(n) / "state.pt", weights_only=True)
    return rows, state, out


CLI = {
    "a2c_cartpole chunk 3": ["--preset", "a2c_cartpole", "--set", "num_envs=16",
                             "--set", "rollout_steps=8", "--chunk", "3", "--iterations", "7",
                             "--eval-every", "6"],
    "host ppo": ["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--set",
                 "num_envs=4", "--set", "rollout_steps=32", "--set", "epochs=1", "--set",
                 "num_minibatches=2", "--iterations", "2"],
    "host sac": ["--preset", "sac_humanoid", "--env", "native:Pendulum-v1", "--set",
                 "hidden=8,8", "--set", "updates_per_iter=2", "--set", "warmup_steps=16",
                 "--set", "buffer_capacity=256", "--set", "batch_size=8", "--iterations", "3"],
}


@pytest.mark.parametrize("case", sorted(CLI))
def test_warmed_equals_unwarmed_through_main(case, tmp_path, capsys):
    argv = CLI[case]
    warm_rows, warm_state, out = _main(argv + ["--warmup"], tmp_path, "warm", capsys)
    assert "warmup: " in out and "compile cache: " in out
    cold_rows, cold_state, out = _main(argv + ["--no-warmup"], tmp_path, "cold", capsys)
    assert "warmup: " not in out
    assert sorted(warm_state["tensors"]) == sorted(cold_state["tensors"])
    for k, t in warm_state["tensors"].items():
        assert torch.equal(t, cold_state["tensors"][k]), k
    assert torch.equal(warm_state["generator"], cold_state["generator"])
    drop = lambda r: {k: v for k, v in r.items() if not k.endswith("_s") and k != "wall_s"}  # noqa: E731
    assert [drop(r) for r in warm_rows] == [drop(r) for r in cold_rows]
