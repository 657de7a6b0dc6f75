"""Checkpoint/resume, the greedy eval and the CLI of the port's host path,
the cases of the JAX package's tests/test_host_resume.py:

- the device side restores exactly (the net and its Adam state, or the
  learner with its ring, the generator, `env_steps`) and so do the pool's
  normalizer stats; the env simulators do not (the pool restarts fresh
  episodes), so trajectories are not compared;
- a replay-free checkpoint (`save_replay=False`) holds a one-slot ring
  stub with the codecs' stats in full; its resume warns, starts from an
  empty full-capacity ring with the restored stats, and refills it;
- a resume into a pool with the other normalization, or the other action
  convention, warns;
- the eval row rides the log row;
- the CLI runs `host:` and `native:` envs (the MuJoCo presets as they
  are, where MuJoCo imports) with `--eval-envs`, `--eval-steps`,
  `--no-overlap` and `--no-save-replay`, and resumes through
  `--ckpt-dir`/`--resume`.
"""

import dataclasses
import json
import math
import warnings

import pytest
import torch

from actor_critic_tpu_torch import train
from actor_critic_tpu_torch.algos import ddpg, ppo, sac
from actor_critic_tpu_torch.algos.common import named_carried
from actor_critic_tpu_torch.algos.host_loop import host_ckpt_state
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool
from actor_critic_tpu_torch.replay import capacity_of
from actor_critic_tpu_torch.utils.cadence import should_log
from actor_critic_tpu_torch.utils.checkpoint import Checkpointer


def _ppo_cfg():
    return ppo.PPOConfig(num_envs=2, rollout_steps=8, epochs=1, num_minibatches=1, hidden=(16,))


def _ddpg_cfg(**kw):
    return ddpg.DDPGConfig(num_envs=2, steps_per_iter=4, updates_per_iter=1, buffer_capacity=512,
                           batch_size=8, warmup_steps=8, hidden=(16,), **kw)


def _pool(env_id="CartPole-v1", **kw):
    return HostEnvPool(env_id, num_envs=2, seed=0, backend="native", **kw)


def _raw_pendulum(**kw):
    return _pool("Pendulum-v1", normalize_obs=False, normalize_reward=False, **kw)


def _tensors(obj, prefix=""):
    return {k: t.detach().clone() for k, t in named_carried(obj, prefix).items()}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _run(train_host, pool, cfg, iterations, ckpt_dir, **kw):
    ckpt = Checkpointer(ckpt_dir)
    try:
        return train_host(pool, cfg, iterations, seed=0, log_every=kw.pop("log_every", 0),
                          ckpt=ckpt, device="cpu", **kw)
    finally:
        pool.close()


def test_should_log_first_iteration():
    assert should_log(1, 10, 100)
    assert should_log(1, 0, 100)
    assert not should_log(2, 10, 100)
    assert should_log(100, 10, 100)


def test_ppo_host_resume_restores_exact_state(tmp_path):
    ck = tmp_path / "ck"
    pool = _pool()
    net1, opt1, _ = _run(ppo.train_host, pool, _ppo_cfg(), 3, ck, save_every=2)
    saved_count = pool.obs_rms.count
    saved = torch.load(ck / "3" / "state.pt", weights_only=True)
    assert Checkpointer(ck).latest_step() == 3
    net2, opt2, history = _run(ppo.train_host, _pool(), _ppo_cfg(), 3, ck, resume=True)
    _assert_same(_tensors(net1), _tensors(net2))
    _assert_same(_tensors(opt1), _tensors(opt2))
    assert history == []
    # The normalizer stats came back through set_state (+1 reset batch).
    assert saved["tensors"]["pool.obs_rms.count"].item() == saved_count


def test_ppo_host_resume_continues_training(tmp_path):
    ck = tmp_path / "ck"
    _run(ppo.train_host, _pool(), _ppo_cfg(), 2, ck, save_every=1)
    _, _, history = _run(ppo.train_host, _pool(), _ppo_cfg(), 4, ck, save_every=1, resume=True,
                         log_every=1)
    assert Checkpointer(ck).latest_step() == 4
    assert [it for it, _ in history] == [3, 4]


def test_host_checkpoint_round_trip_is_exact(tmp_path):
    """A save holds the learner as it was, and a restore gives back at 0.0
    every learner tensor (through a resume), the generator's state,
    `env_steps` and the pool's stats (through a restore into a fresh
    template)."""
    ck = tmp_path / "ck"
    cfg = _ddpg_cfg()
    learner1, _ = _run(ddpg.train_host, _raw_pendulum(), cfg, 3, ck, save_every=3)
    saved = torch.load(ck / "3" / "state.pt", weights_only=True)
    _assert_same({k: v for k, v in saved["tensors"].items() if k.startswith("device_state.learner")},
                 _tensors(learner1, "device_state.learner"))
    assert int(saved["tensors"]["device_state.env_steps"]) == 3 * 4 * 2
    learner2, _ = _run(ddpg.train_host, _raw_pendulum(), cfg, 3, ck, resume=True)
    _assert_same(_tensors(learner1), _tensors(learner2))
    pool = _raw_pendulum()
    tmpl = host_ckpt_state(pool, torch.Generator(), learner=learner2,
                           env_steps=torch.zeros((), dtype=torch.int64))
    Checkpointer(ck).restore(tmpl)
    assert torch.equal(tmpl.generator.get_state(), saved["generator"])
    assert int(tmpl.device_state["env_steps"]) == 24
    for k, t in tmpl.pool.items():
        assert torch.equal(t, saved["tensors"][f"pool.{k}"]), k


def test_offpolicy_host_resume_restores_learner(tmp_path):
    ck = tmp_path / "ck"
    learner1, _ = _run(ddpg.train_host, _raw_pendulum(), _ddpg_cfg(), 3, ck, save_every=2)
    learner2, history = _run(ddpg.train_host, _raw_pendulum(), _ddpg_cfg(), 3, ck, resume=True)
    _assert_same(_tensors(learner1), _tensors(learner2))  # nets, targets, Adam, the ring
    assert history == []


@pytest.mark.parametrize("replay_dtype", ["fp32", "mixed"])
def test_offpolicy_replay_free_checkpoint(tmp_path, replay_dtype):
    """save_replay=False: the saved ring is a one-slot stub (the codecs'
    stats in full); resume restores the nets exactly, warns, and starts
    from an empty full-capacity ring with the restored stats; training
    then refills it."""
    ck = tmp_path / "slim"
    cfg = _ddpg_cfg(replay_dtype=replay_dtype)
    learner1, _ = _run(ddpg.train_host, _raw_pendulum(), cfg, 3, ck, save_every=3,
                       save_replay=False)
    saved = torch.load(ck / "3" / "state.pt", weights_only=True)["tensors"]
    storage = {k: t for k, t in saved.items() if " storage." in k}
    assert storage and all(t.shape[0] == 1 for t in storage.values())
    quant = {k.split("learner.", 1)[1]: t for k, t in saved.items() if " quant." in k}
    assert quant
    assert capacity_of(learner1.replay) == cfg.buffer_capacity
    with open(ck / "3" / "metrics.json") as f:
        assert json.load(f)["_replay_saved"] == 0.0

    with pytest.warns(UserWarning, match="replay-free"):
        learner2, history = _run(ddpg.train_host, _raw_pendulum(), cfg, 3, ck, resume=True,
                                 save_replay=False)
    assert history == []
    _assert_same(_tensors(learner1.actor), _tensors(learner2.actor))
    assert int(learner2.replay.size) == 0 and int(learner2.replay.insert_pos) == 0
    assert capacity_of(learner2.replay) == cfg.buffer_capacity
    _assert_same({k: t for k, t in _tensors(learner2).items() if " quant." in k}, quant)
    if replay_dtype == "mixed":
        assert int(learner1.replay.quant.obs.count) > 0

    with pytest.warns(UserWarning, match="replay-free"):
        learner3, history = _run(ddpg.train_host, _raw_pendulum(), cfg, 5, ck, resume=True,
                                 save_replay=False, log_every=1)
    assert [it for it, _ in history] == [4, 5]
    assert int(learner3.replay.size) == 2 * cfg.steps_per_iter * 2


@pytest.mark.parametrize("trained_normalized", [True, False],
                         ids=["norm-ckpt-raw-pool", "raw-ckpt-norm-pool"])
def test_resume_warns_on_normalization_mismatch(tmp_path, trained_normalized):
    ck = tmp_path / "ck"
    _run(ppo.train_host, _pool(normalize_obs=trained_normalized, normalize_reward=False),
         _ppo_cfg(), 2, ck, save_every=1)
    with pytest.warns(UserWarning, match="off-distribution"):
        _run(ppo.train_host, _pool(normalize_obs=not trained_normalized, normalize_reward=False),
             _ppo_cfg(), 2, ck, resume=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _run(ppo.train_host, _pool(normalize_obs=trained_normalized, normalize_reward=False),
             _ppo_cfg(), 2, ck, resume=True)
    assert not [w for w in caught if "off-distribution" in str(w.message)]


def test_resume_warns_on_action_convention_mismatch(tmp_path):
    ck = tmp_path / "ck"
    _run(ddpg.train_host, _raw_pendulum(scale_actions=True), _ddpg_cfg(), 2, ck, save_every=1)
    with pytest.warns(UserWarning, match="execute differently"):
        _run(ddpg.train_host, _raw_pendulum(scale_actions=False), _ddpg_cfg(), 2, ck,
             resume=True)


@pytest.mark.parametrize("overlap", [True, False], ids=["mirror", "device"])
def test_ppo_host_eval_rides_log_row(overlap):
    pool = _pool()
    _, _, history = ppo.train_host(pool, _ppo_cfg(), 2, seed=0, log_every=0, eval_every=2,
                                   eval_envs=2, eval_steps=64, overlap=overlap, device="cpu")
    rows = dict(history)
    assert 2 in rows and math.isfinite(rows[2]["eval_return"]) and "env_steps" in rows[2]
    assert rows[2]["eval_s"] >= 0.0


@pytest.mark.parametrize("overlap", [True, False], ids=["mirror", "device"])
def test_sac_host_eval_and_gate(overlap):
    cfg = sac.SACConfig(num_envs=2, steps_per_iter=4, updates_per_iter=2, buffer_capacity=64,
                        batch_size=8, warmup_steps=8, hidden=(16,))
    learner, history = sac.train_host(_raw_pendulum(), cfg, 4, seed=0, log_every=1,
                                      eval_every=4, eval_envs=2, eval_steps=30,
                                      overlap=overlap, device="cpu")
    # The gate opens at iteration 1 (8 env steps, 8 in the ring): 2
    # updates an iteration.
    assert int(learner.update_count) == 4 * cfg.updates_per_iter
    assert [it for it, _ in history] == [1, 2, 3, 4]
    assert math.isfinite(history[-1][1]["eval_return"])


# ------------------------------------------------------------------ CLI


def _cli(argv, capsys, tmp_path):
    assert train.main(argv + ["--device", "cpu", "--metrics", str(tmp_path / "m.jsonl")]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    return [r for r in rows if "iter" in r], rows[-1], [x for x in lines if not x.startswith("{")]


@pytest.fixture
def one_thread():
    """One intra-op thread: the full-width updates are many small ops, which
    threads slow down where test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("preset", ["ppo_halfcheetah", "sac_humanoid"])
def test_mujoco_presets_run_as_they_are(preset, capsys, tmp_path, one_thread):
    """The presets on their own MuJoCo env at full width, 2 iterations."""
    pytest.importorskip("mujoco")
    rows, summary, _ = _cli(["--preset", preset, "--iterations", "2", "--log-every", "1"],
                            capsys, tmp_path)
    assert summary["env"] == train.PRESETS[preset].env and summary["device"] == "cpu"
    assert [r["iter"] for r in rows] == [1, 2]
    loss = "loss" if preset.startswith("ppo") else "critic_loss"
    assert all(math.isfinite(r[loss]) for r in rows)
    assert all(r["wall_s"] > 0 for r in rows)


def test_host_flags_and_resume_through_cli(capsys, tmp_path, one_thread):
    ck = str(tmp_path / "ck")
    base = ["--preset", "td3_walker2d", "--env", "native:Pendulum-v1", "--set",
            "buffer_capacity=4096", "--set", "warmup_steps=64", "--set", "updates_per_iter=4",
            "--eval-every", "2", "--eval-envs", "2", "--eval-steps", "40", "--no-overlap",
            "--no-save-replay", "--ckpt-dir", ck, "--save-every", "2", "--log-every", "1"]
    rows, summary, _ = _cli(base + ["--iterations", "2"], capsys, tmp_path)
    assert [r["iter"] for r in rows] == [1, 2] and math.isfinite(rows[-1]["eval_return"])
    assert summary["env"] == "native:Pendulum-v1" and summary["env_steps"] == 128
    with open(f"{ck}/2/metrics.json") as f:
        assert json.load(f)["_replay_saved"] == 0.0
    with pytest.warns(UserWarning, match="replay-free"):
        rows, _, notes = _cli(base + ["--iterations", "3", "--resume"], capsys, tmp_path)
    assert "resumed from iteration 2" in notes
    assert [r["iter"] for r in rows] == [3] and rows[0]["env_steps"] == 192


def test_host_ppo_cli_on_native_env(capsys, tmp_path):
    rows, summary, _ = _cli(["--algo", "ppo", "--env", "native:CartPole-v1", "--set",
                             "num_envs=4", "--set", "rollout_steps=16", "--iterations", "2",
                             "--eval-every", "2", "--eval-envs", "2", "--eval-steps", "30",
                             "--chunk", "4"], capsys, tmp_path)
    assert summary["env_steps"] == 128 and math.isfinite(summary["loss"])
    assert rows[-1]["eval_return"] is not None


@pytest.mark.parametrize("argv,match", [
    (["--preset", "a2c_cartpole", "--env", "native:CartPole-v1"], "no host trainer"),
    (["--algo", "ppo", "--env", "native:Pendulum-v1", "--env-set", "g=9.0"], "--env-set"),
    (["--algo", "ppo", "--env", "native:HalfCheetah-v5"], "native backend supports"),
    (["--algo", "ppo", "--env", "native:CartPole-v1", "--scale-actions"], "scale_actions"),
    (["--algo", "sac", "--env", "host:Pendulum-v1", "--curriculum", "0:1"], "mixture"),
])
def test_host_selections_that_exit(argv, match):
    with pytest.raises(SystemExit, match=match):
        train.main(argv + ["--device", "cpu", "--iterations", "1"])


def test_host_scale_actions_convention():
    assert train.effective_scale_actions("host:Humanoid-v5", None) is False
    assert train.effective_scale_actions("native:Pendulum-v1", True) is True
    cfg = dataclasses.replace(_ddpg_cfg(), num_envs=3)
    pool = train.make_host_pool("native:Pendulum-v1", "td3", cfg, 0, scale_actions=True)
    assert pool.scales_actions and not pool.normalizes_obs and pool.num_envs == 3
    pool = train.make_host_pool("native:Pendulum-v1", "ppo", cfg, 0)
    assert not pool.scales_actions and pool.normalizes_obs
    with pytest.raises(ValueError, match="host pool"):
        train.make_env("host:Pendulum-v1", {})
