"""The port's config overrides and CLI (`config.py`, `train.py`) against the
JAX package's `config.py` and `train.py`:

- `parse_set_args`, `parse_env_set_args`, `apply_overrides`,
  `default_config` and `resolve` give what JAX's give on the same strings
  (tuple, Optional, bool, int, float and str fields, unknown keys, a
  preset under another `--algo` or `--env`);
- `--list-presets`, `--quiet` and `--metrics` behave as JAX's;
- `--chunk 4` equals `--chunk 1` bit for bit on the CPU (the final states
  through their checkpoints, the rows), and the cadences snap up and say
  so;
- a run checkpointed and resumed through the CLI logs and ends as the
  straight run, and the resume guard warns on a changed env;
- `--algo/--env` runs a Gaussian A2C on `jax:pendulum` and IMPALA on
  `jax:point_mass`, and the off-policy trainers: `--algo ddpg|td3|sac` on
  `jax:point_mass`, and a MuJoCo preset's learner on `jax:pendulum`;
- `--list-presets` names JAX's ten presets, in JAX's order;
- `--replay-dtype` sets the ring's codecs, and exits on an algorithm with
  no ring, as JAX's;
- `--update-dtype fp32|bf16` is `--set bf16_compute=...`, and bf16 runs
  on the host path's `host:`/`native:` envs and the MuJoCo presets'
  learners; what is not ported yet (`--workers` and the flags of later
  paths) exits with a message saying so;
- the async actor-learner's seven flags (`--async-actors`,
  `--updates-per-block`, `--max-staleness`, `--queue-depth`,
  `--async-correction`, `--data-plane`, `--data-plane-codec`) each run
  their path, and the JAX CLI's refusals around them exit as JAX's do;
  `--serve-port` without `--async-actors` exits as JAX's does (its runs:
  tests/test_torch_serve_cli.py).
"""

import dataclasses
import json
import sys

import pytest
import torch

from actor_critic_tpu import config as jconfig
from actor_critic_tpu_torch import config as tconfig
from actor_critic_tpu_torch import train

SET_CASES = [
    ["lr=1e-4"],
    ["hidden=32,16", "num_envs=8"],
    ["hidden="],
    ["lr_final=none"],
    ["lr_final=2.5e-5", "anneal_iters=7"],
    ["normalize_adv=yes"],
    ["normalize_adv=0"],
    ["entropy_coef_final=null", "gamma=0.9"],
]


@pytest.mark.parametrize("pairs", SET_CASES, ids=lambda p: ";".join(p))
def test_set_overrides_match_jax(pairs):
    assert tconfig.parse_set_args(pairs) == jconfig.parse_set_args(pairs)
    overrides = tconfig.parse_set_args(pairs)
    for algo in ("a2c", "ppo"):
        got = tconfig.apply_overrides(tconfig.default_config(algo), overrides)
        want = jconfig.apply_overrides(jconfig.default_config(algo), overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("pairs,error", [
    (["bogus=1"], KeyError),
    (["normalize_adv=maybe"], ValueError),
    (["num_envs=eight"], ValueError),
])
def test_bad_overrides_raise_as_in_jax(pairs, error):
    overrides = tconfig.parse_set_args(pairs)
    for cfg_mod in (tconfig, jconfig):
        with pytest.raises(error):
            cfg_mod.apply_overrides(cfg_mod.default_config("a2c"), overrides)
    with pytest.raises(ValueError, match="key=value"):
        tconfig.parse_set_args(["lr"])


@pytest.mark.parametrize("pairs", [
    ["opp_skill=0.5", "frame_skip=4"], ["randomize=0.2", "redraw_types=false"],
    ["masspole=0.05,0.5", "scale_actions=None", "name=x"], ["flag=on", "n=-3", "x=1e-3"],
])
def test_env_set_parsing_matches_jax(pairs):
    assert tconfig.parse_env_set_args(pairs) == jconfig.parse_env_set_args(pairs)


@pytest.mark.parametrize("algo", sorted(tconfig.ALGO_CONFIGS))
def test_default_config_matches_jax(algo):
    assert dataclasses.asdict(tconfig.default_config(algo)) == dataclasses.asdict(
        jconfig.default_config(algo))


RESOLVE_CASES = [
    # (preset, algo, env, --set, --env-set)
    ("a2c_cartpole", None, None, ["lr=1e-4"], []),
    ("a2c_cartpole", "ppo", None, ["epochs=2"], []),
    ("impala_pong", "a3c", None, [], []),
    ("ppo_cartpole", "a2c", None, [], []),
    ("impala_pong_learn", None, None, [], ["opp_skill=0.7"]),
    ("impala_pong_learn", None, "jax:pong", [], []),
    ("impala_pong_learn", None, "jax:cartpole", [], ["x=1"]),
    ("a2c_mixture", None, None, ["hidden=32"], ["randomize=0.1"]),
    (None, "a3c", "jax:pong", ["num_envs=8"], ["size=42"]),
    (None, "ppo", "jax:point_mass", [], []),
    ("sac_humanoid", None, "jax:pendulum", ["warmup_steps=64"], []),
    ("td3_walker2d", None, "jax:pendulum", ["replay_dtype=mixed"], []),
    ("ddpg_walker2d", "td3", None, [], []),
    ("ppo_halfcheetah", None, None, [], []),
    (None, "sac", "jax:point_mass", ["fixed_alpha=0.2", "hidden=32,32"], []),
    (None, "td3", "jax:pendulum", ["nstep=3", "num_envs=1"], []),
]


@pytest.mark.parametrize("case", RESOLVE_CASES, ids=lambda c: str(c))
def test_resolve_matches_jax(case):
    preset, algo, env, sets, env_sets = case
    got = tconfig.resolve(preset, algo, env, tconfig.parse_set_args(sets),
                          env_overrides=tconfig.parse_env_set_args(env_sets))
    want = jconfig.resolve(preset, algo, env, jconfig.parse_set_args(sets),
                           env_overrides=jconfig.parse_env_set_args(env_sets))
    assert (got.algo, got.iterations, got.env_kwargs) == (want.algo, want.iterations,
                                                          want.env_kwargs)
    assert train.env_name(got.env) == train.env_name(want.env)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)


def test_resolve_errors():
    with pytest.raises(KeyError, match="unknown preset"):
        tconfig.resolve("bogus", None, None, {})
    with pytest.raises(ValueError, match="--preset"):
        tconfig.resolve(None, "a2c", None, {})
    with pytest.raises(KeyError, match="unknown algo"):
        tconfig.default_config("bogus")
    # Every algorithm of the JAX package has its config in the port.
    assert list(tconfig.ALGO_CONFIGS) == list(jconfig.ALGO_CONFIGS)
    with pytest.raises(ValueError, match="init_alpha"):
        tconfig.resolve(None, "sac", "jax:pendulum", {"init_alpha": "0"})


def test_list_presets(capsys):
    assert train.main(["--list-presets"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == list(tconfig.PRESETS)
    for line, (name, p) in zip(lines, tconfig.PRESETS.items()):
        assert line.split()[1:3] == [p.algo, p.env] and p.description in line


def test_envs_are_jax_makers():
    import train as jtrain  # the JAX package's CLI, at the repository root

    assert train.env_name("jax:pong") == train.env_name("pong") == "pong"
    for name, maker in train.ENVS.items():
        assert maker.__name__ == {"two_state": "make_two_state_mdp"}.get(name, f"make_{name}")
    with pytest.raises(SystemExit, match="unknown jax env"):
        train.make_env("jax:acrobot", {})
    assert jtrain.effective_scale_actions("jax:pendulum", None) is True
    for spec, flag, kw in (("jax:pendulum", None, {}), ("pendulum", False, {}),
                           ("jax:pendulum", None, {"scale_actions": False}),
                           ("jax:cartpole", True, {})):
        assert train.effective_scale_actions(spec, flag, kw) == jtrain.effective_scale_actions(
            "jax:" + train.env_name(spec), flag, kw)


def _cli(argv, capsys, tmp_path, name="m.jsonl"):
    """train.main(argv + CPU, metrics under tmp_path): (rows echoed, summary,
    other lines)."""
    assert train.main(argv + ["--device", "cpu", "--metrics", str(tmp_path / name)]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    return rows[:-1], rows[-1], [x for x in lines if not x.startswith("{")]


SMALL = ["--preset", "a2c_cartpole", "--set", "num_envs=16", "--set", "rollout_steps=8"]


def test_quiet_and_metrics_file(capsys, tmp_path):
    rows, summary, _ = _cli(SMALL + ["--iterations", "3", "--log-every", "2"], capsys, tmp_path)
    assert [r["iter"] for r in rows] == [1, 2, 3] and summary["iterations"] == 3
    with open(tmp_path / "m.jsonl") as f:
        assert [json.loads(x) for x in f] == rows
    rows, summary, _ = _cli(SMALL + ["--iterations", "3", "--quiet"], capsys, tmp_path, "q.jsonl")
    assert rows == [] and summary["algo"] == "a2c"
    with open(tmp_path / "q.jsonl") as f:
        assert [json.loads(x)["iter"] for x in f] == [1, 3]


def _final_state(ckpt_dir, step):
    return torch.load(f"{ckpt_dir}/{step}/state.pt", weights_only=True)


@pytest.mark.parametrize("preset", ["a2c_cartpole", "impala_pong"])
def test_chunk_equals_per_iteration(preset, capsys, tmp_path):
    """--chunk 4 over 10 iterations (two chunks and a tail) ends in the
    state of --chunk 1, bit for bit (read back from each run's final
    checkpoint), with the same metrics at the shared log points; the
    cadences snap up to multiples of 4 and say so."""
    argv = ["--preset", preset, "--iterations", "10", "--save-every", "0", "--log-every", "2",
            "--eval-every", "3"]
    if preset == "a2c_cartpole":
        argv += ["--set", "num_envs=16", "--set", "rollout_steps=8"]
    else:
        argv += ["--set", "num_envs=4", "--set", "rollout_steps=4", "--env-set", "size=42",
                 "--env-set", "max_steps=40"]
    out = {}
    for chunk in (1, 4):
        ck = tmp_path / f"chunk{chunk}"
        rows, summary, notes = _cli(argv + ["--chunk", str(chunk), "--ckpt-dir", str(ck)],
                                    capsys, tmp_path)
        out[chunk] = ({r["iter"]: r for r in rows}, summary, notes, _final_state(ck, 10))
    (rows1, sum1, _, s1), (rows4, sum4, notes4, s4) = out[1], out[4]
    assert "--chunk 4: log_every 2 -> 4" in notes4 and "--chunk 4: eval_every 3 -> 4" in notes4
    assert sorted(rows4) == [4, 8, 10]
    assert all(torch.equal(s1["tensors"][k], s4["tensors"][k]) for k in s1["tensors"])
    assert torch.equal(s1["generator"], s4["generator"])
    drop = ("wall_s",)
    for it in (4, 8, 10):
        a = {k: v for k, v in rows1[it].items() if k not in drop and not k.startswith("eval")}
        b = {k: v for k, v in rows4[it].items() if k not in drop and not k.startswith("eval")}
        assert a == b, it
    assert rows4[10]["eval_return"] == rows1[10]["eval_return"]
    assert {k: v for k, v in sum1.items() if k != "wall_s"} == {
        k: v for k, v in sum4.items() if k != "wall_s"}


def test_cli_resume_equals_straight_run(capsys, tmp_path):
    """--ckpt-dir … --save-every 2 --iterations 4, then --resume
    --iterations 6: the resumed run's rows (eval included: every eval
    starts the eval generator from seed + 1) and summary are the straight
    run's."""
    argv = SMALL + ["--log-every", "1", "--eval-every", "2"]
    straight, s_sum, _ = _cli(argv + ["--iterations", "6"], capsys, tmp_path)
    ck = str(tmp_path / "ck")
    _cli(argv + ["--iterations", "4", "--ckpt-dir", ck, "--save-every", "2"], capsys, tmp_path)
    resumed, r_sum, notes = _cli(
        argv + ["--iterations", "6", "--ckpt-dir", ck, "--save-every", "2", "--resume"],
        capsys, tmp_path)
    assert "resumed from iteration 4" in notes
    assert [r["iter"] for r in resumed] == [5, 6]
    strip = lambda r: {k: v for k, v in r.items() if k != "wall_s"}
    assert [strip(r) for r in resumed] == [strip(r) for r in straight[4:]]
    assert strip(r_sum) == strip(s_sum)
    # Nothing left to run: the saved metrics are reported.
    _, again, _ = _cli(argv + ["--iterations", "6", "--ckpt-dir", ck, "--resume"], capsys, tmp_path)
    assert again["loss"] == s_sum["loss"]


def test_resume_guard_warns_on_a_changed_env(capsys, tmp_path):
    ck = str(tmp_path / "ck")
    argv = ["--algo", "a2c", "--env", "jax:pendulum", "--set", "num_envs=4", "--set",
            "rollout_steps=2", "--iterations", "1", "--ckpt-dir", ck]
    _cli(argv, capsys, tmp_path)
    with open(f"{ck}/env_convention.json") as f:
        assert json.load(f) == {"env": "jax:pendulum", "scale_actions": True, "env_kwargs": {}}
    with pytest.warns(UserWarning, match="scale_actions=False"):
        _cli(argv + ["--resume", "--no-scale-actions", "--iterations", "2"], capsys, tmp_path)
    with pytest.warns(UserWarning, match="env_kwargs"):
        _cli(argv + ["--resume", "--env-set", "randomize=0.1", "--iterations", "3"],
             capsys, tmp_path)


@pytest.mark.parametrize("algo,env", [("a2c", "jax:pendulum"), ("impala", "jax:point_mass")])
def test_algo_env_runs(algo, env, capsys, tmp_path):
    rows, summary, notes = _cli(["--algo", algo, "--env", env, "--iterations", "2",
                                 "--eval-every", "2", "--set", "num_envs=8"], capsys, tmp_path)
    assert notes[0].startswith(f"algo={algo} env={env}")
    assert [r["iter"] for r in rows] == [1, 2] and rows[-1]["eval_return"] is not None
    assert summary["env"] == env and summary["loss"] is not None


BF16_HOST_PATHS = [
    ["--preset", "sac_humanoid", "--env", "native:Pendulum-v1", "--set", "bf16_compute=true"],
    ["--preset", "ddpg_walker2d", "--replay-dtype", "mixed", "--env", "native:Pendulum-v1",
     "--set", "bf16_compute=true"],
    ["--preset", "ppo_cartpole", "--env", "host:CartPole-v1", "--set", "bf16_compute=true"],
    ["--algo", "ppo", "--env", "native:Acrobot-v1", "--set", "bf16_compute=true"],
]


@pytest.mark.parametrize("argv", BF16_HOST_PATHS)
def test_bf16_runs_on_the_host_paths(argv, capsys, tmp_path):
    """bf16 compute on the host path's `host:`/`native:` envs and the MuJoCo
    presets' learners (refused as not ported before it was): an iteration
    runs, with `bf16_compute` in the run's config and a finite loss."""
    _, summary, notes = _cli(argv + ["--iterations", "1", "--quiet"], capsys, tmp_path)
    assert "'bf16_compute': True" in notes[0]
    assert summary["loss" if "loss" in summary else "critic_loss"] is not None


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_update_dtype_is_set_bf16_compute(dtype, capsys, tmp_path):
    """`--update-dtype` as JAX's: the same as `--set bf16_compute=...`
    (bf16 reaches True, fp32 False, and it wins over a `--set`), the same
    rows; bf16 and fp32 runs log different losses."""
    want = dtype == "bf16"
    argv = SMALL + ["--iterations", "2", "--log-every", "1"]
    rows, _, notes = _cli(argv + ["--set", f"bf16_compute={not want}", "--update-dtype", dtype],
                          capsys, tmp_path)
    assert f"'bf16_compute': {want}" in notes[0]
    same, _, _ = _cli(argv + ["--set", f"bf16_compute={want}"], capsys, tmp_path, "s.jsonl")
    other, _, _ = _cli(argv + ["--set", f"bf16_compute={not want}"], capsys, tmp_path, "o.jsonl")
    assert [r["loss"] for r in rows] == [r["loss"] for r in same]
    assert [r["loss"] for r in rows] != [r["loss"] for r in other]


@pytest.mark.parametrize("argv,match", [
    (["--algo", "ppo", "--env", "gym:CartPole-v1"], "env must be"),
    (["--preset", "a2c_cartpole", "--set", "bogus=1"], "no field"),
    (["--algo", "a2c"], "need --preset"),
    (["--preset", "a2c_cartpole", "--chunk", "0"], "--chunk"),
])
def test_unported_and_bad_selections_exit(argv, match):
    with pytest.raises(SystemExit, match=match):
        train.main(argv + ["--device", "cpu", "--iterations", "1"])


@pytest.mark.parametrize("flag", sorted(train.UNPORTED_FLAGS))
def test_flags_still_to_port_are_refused(flag, capsys):
    """The JAX CLI's flags of the paths not ported yet: each exits with the
    path it belongs to, never silently ignored."""
    with pytest.raises(SystemExit):
        train.main(["--preset", "a2c_cartpole", flag, "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and train.UNPORTED_FLAGS[flag] in err


def test_list_presets_names_jax_presets(capsys):
    assert train.main(["--list-presets"]) == 0
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert names == list(jconfig.PRESETS) and len(names) == 10
    for name in ("ddpg_walker2d", "td3_walker2d", "sac_humanoid", "ppo_halfcheetah"):
        t, j = tconfig.PRESETS[name], jconfig.PRESETS[name]
        assert (t.algo, t.env, t.iterations, t.env_kwargs) == (j.algo, j.env, j.iterations,
                                                               j.env_kwargs)
        assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)


OFFPOLICY_RUNS = [
    ["--algo", "ddpg", "--env", "jax:point_mass", "--set", "buffer_capacity=4096"],
    ["--algo", "td3", "--env", "jax:point_mass", "--replay-dtype", "int8"],
    ["--algo", "sac", "--env", "jax:point_mass", "--set", "batch_size=32"],
    ["--preset", "td3_walker2d", "--env", "jax:pendulum", "--set", "warmup_steps=64",
     "--set", "hidden=32,32", "--set", "updates_per_iter=4", "--replay-dtype", "mixed"],
    ["--preset", "sac_humanoid", "--env", "jax:pendulum", "--set", "warmup_steps=64",
     "--set", "hidden=32,32", "--set", "updates_per_iter=4"],
]


@pytest.mark.parametrize("argv", OFFPOLICY_RUNS, ids=lambda a: " ".join(a[:4]))
def test_offpolicy_cli_runs(argv, capsys, tmp_path):
    """Two iterations with an eval; the env steps an iteration takes are
    K·E (`steps_per_iteration`), and the config takes --replay-dtype."""
    rows, summary, notes = _cli(argv + ["--iterations", "2", "--eval-every", "2"],
                                capsys, tmp_path)
    preset = tconfig.resolve(*(argv[argv.index(f) + 1] if f in argv else None
                               for f in ("--preset", "--algo", "--env")), {})
    cfg = preset.config
    assert notes[0].startswith(f"algo={preset.algo} env=")
    if "--replay-dtype" in argv:
        assert f"'replay_dtype': '{argv[argv.index('--replay-dtype') + 1]}'" in notes[0]
    spi = cfg.steps_per_iter * cfg.num_envs
    assert train.steps_per_iteration(preset.algo, cfg) == spi
    assert [r["env_steps"] for r in rows] == [spi, 2 * spi] and summary["env_steps"] == 2 * spi
    assert rows[-1]["eval_return"] is not None and summary["critic_loss"] is not None


def test_replay_dtype_needs_a_ring():
    with pytest.raises(SystemExit, match="has no replay storage"):
        train.main(["--preset", "ppo_cartpole", "--replay-dtype", "mixed", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train.parse_args(["--algo", "sac", "--replay-dtype", "bf16"])


@pytest.fixture
def cpu_learner():
    """One intra-op thread (the learner's ops beside the actor threads would
    otherwise oversubscribe the cores) and a 0.1 ms GIL switch interval: an
    actor's Python loop holds the GIL up to the interval (5 ms by default)
    each time a learner op releases it, and at 5 ms the CPU learner's
    thousands of ops a block take minutes. On the card an update is one
    graph replay, a single call."""
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-4)
    yield
    sys.setswitchinterval(interval)
    torch.set_num_threads(threads)


ASYNC_BASE = ["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--set",
              "num_envs=4", "--set", "rollout_steps=8", "--set", "epochs=1", "--set",
              "num_minibatches=1", "--set", "hidden=8", "--iterations", "3", "--log-every", "1",
              "--device", "cpu"]


@pytest.mark.parametrize("flags,check", [
    (["--async-actors", "2"], lambda r: r["blocks_1"] >= 1 and "mean_rho" in r),
    (["--async-actors", "1", "--updates-per-block", "2"], lambda r: "mean_rho" in r),
    (["--async-actors", "2", "--max-staleness", "1"], lambda r: r["queue_drops_stale"] >= 0),
    (["--async-actors", "1", "--max-staleness", "-1"], lambda r: r["queue_drops_stale"] == 0),
    (["--async-actors", "1", "--queue-depth", "1"], lambda r: r["queue_depth"] <= 1),
    (["--async-actors", "1", "--async-correction", "none"], lambda r: "mean_rho" not in r),
    (["--async-actors", "2", "--data-plane", "device"], lambda r: "mean_rho" in r),
    (["--async-actors", "1", "--data-plane", "device", "--data-plane-codec", "int8"],
     lambda r: r["consumed_env_steps"] == 3 * 8 * 4),
], ids=["async-actors", "updates-per-block", "max-staleness", "max-staleness-off", "queue-depth",
        "async-correction", "data-plane", "data-plane-codec"])
def test_async_flags_run_their_path(flags, check, capsys, tmp_path, cpu_learner):
    metrics = tmp_path / "m.jsonl"
    assert train.main(ASYNC_BASE + flags + ["--metrics", str(metrics), "--quiet"]) == 0
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["iter"] for r in rows] == [1, 2, 3]
    actors = int(flags[1])
    for r in rows:
        assert {"block_actor", "block_staleness", "queue_drops_full", "learner_idle_s",
                "consumed_env_steps", "wait_s", "dispatch_s"} <= set(r)
        assert r["consumed_env_steps"] == r["iter"] * 8 * (4 // actors)
        assert r["env_steps"] >= r["consumed_env_steps"]
    assert check(rows[-1]), rows[-1]
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["iterations"] == 3 and summary["consumed_env_steps"] == 3 * 8 * (4 // actors)


def test_async_offpolicy_through_the_cli(capsys, tmp_path, cpu_learner):
    argv = ["--preset", "sac_humanoid", "--env", "native:Pendulum-v1", "--set", "hidden=8,8",
            "--set", "updates_per_iter=2", "--set", "steps_per_iter=4", "--set",
            "batch_size=4", "--set", "warmup_steps=8", "--async-actors", "1", "--iterations",
            "4", "--data-plane", "device", "--metrics", str(tmp_path / "m.jsonl"), "--quiet",
            "--device", "cpu"]
    assert train.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["consumed_env_steps"] == 16 and summary["critic_loss"] is not None


def test_async_ppo_resume_through_the_cli(capsys, tmp_path, cpu_learner):
    ck = str(tmp_path / "ck")
    base = ASYNC_BASE + ["--async-actors", "2", "--ckpt-dir", ck, "--save-every", "2",
                         "--metrics", str(tmp_path / "m.jsonl"), "--quiet"]
    assert train.main(base) == 0
    assert train.main([a if a != "3" else "5" for a in base] + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from block 3" in out
    assert json.loads(out.strip().splitlines()[-1])["consumed_env_steps"] == 5 * 8 * 2


@pytest.mark.parametrize("argv,match", [
    (["--preset", "ppo_cartpole", "--async-actors", "2"], "decouples HOST collection"),
    (["--algo", "a2c", "--env", "native:CartPole-v1", "--async-actors", "2"],
     "has no host loop"),
    (["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--async-actors", "3"],
     "must split evenly"),
    (["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--async-actors", "16"],
     "must split evenly"),
    (["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--data-plane", "device"],
     "pass --async-actors"),
    (["--preset", "sac_humanoid", "--env", "native:Pendulum-v1", "--async-actors", "1",
      "--ckpt-dir", "/nonexistent/ck"], "checkpointing is wired for PPO only"),
    (["--preset", "td3_walker2d", "--env", "native:Pendulum-v1", "--async-actors", "1",
      "--resume"], "checkpointing is wired for PPO only"),
    (["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--async-actors", "2",
      "--updates-per-block", "0"], "--updates-per-block"),
    (["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--async-actors", "2",
      "--queue-depth", "0"], "--queue-depth"),
    (["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--async-actors", "-1"],
     "--async-actors"),
], ids=["jax-env", "no-host-trainer", "uneven-split", "more-actors-than-envs",
        "device-plane-alone", "offpolicy-ckpt", "offpolicy-resume", "updates-per-block",
        "queue-depth", "negative-actors"])
def test_async_selections_that_exit_as_jax(argv, match):
    with pytest.raises(SystemExit, match=match):
        train.main(argv + ["--device", "cpu", "--iterations", "1"])


@pytest.mark.parametrize("flag,path", [("--workers", "the sharded host pool"),
                                       ("--distributed", "multi-GPU")])
def test_later_paths_stay_refused_beside_async(flag, path, capsys):
    with pytest.raises(SystemExit):
        train.main(["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1",
                    "--async-actors", "2", flag, "2", "--device", "cpu"])
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and path in err


def test_serve_port_without_async_actors_exits_as_jax():
    """`--serve-port` (ported with serving) hooks the async learner's
    publish: JAX's refusal without `--async-actors`, before any env work."""
    with pytest.raises(SystemExit, match="--serve-port hooks the async learner"):
        train.main(["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1",
                    "--serve-port", "0", "--serve-buckets", "1,4", "--device", "cpu"])


@pytest.mark.parametrize("value,algo,want", [(None, "ppo", 8), (None, "sac", None),
                                             (3, "ddpg", 3), (-1, "ppo", None),
                                             (0, "ppo", 0)])
def test_resolve_staleness_as_jax(value, algo, want):
    import argparse

    assert train.resolve_staleness(argparse.Namespace(max_staleness=value), algo) == want
