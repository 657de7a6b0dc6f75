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
- what is not ported yet (bf16 compute, also on the host path's
  `host:`/`native:` envs and the MuJoCo presets, `--workers` and the
  flags of later paths) exits with a message saying so.
"""

import dataclasses
import json

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


@pytest.mark.parametrize("argv,match", [
    (["--preset", "sac_humanoid", "--env", "native:Pendulum-v1", "--set", "bf16_compute=true"],
     "not ported"),
    (["--preset", "ddpg_walker2d", "--replay-dtype", "mixed", "--env", "native:Pendulum-v1",
      "--set", "bf16_compute=true"], "not ported"),
    (["--preset", "ppo_cartpole", "--env", "host:CartPole-v1", "--set", "bf16_compute=true"],
     "not ported"),
    (["--algo", "ppo", "--env", "native:Acrobot-v1", "--set", "bf16_compute=true"],
     "not ported"),
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
