"""Guards on the PyTorch port as a whole: it imports nothing of JAX, it
does not run on the CPU unless asked to, its configurations cannot drift
from the JAX package's, and A2C learns CartPole (slow-marked)."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from actor_critic_tpu import config as jconfig
from actor_critic_tpu.algos import a2c as ja2c
from actor_critic_tpu.algos import impala as jimpala
from actor_critic_tpu.algos import ppo as jppo
from actor_critic_tpu_torch import config as tconfig
from actor_critic_tpu_torch import resolve_device, train
from actor_critic_tpu_torch.algos import a2c as ta2c
from actor_critic_tpu_torch.algos import impala as timpala
from actor_critic_tpu_torch.algos import ppo as tppo
from actor_critic_tpu_torch.envs import make_cartpole, make_pong

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "actor_critic_tpu"}
PORT_FILES = sorted((ROOT / "actor_critic_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_import_scan_covers_every_module_of_the_port():
    """The scan takes every module under the package (new ones included) and
    the smoke script."""
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for name in ("chip_smoke.py", "actor_critic_tpu_torch/train.py",
                 "actor_critic_tpu_torch/utils/checkpoint.py",
                 "actor_critic_tpu_torch/utils/cadence.py",
                 "actor_critic_tpu_torch/utils/logging.py",
                 "actor_critic_tpu_torch/replay/buffer.py",
                 "actor_critic_tpu_torch/replay/quantize.py",
                 "actor_critic_tpu_torch/algos/ddpg.py",
                 "actor_critic_tpu_torch/algos/sac.py",
                 "actor_critic_tpu_torch/ops/polyak.py"):
        assert name in scanned, name


def test_import_scan_sees_the_forbidden_forms(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom flax import linen\n"
        "from actor_critic_tpu.ops import returns\nimport importlib\n"
        "importlib.import_module('optax')\nimport actor_critic_tpu_torch\n")
    assert _imported_roots(probe) & FORBIDDEN == {"jax", "flax", "actor_critic_tpu", "optax"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--preset", "a2c_cartpole", "--iterations", "1"])
    cfg = ta2c.A2CConfig(num_envs=4, rollout_steps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ta2c.init_state(make_cartpole(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ta2c.train(make_cartpole(), cfg, 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_impala_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--preset", "impala_pong", "--iterations", "1"])
    cfg = timpala.ImpalaConfig(num_envs=2, rollout_steps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        timpala.init_state(make_pong(size=36), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        timpala.train(make_pong(size=36), cfg, 1)


def test_ppo_entry_points_raise_without_cuda(no_cuda, capsys):
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--preset", "ppo_cartpole", "--iterations", "1"])
    cfg = tppo.PPOConfig(num_envs=4, rollout_steps=2, num_minibatches=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tppo.init_state(make_cartpole(), cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tppo.train(make_cartpole(), cfg, 1)
    # Asked for the CPU, the same entry point runs.
    assert train.main(["--preset", "ppo_cartpole", "--iterations", "1", "--device", "cpu"]) == 0
    assert '"algo": "ppo"' in capsys.readouterr().out


def test_offpolicy_entry_points_raise_without_cuda(no_cuda, capsys):
    from actor_critic_tpu_torch.algos import ddpg as tddpg
    from actor_critic_tpu_torch.algos import sac as tsac
    from actor_critic_tpu_torch.envs import make_point_mass

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--algo", "sac", "--env", "jax:pendulum", "--iterations", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--preset", "td3_walker2d", "--env", "jax:pendulum", "--iterations", "1"])
    small = dict(num_envs=2, steps_per_iter=2, updates_per_iter=1, buffer_capacity=16,
                 batch_size=4, hidden=(8,))
    for mod, cfg in ((tddpg, tddpg.td3_config(**small)), (tsac, tsac.SACConfig(**small))):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.init_state(make_point_mass(), cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            mod.train(make_point_mass(), cfg, 1)
        with pytest.raises(RuntimeError, match="cuda"):
            mod.init_learner((3,), 1, cfg)
    # Asked for the CPU, the same entry point runs.
    assert train.main(["--algo", "sac", "--env", "jax:pendulum", "--iterations", "1",
                       "--set", "hidden=16", "--set", "buffer_capacity=64",
                       "--set", "batch_size=8", "--device", "cpu"]) == 0
    assert '"algo": "sac"' in capsys.readouterr().out


def test_a2c_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(ja2c.A2CConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ta2c.A2CConfig)]
    assert tf == jf


def test_impala_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jimpala.ImpalaConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(timpala.ImpalaConfig)]
    assert tf == jf


def test_ppo_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jppo.PPOConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tppo.PPOConfig)]
    assert tf == jf


def test_ppo_cartpole_preset_matches_jax():
    j, t = jconfig.PRESETS["ppo_cartpole"], tconfig.PRESETS["ppo_cartpole"]
    assert (t.algo, t.iterations) == (j.algo, j.iterations)
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert j.env == "jax:cartpole" and t.env == "cartpole" and t.env_kwargs == j.env_kwargs
    assert train.ALGOS[t.algo] is tppo


def test_a2c_cartpole_preset_matches_jax():
    j, t = jconfig.PRESETS["a2c_cartpole"], tconfig.PRESETS["a2c_cartpole"]
    assert (t.algo, t.iterations) == (j.algo, j.iterations)
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert j.env == "jax:cartpole" and t.env == "cartpole"


def test_a2c_mixture_preset_matches_jax():
    j, t = jconfig.PRESETS["a2c_mixture"], tconfig.PRESETS["a2c_mixture"]
    assert (t.algo, t.iterations, t.env, t.env_kwargs) == (j.algo, j.iterations, j.env, j.env_kwargs)
    assert t.env == "mixture:cartpole,pendulum,acrobot,maze" and t.env_kwargs == {"randomize": 0.2}
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert train.ALGOS[t.algo] is ta2c


def test_a2c_mixture_entry_point_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--preset", "a2c_mixture", "--iterations", "1"])


@pytest.mark.parametrize("name", ["impala_pong", "impala_pong_learn", "a3c_pong"])
def test_pong_preset_matches_jax(name):
    j, t = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert (t.algo, t.iterations) == (j.algo, j.iterations)
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert j.env == f"jax:{t.env}" and t.env in train.ENVS
    assert t.env_kwargs == j.env_kwargs
    assert train.ALGOS[t.algo] is timpala


@pytest.mark.slow
def test_a2c_learns_cartpole_annealed():
    """tests/test_a2c.py's shape (E=256, T=64, lr=1e-3, lr and entropy
    annealed to 0 over 400 iterations) on the CPU: greedy eval >= 400."""
    env = make_cartpole()
    cfg = ta2c.A2CConfig(
        num_envs=256, rollout_steps=64, lr=1e-3,
        anneal_iters=400, lr_final=0.0,
        entropy_coef=0.01, entropy_coef_final=0.0,
    )
    state, _ = ta2c.train(env, cfg, num_iterations=400, seed=0, device="cpu")
    ev = float(ta2c.make_eval_fn(env, cfg)(state, torch.Generator().manual_seed(1), 32, 512))
    assert ev >= 400.0, f"annealed A2C failed CartPole: greedy eval {ev}"
