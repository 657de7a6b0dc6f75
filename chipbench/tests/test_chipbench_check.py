"""The check that decides `correct`, driven through a whole run on the CPU
at a tiny size: the port against the plain reference passes; the
control (the port's bf16 path) and each fault a training cell can have,
planted in the program underneath the timed path, fail."""

from __future__ import annotations

import json
import math
import time

import pytest
import torch

from chipbench import catalog, check, core

CELLS = ["a2c_cartpole.tiny", "impala_pong.tiny"]


def run(root, cell, seed=2 ** 31 + 17, trace=False):
    return core.execute(catalog.Catalog(root), cell, seed, 1.0, trace, time.time(), device="cpu")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17, 2 ** 40 + 3])
def test_port_agrees_with_reference(tiny_root, cell, seed):
    result, lines = run(tiny_root, cell, seed)
    assert result["correct"], lines
    assert all(c["value"] <= c["limit"] / 10 for c in result["checks"].values()), lines


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_schema(tiny_root, cell):
    result, lines = run(tiny_root, cell)
    text = json.dumps(result, allow_nan=False)
    back = json.loads(text)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert isinstance(back["correct"], bool) and back["attempted"] > 0 and back["failed"] == 0
    assert set(back["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # A tail needs two intervals: a window that a slow host fills with one
    # replay leaves it out.
    tail = {"iter_ms_p95"} if back["attempted"] >= 2 else set()
    assert set(back["metrics"]) == {"env_steps_per_s", "setup_s"} | tail
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for name, c in back["checks"].items():
        assert set(c) == {"value", "limit"}
        assert lines[-len(back["checks"]):][list(back["checks"]).index(name)].startswith(f"check {name} ")


@pytest.mark.parametrize("cell", CELLS)
def test_control_bf16_is_not_correct(tiny_root, cell, monkeypatch):
    """The control: the program's own bf16 path, one precision below the
    configuration's float32."""

    class Bf16(core.Program):
        def __init__(self, cell, seed, device, bf16=False):
            super().__init__(cell, seed, device, bf16=True)

    monkeypatch.setattr(core, "Program", Bf16)
    result, lines = run(tiny_root, cell)
    assert not result["correct"], lines


def _unchanged(mod, monkeypatch):
    """A step that returns its state unchanged."""
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.algos.common import carried_tensors

    real = mod.make_train_step

    def make(env, cfg, group=None):
        step = real(env, cfg, group)

        def train_step(state):
            with loop.restored(carried_tensors(state), state.generator):
                _, metrics = step(state)
                metrics = {k: v.clone() for k, v in metrics.items()}
            return state, metrics

        train_step.group = group
        return train_step

    monkeypatch.setattr(mod, "make_train_step", make)


def _half_batch(mod, monkeypatch):
    """Half of the envs left out of the loss, the mean taken over the rest."""
    from actor_critic_tpu_torch.algos.common import Transition

    def half(x):
        return x[:, : x.shape[1] // 2].contiguous()

    if hasattr(mod, "a2c_loss"):
        real = mod.a2c_loss

        def loss(net, traj, advantages, returns, cfg, entropy_coef=None, group=None):
            return real(net, Transition(*map(half, traj)), half(advantages), half(returns), cfg,
                        entropy_coef, group)

        monkeypatch.setattr(mod, "a2c_loss", loss)
    else:
        real = mod.impala_loss

        def loss(net, traj, bootstrap_obs, cfg, can_truncate=True, time_group=None):
            return real(net, Transition(*map(half, traj)), bootstrap_obs[: traj.reward.shape[1] // 2],
                        cfg, can_truncate, time_group)

        monkeypatch.setattr(mod, "impala_loss", loss)


def _altered_answer(mod, monkeypatch):
    """One env's advantages altered where the advantage kernel's seam
    produces them."""
    if hasattr(mod, "rollout_targets"):
        real = mod.rollout_targets

        def targets(*args, **kwargs):
            adv, ret = real(*args, **kwargs)
            adv = adv.clone()
            adv[:, 0] += 1.0
            return adv, ret

        monkeypatch.setattr(mod, "rollout_targets", targets)
    else:
        real = mod.corrected_advantages

        def corrected(*args, **kwargs):
            pg, vs, rho = real(*args, **kwargs)
            pg = pg.clone()
            pg[:, 0] += 1.0
            return pg, vs, rho

        monkeypatch.setattr(mod, "corrected_advantages", corrected)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer],
                         ids=["state_unchanged", "half_batch", "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tiny_root, cell, fault, monkeypatch):
    from actor_critic_tpu_torch import train

    c = catalog.Catalog(tiny_root).cell(cell)
    fault(train.ALGOS[c.conf["algo"]], monkeypatch)
    result, lines = run(tiny_root, cell)
    assert not result["correct"], lines


def _no_refresh(mod, monkeypatch):
    """The actors never refreshed: the step is counted, the copy left out."""
    from actor_critic_tpu_torch.algos.common import advance

    monkeypatch.setattr(mod, "_refresh_actors", lambda cfg, state: advance(state))


def test_actors_left_unrefreshed_are_not_correct(tiny_root, monkeypatch):
    """The check's steps span IMPALA's first actor refresh, so actors that
    are never refreshed fail it, on `actor_gap` at 1."""
    from actor_critic_tpu_torch.algos import impala

    c = catalog.Catalog(tiny_root).cell("impala_pong.tiny")
    assert core.check_iterations(c.conf) == c.conf["config"]["actor_refresh_every"] + 1 == 5
    _no_refresh(impala, monkeypatch)
    result, lines = run(tiny_root, "impala_pong.tiny")
    assert not result["correct"], lines
    assert result["checks"]["actor_gap"]["value"] == pytest.approx(1.0), lines


def test_check_iterations_by_configuration():
    assert core.check_iterations({"config": {"gamma": 0.99}}) == 3
    assert core.check_iterations({"config": {"actor_refresh_every": 1}}) == 3
    assert core.check_iterations({"config": {"actor_refresh_every": 4}}) == 5


def test_gaps_by_hand():
    ref = {"losses": [2.0, 2.0, 2.0], "grad_norms": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "delta_norms": {"a": 0.5, "b": 0.5, "c": 0.3}, "state": {"x": torch.tensor([1.0, 3.0])}}
    prog = {"losses": [2.0, 2.2, 2.0], "grad_norms": {"a": 1.5, "b": 2.0, "c": 0.0},
            "delta_norms": {"a": 0.5, "b": 0.25, "c": 9.0}, "state": {"x": torch.tensor([1.0, 2.0])}}
    g = check.gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(0.1)
    assert g["grad_gap"] == pytest.approx(0.5 / 1.0)   # median leaf 1.0 scales the worst leaf
    assert g["delta_gap"] == pytest.approx(0.5)        # "c" left out: gradient under 1e-3 of median
    assert g["state_gap"] == pytest.approx(0.25)
    prog["losses"][0] = math.nan
    assert check.gaps(prog, ref)["loss_gap"] == math.inf
    ok, checks = check.judge(g, {"loss_gap": 0.2, "grad_gap": 0.4})
    assert not ok and checks["grad_gap"] == {"value": 0.5, "limit": 0.4}
    assert "actor_gap" not in g
    prog["losses"][0] = 2.0
    ref["actor_delta_norms"] = {"a": 0.4, "b": 0.4, "c": 0.1}
    prog["actor_delta_norms"] = {"a": 0.0, "b": 0.4, "c": 5.0}
    assert check.gaps(prog, ref)["actor_gap"] == pytest.approx(1.0)  # "a" never moved


@pytest.mark.card
@pytest.mark.parametrize("cell", ["a2c_cartpole.e4096_t64", "impala_pong.e64_t20",
                                  "impala_pong.e256_t20", "a2c_cartpole.e65536_t64"])
def test_cell_is_correct_on_the_card(card, cell):
    """A short run of each cell through the CLI on the card."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload", cell, "--seed", "12345",
                        "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
                       cwd=root, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"], p.stderr[-3000:]
