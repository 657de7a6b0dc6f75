"""The configurations' FLOP and byte functions against hand counts."""

from __future__ import annotations

from pathlib import Path

import pytest

from chipbench import catalog

ROOT = Path(__file__).resolve().parents[2]


def cell(name):
    return catalog.Catalog(ROOT).cell(name)


def test_nature_cnn_macs_by_hand():
    c = cell("impala_pong.e64_t20")
    convs = 20 * 20 * 32 * (8 * 8 * 2) + 9 * 9 * 64 * (4 * 4 * 32) + 7 * 7 * 64 * (3 * 3 * 64)
    assert convs == 1_638_400 + 2_654_208 + 1_806_336
    assert c.config_mod.forward_macs(c.conf) == convs + 3136 * 512 + 512 * 4 == 7_706_624


def test_mlp_macs_by_hand():
    c = cell("a2c_cartpole.e4096_t64")
    assert c.config_mod.forward_macs(c.conf) == 4 * 64 + 64 * 64 + 64 * 2 + 64 == 4_544


@pytest.mark.parametrize("name, macs", [("a2c_cartpole.e4096_t64", 4_544),
                                        ("impala_pong.e64_t20", 7_706_624)])
def test_model_flops_count_actors_learner_and_backward(name, macs):
    c = cell(name)
    E, T = c.num_envs, c.steps
    # actors T·E, learner T·E + E, backward 2·T·E forwards; 2 FLOPs a MAC
    assert c.config_mod.model_flops(c.conf, E, T) == 2 * macs * (4 * T * E + E)


def test_kernel_bytes_by_hand():
    a2c, pong = cell("a2c_cartpole.e4096_t64"), cell("impala_pong.e64_t20")
    assert a2c.config_mod.kernel_bytes(a2c.conf, "gae", 4096, 64) == 5_259_264
    assert pong.config_mod.kernel_bytes(pong.conf, "vtrace", 64, 20) == 41_216
    assert a2c.config_mod.kernel_bytes(a2c.conf, "vtrace", 4096, 64) is None
    assert pong.config_mod.kernel_bytes(pong.conf, "gae", 64, 20) is None


@pytest.mark.parametrize("name", ["a2c_cartpole.e4096_t64", "impala_pong.e64_t20"])
def test_leaves_are_the_ports_parameters(name):
    """The weights the benchmark draws fill the port's network leaf for leaf."""
    import dataclasses

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.config import PRESETS

    c = cell(name)
    preset = PRESETS[c.conf["preset"]]
    env = train.make_env(c.conf["env"], c.conf["env_kwargs"])
    cfg = dataclasses.replace(preset.config, num_envs=2, rollout_steps=2)
    net = train.ALGOS[c.conf["algo"]].make_network(env, cfg)
    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
    assert shapes == {k: tuple(s) for k, s, _ in c.config_mod.leaves(c.conf)}


def test_device_idle_against_the_untraced_iteration():
    """Idle = 1 − the profiler's busy time a replay over the untraced
    block's iteration time: overlapping operations count once, and the
    profiled block's own (profiler-slowed) window is not the denominator."""
    from chipbench import core

    c = cell("a2c_cartpole.e4096_t64")
    reader = catalog.Catalog(ROOT).reader("device_idle_pct")
    ops = [("k", 0.0, 6_000.0), ("k", 5_000.0, 9_000.0), ("k", 50_000.0, 59_000.0)]  # µs
    run = core.Run(cell=c, setup_s=0.0,
                   plain=core.Block(marks_s=[0.0, 0.010, 0.020], host_replay_s=[0.0, 0.0], failed=0),
                   trace={"device_ops": ops, "iterations": 2, "window_us": (0.0, 80_000.0)})
    assert reader.read(run) == pytest.approx(100.0 * (1.0 - 0.009 / 0.010))
    run.plain = None
    assert reader.read(run) is None
