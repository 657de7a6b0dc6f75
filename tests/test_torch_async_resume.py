"""Checkpoint and resume of the port's async PPO learner
(`ppo.train_host_async` with `ckpt`; tests/test_async_resume.py's three
cases, and tests/test_data_plane.py's device-plane checkpoint):

- the device state (the net, Adam, the generator) restores exactly, and
  the checkpoint holds EVERY actor pool's normalizer stats
  (`host_loop.async_host_ckpt_state`); a resume that finds the run
  complete starts no actor and logs nothing;
- a resumed run goes on from the saved block;
- a resume with another `--async-actors` count is refused with advice;
- the device data plane's checkpoint holds the ring's quantizer stats
  and no ring storage; it resumes, and a resume on the other plane is
  refused with advice.
"""

import sys

import numpy as np
import pytest
import torch

from actor_critic_tpu_torch.algos import host_loop, ppo
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool
from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

pytest.importorskip("gymnasium")


@pytest.fixture(autouse=True)
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


def _tiny_cfg():
    return ppo.PPOConfig(num_envs=4, rollout_steps=8, epochs=1, num_minibatches=1, hidden=(16,))


def _pools():
    # Two actors, seeds strided as train.build_actor_pools strides them.
    return [HostEnvPool("CartPole-v1", 2, seed=0), HostEnvPool("CartPole-v1", 2, seed=100003)]


def _close(pools):
    for p in pools:
        p.close()


def test_async_resume_restores_exact_state(tmp_path):
    cfg = _tiny_cfg()
    pools = _pools()
    try:
        net1, opt1, _ = ppo.train_host_async(pools, cfg, 3, seed=0, log_every=0,
                                             ckpt=Checkpointer(tmp_path / "ck"), save_every=2,
                                             device="cpu")
    finally:
        _close(pools)
    ck = Checkpointer(tmp_path / "ck")
    assert ck.latest_step() == 3
    saved = torch.load(tmp_path / "ck" / "3" / "state.pt", weights_only=True)["tensors"]
    assert sorted(k for k in saved if k.endswith("obs_rms.count")) == [
        "pools.0.obs_rms.count", "pools.1.obs_rms.count"]
    assert not any("storage" in k or "ring_quant" in k for k in saved)
    metrics = ck.restore_metrics(3)
    assert metrics["_async_actors"] == 2.0 and metrics["_data_plane_device"] == 0.0
    # A "new process": fresh pools; the run is complete, so no actor starts,
    # nothing is logged, and the device state is bit-equal.
    pools2 = _pools()
    try:
        net2, opt2, history = ppo.train_host_async(pools2, cfg, 3, seed=0, log_every=0,
                                                   ckpt=ck, resume=True, device="cpu")
        assert history == []
        for p1, p2 in zip(net1.parameters(), net2.parameters()):
            assert torch.equal(p1, p2)
        for k in opt1.mu:
            assert torch.equal(opt1.mu[k], opt2.mu[k]) and torch.equal(opt1.nu[k], opt2.nu[k])
        assert torch.equal(opt1.count, opt2.count)
        # EVERY actor pool's stats came back through set_state, untouched by
        # any collection (no actor ran).
        for i, pool in enumerate(pools2):
            for group in ("obs_rms", "ret_rms"):
                for field in ("mean", "var", "count"):
                    np.testing.assert_array_equal(
                        np.asarray(pool.get_state()[group][field], np.float64),
                        saved[f"pools.{i}.{group}.{field}"].numpy(), err_msg=f"{i} {group}")
            assert float(pool.obs_rms.count) > 10.0
    finally:
        _close(pools2)


def test_async_resume_continues_training(tmp_path):
    cfg = _tiny_cfg()
    pools = _pools()
    try:
        ppo.train_host_async(pools, cfg, 2, seed=0, log_every=0,
                             ckpt=Checkpointer(tmp_path / "ck"), save_every=1, device="cpu")
    finally:
        _close(pools)
    pools2 = _pools()
    try:
        _, _, history = ppo.train_host_async(pools2, cfg, 4, seed=0, log_every=1,
                                             ckpt=Checkpointer(tmp_path / "ck"), save_every=1,
                                             resume=True, device="cpu")
    finally:
        _close(pools2)
    assert Checkpointer(tmp_path / "ck").latest_step() == 4
    # Only blocks 3..4 were consumed (1-based iteration ids).
    assert [it for it, _ in history] == [3, 4]


def test_async_resume_rejects_changed_actor_count(tmp_path):
    cfg = _tiny_cfg()
    pools = _pools()
    try:
        ppo.train_host_async(pools, cfg, 2, seed=0, log_every=0,
                             ckpt=Checkpointer(tmp_path / "ck"), save_every=1, device="cpu")
    finally:
        _close(pools)
    one_pool = [HostEnvPool("CartPole-v1", 4, seed=0)]
    try:
        with pytest.raises(ValueError, match="original --async-actors"):
            ppo.train_host_async(one_pool, cfg, 4, seed=0, log_every=0,
                                 ckpt=Checkpointer(tmp_path / "ck"), resume=True, device="cpu")
    finally:
        _close(one_pool)


def test_async_ppo_device_plane_ckpt_strip_resume(tmp_path):
    """A device-plane run checkpoints the ring's quantizer stats and no ring
    storage, resumes with them installed, and refuses a data-plane flip."""
    cfg = ppo.PPOConfig(num_envs=2, rollout_steps=4, epochs=1, num_minibatches=1, hidden=(8,))
    ckpt_dir = tmp_path / "ck"
    installed = []

    def run(iters, resume, plane="device"):
        pool = HostEnvPool("CartPole-v1", 2, seed=0)
        try:
            return ppo.train_host_async([pool], cfg, iters, seed=0, log_every=1,
                                        correction="vtrace", data_plane=plane,
                                        plane_codec="int8", ckpt=Checkpointer(ckpt_dir),
                                        save_every=2, resume=resume, device="cpu",
                                        iteration_hook=lambda it, r: installed.append(
                                            r.queue.quant_host()))
        finally:
            pool.close()

    run(2, resume=False)
    saved = torch.load(ckpt_dir / "2" / "state.pt", weights_only=True)["tensors"]
    quant = {k: v for k, v in saved.items() if ".ring_quant." in k}
    assert "device_state.ring_quant.obs.scale" in quant
    assert float(quant["device_state.ring_quant.obs.scale"]) > 1e-6
    assert not any("storage" in k for k in saved)
    saved_obs = {k: quant[f"device_state.ring_quant.obs.{k}"].numpy() for k in ("mean", "scale")}
    installed.clear()
    # The resume goes on from block 2, its ring encoding with the saved stats.
    _, _, hist = run(4, resume=True)
    assert [it for it, _ in hist] == [3, 4]
    first = installed[0]["obs"]
    assert int(first["count"]) >= int(quant["device_state.ring_quant.obs.count"])
    assert float(first["scale"]) >= float(saved_obs["scale"])
    # A host-plane resume of a device-plane checkpoint fails with advice.
    with pytest.raises(ValueError, match="data-plane"):
        run(6, resume=True, plane="host")


def test_async_checkpoint_state_round_trip(tmp_path):
    """`async_host_ckpt_state` through a Checkpointer: every pool's stats and
    the ring's stats come back exactly."""
    pools = _pools()
    try:
        for p in pools:
            p.reset()
            p.step(np.zeros(2, np.int64))
        gen = torch.Generator().manual_seed(3)
        quant = {"obs": {"mean": np.float32(0.5), "scale": np.float32(2.0),
                         "count": np.int32(7)}}
        state = host_loop.async_host_ckpt_state(
            pools, gen, x=torch.arange(3.0), ring_quant=host_loop.ring_quant_tensors(quant))
        ck = Checkpointer(tmp_path / "ck")
        host_loop.async_host_maybe_save(ck, 1, 1, 1, pools, {"loss": 0.5}, gen, "device",
                                        x=state.device_state["x"],
                                        ring_quant=state.device_state["ring_quant"])
        fresh = [HostEnvPool("CartPole-v1", 2, seed=0), HostEnvPool("CartPole-v1", 2, seed=7)]
        tmpl = host_loop.async_host_ckpt_state(
            fresh, torch.Generator(), x=torch.zeros(3),
            ring_quant=host_loop.ring_quant_tensors(
                {"obs": {"mean": np.float32(0), "scale": np.float32(0), "count": np.int32(0)}}))
        restored, step = host_loop.async_host_resume(ck, tmpl, fresh, "device")
        assert step == 1 and restored is tmpl
        assert torch.equal(tmpl.device_state["x"], torch.arange(3.0))
        tree = host_loop.ring_quant_tree(tmpl.device_state["ring_quant"])
        assert {k: float(v) for k, v in tree["obs"].items()} == {"mean": 0.5, "scale": 2.0,
                                                                  "count": 7.0}
        for src, dst in zip(pools, fresh):
            a, b = src.get_state(), dst.get_state()
            for group in ("obs_rms", "ret_rms"):
                for field in ("mean", "var", "count"):
                    np.testing.assert_array_equal(np.asarray(a[group][field]),
                                                  np.asarray(b[group][field]))
        _close(fresh)
    finally:
        _close(pools)
