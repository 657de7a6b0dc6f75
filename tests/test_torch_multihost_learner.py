"""The multi-process actor-learner's pieces and runs
(`parallel/multihost.py`, `parallel/launch.py`, `train.py --distributed`)
on the CPU, against the JAX package's (tests/test_multihost_learner.py,
tests/test_multihost.py):

- the mailbox: latest wins and take once, the frozen snapshot, the file
  round trip in the port's parameter order, garbage, truncated and empty
  files read as None, a non-finite publish refused with the previous
  snapshot kept; the mailbox thread deposits the ring-scheduled peer;
- `gossip_peer`'s rotation and its refusal of a singleton fleet;
  `mix_params` convex, dtype-preserving, in place (the same `data_ptr`, as
  a captured graph needs) and bitwise JAX's numpy mix;
- `FleetMonitor`, `merge_host_traces`;
- two-process runs through `python -m
  actor_critic_tpu_torch.parallel.launch` (gloo): the `--smoke` sync run,
  whose version and fingerprint agree at every iteration and whose ranks
  end equal, and a gossip run that mixes with no barrier, where a
  straggler does not stall the other rank;
- the CLI: `train.main --distributed --gossip --num-processes 1`, a
  gossip rank that joins no process group though given a `--coordinator`,
  `--coordinator` at world 1 (gloo), the `host<rank>` paths, the rank's
  seed stride, and each of JAX's `--distributed` refusals with JAX's words.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from actor_critic_tpu.parallel import multihost as jmultihost
from actor_critic_tpu_torch import train
from actor_critic_tpu_torch.parallel import launch, multihost

HOST_TINY = ["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", "--set", "num_envs=4",
             "--set", "rollout_steps=8", "--set", "epochs=1", "--set", "num_minibatches=2",
             "--device", "cpu", "--quiet"]


@pytest.fixture
def cpu_learner():
    """One intra-op thread and a 0.1 ms GIL switch interval, as the async
    tests run the learner beside its actor threads."""
    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-4)
    yield
    sys.setswitchinterval(interval)
    torch.set_num_threads(threads)


# ------------------------------------------------------------ ParamMailbox


def test_mailbox_latest_wins_and_take_once():
    mb = multihost.ParamMailbox()
    assert mb.take() is None and mb.peek() is None
    mb.deposit({"w": np.ones(2, np.float32)}, version=1, peer=2)
    mb.deposit({"w": np.full(2, 2.0, np.float32)}, version=3, peer=1)
    version, peer, params = mb.take()
    assert (version, peer) == (3, 1) and float(params["w"][0]) == 2.0
    assert mb.take() is None
    assert mb.peek()[0] == 3
    # The same peer going backwards is dropped; another peer's lower
    # version (a slower host's clock) still lands.
    assert not mb.deposit({"w": np.zeros(2, np.float32)}, version=1, peer=1)
    assert mb.take() is None
    assert mb.deposit({"w": np.full(2, 5.0, np.float32)}, version=2, peer=0)
    version, peer, params = mb.take()
    assert (version, peer) == (2, 0) and float(params["w"][0]) == 5.0
    assert mb.stats()["deposits"] == 3


def test_mailbox_frozen_snapshot_contract():
    mb = multihost.ParamMailbox()
    tree = {"w": np.ones(2, np.float32)}
    mb.deposit(tree, version=1, peer=0)
    tree["w"][0] = 9.0
    _, _, stored = mb.take()
    assert float(stored["w"][0]) == 1.0
    with pytest.raises(ValueError, match="read-only"):
        stored["w"][0] = 3.0


# -------------------------------------------------------- gossip ring + mix


def test_gossip_peer_rotates_through_whole_fleet():
    for world in (2, 3, 4, 8):
        for rank in range(world):
            peers = {multihost.gossip_peer(rank, world, r) for r in range(world - 1)}
            assert peers == set(range(world)) - {rank}, (rank, world)
            assert [multihost.gossip_peer(rank, world, r) for r in range(2 * world)] == [
                jmultihost.gossip_peer(rank, world, r) for r in range(2 * world)]


def test_gossip_peer_rejects_singleton_fleet():
    with pytest.raises(ValueError, match="at least 2"):
        multihost.gossip_peer(0, 1, 0)


def test_mix_params_convex_dtype_preserving_in_place():
    own = {"w": torch.full((2,), 2.0), "b": torch.zeros(1)}
    ptrs = {k: t.data_ptr() for k, t in own.items()}
    peer = {"w": np.full((2,), 4.0, np.float32), "b": np.ones((1,), np.float32)}
    out = multihost.mix_params(own, peer, 0.25)
    assert out is own and {k: t.data_ptr() for k, t in own.items()} == ptrs
    np.testing.assert_allclose(own["w"].numpy(), 2.5)
    np.testing.assert_allclose(own["b"].numpy(), 0.25)
    assert own["w"].dtype == torch.float32
    for w, want in ((0.0, 2.5), (1.0, 4.0)):
        multihost.mix_params(own, peer, w)
        np.testing.assert_allclose(own["w"].numpy(), want)
    # Bitwise JAX's numpy mix on random leaves, a list of tensors this time.
    rng = np.random.default_rng(0)
    a = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    b = [rng.normal(size=v.shape).astype(np.float32) for v in a]
    want = jmultihost.mix_params(a, b, 0.3)
    tensors = [torch.from_numpy(v.copy()) for v in a]
    multihost.mix_params(tensors, b, 0.3)
    for t, v in zip(tensors, want):
        assert np.array_equal(t.numpy(), v)


# ----------------------------------------------------- filesystem transport


def test_write_read_params_roundtrip(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    names = multihost.param_names(net)
    leaves = multihost.param_leaves(net)
    multihost.write_params(str(tmp_path), 3, 11, leaves)
    version, named = multihost.read_params(str(tmp_path), 3, names)
    assert version == 11 and list(named) == names
    for (name, p), got in zip(net.named_parameters(), named.values()):
        np.testing.assert_array_equal(got, p.detach().numpy())
    assert multihost.read_params(str(tmp_path), 9, names) is None
    multihost.write_params(str(tmp_path), 3, 12, dict(zip(names, leaves)))
    assert multihost.read_version(str(tmp_path), 3) == 12
    assert [p.name for p in (tmp_path / "host3").iterdir()] == ["params.npz"]
    # JAX's reader takes the same file as a list of leaves.
    jversion, jleaves = jmultihost.read_params(str(tmp_path), 3, list(leaves))
    assert jversion == 12 and all(np.array_equal(a, b) for a, b in zip(jleaves, leaves))
    with pytest.raises(ValueError, match="holds 4 leaves, the template names 2"):
        multihost.read_params(str(tmp_path), 3, names[:2])


@pytest.mark.parametrize("content", [b"definitely not an npz", b"", "truncated"])
def test_read_params_tolerates_torn_files(tmp_path, content):
    if content == "truncated":
        multihost.write_params(str(tmp_path), 0, 1, [np.ones(64, np.float32)])
        path = multihost.params_file(str(tmp_path), 0)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    else:
        path = multihost.params_file(str(tmp_path), 0)
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as f:
            f.write(content)
    assert multihost.read_params(str(tmp_path), 0, ["w"]) is None
    assert multihost.read_version(str(tmp_path), 0) is None


def test_non_finite_publish_is_refused_and_the_last_snapshot_stays(tmp_path):
    from actor_critic_tpu_torch.utils.numguard import NonFiniteError

    multihost.write_params(str(tmp_path), 0, 1, [np.ones(3, np.float32)])
    with pytest.raises(NonFiniteError, match="mailbox publish"):
        multihost.write_params(str(tmp_path), 0, 2, [np.array([1.0, np.nan, 0], np.float32)])
    assert multihost.read_version(str(tmp_path), 0) == 1


def test_file_mailbox_writer_deposits_scheduled_peer(tmp_path):
    names = ["w"]
    multihost.write_params(str(tmp_path), 1, 5, [np.full((2,), 1.0, np.float32)])
    multihost.write_params(str(tmp_path), 2, 9, [np.full((2,), 2.0, np.float32)])
    mailbox = multihost.ParamMailbox()
    stop = threading.Event()
    writer = multihost.FileMailboxWriter(str(tmp_path), 0, 3, template=names, mailbox=mailbox,
                                         stop=stop, poll_s=0.01).start()
    try:
        deadline = time.monotonic() + 5.0
        out = None
        while out is None and time.monotonic() < deadline:
            out = mailbox.take()
            time.sleep(0.01)
        assert out is not None, "writer never deposited"
        assert (out[0], out[1]) == (5, 1) and float(out[2]["w"][0]) == 1.0
        writer.set_round(1)  # the ring moves to peer 2
        out = None
        while out is None and time.monotonic() < deadline:
            out = mailbox.take()
            time.sleep(0.01)
        assert out is not None and (out[0], out[1]) == (9, 2)
    finally:
        stop.set()
        writer.join(timeout=5.0)
    assert writer.error is None


def test_fleet_monitor_reports_stale_and_fresh_peers(tmp_path):
    monitor = multihost.FleetMonitor(str(tmp_path), rank=0, world=3, stale_after_s=60.0)
    snap = monitor.snapshot()
    assert not snap["ok"] and snap["stale"] == [1, 2]
    multihost.write_params(str(tmp_path), 1, 4, [np.ones(1, np.float32)])
    multihost.write_params(str(tmp_path), 2, 6, [np.ones(1, np.float32)])
    snap = monitor.snapshot()
    assert snap["ok"] and snap["peers"]["1"]["version"] == 4 and snap["peers"]["2"]["published"]
    old = time.time() - 120
    os.utime(multihost.params_file(str(tmp_path), 2), (old, old))
    snap = monitor.snapshot()
    assert snap["stale"] == [2] and not snap["ok"]
    jsnap = jmultihost.FleetMonitor(str(tmp_path), 0, 3, stale_after_s=60.0).snapshot()
    assert jsnap["stale"] == snap["stale"] and sorted(jsnap) == sorted(snap)


def test_merge_host_traces_aligns_clocks(tmp_path):
    for rank, epoch0 in ((0, 100.0), (1, 102.5)):
        host_dir = tmp_path / f"host{rank}"
        host_dir.mkdir()
        events = [
            {"name": "process_name", "ph": "M", "pid": 1000 + rank, "tid": 0,
             "args": {"name": f"host{rank}"}},
            {"name": "clock_sync", "ph": "M", "pid": 1000 + rank, "tid": 0,
             "args": {"unix_epoch_at_ts0": epoch0}},
            {"name": "iteration", "ph": "X", "ts": 10.0, "dur": 5.0, "pid": 1000 + rank,
             "tid": 1, "cat": "phase"},
        ]
        (host_dir / "spans.jsonl").write_text("\n".join(json.dumps(e) for e in events) + "\n")
    out = launch.merge_host_traces(str(tmp_path), 2)
    merged = [json.loads(ln) for ln in open(out)]
    spans = {e["pid"]: e for e in merged if e.get("ph") == "X"}
    assert spans[1000]["ts"] == 10.0
    assert spans[1001]["ts"] == pytest.approx(10.0 + 2.5e6)
    names = {e["pid"]: e["args"]["name"] for e in merged if e.get("name") == "process_name"}
    assert names == {1000: "host0", 1001: "host1"}


# ------------------------------------------------- multi-process clusters


def _rows(record):
    return [row for rank in record["ranks"] for row in rank["rows"]]


def test_two_process_sync_smoke_is_consistent_every_iteration(capsys):
    """`python -m actor_critic_tpu_torch.parallel.launch --smoke`: two gloo
    ranks whose version and fingerprint agree at every block, and whose
    ranks end equal; exit 0."""
    assert launch.main(["--smoke", "--iterations", "4"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ok"] and rec["smoke"] == "multihost_sync_2proc"
    assert rec["version_consistent"] and rec["fingerprint_consistent"], rec
    assert rec["consumed_env_steps"] == 2 * 4 * 8 * 2
    for r in rec["ranks"]:
        assert [row["iter"] for row in r["rows"]] == [1, 2, 3, 4]
        for row in r["rows"]:
            assert row["fingerprint_ok"] and row["version_ok"]
            assert row["version_sum"] == 2 * row["iter"]
    # One optimizer step on every rank: their final losses agree exactly.
    assert rec["ranks"][0]["last_loss"] == rec["ranks"][1]["last_loss"]
    with pytest.raises(SystemExit, match="not ported yet"):
        launch.main(["--bench"])


def test_two_process_gossip_run_mixes_without_barrier():
    """Rank 0's envs are padded 30 ms more a step (over 240 ms a block):
    both ranks mix, no row carries a collective's check, and rank 1
    consumes its blocks at its own pace, in less time than rank 0's
    collection alone takes, its learner hardly waiting on its queue (a
    straggler does not stall the fleet)."""
    pad = 0.03
    rec = launch.run_cluster(2, "gossip", iterations=5, rollout_steps=8, num_envs=1, actors=1,
                             sleep_s=0.002, straggler_rank=0, straggler_extra_s=pad,
                             device="cpu", timeout_s=120.0, extra_args=("--log-every", "1"))
    assert rec["consumed_env_steps"] == 2 * 5 * 8 * 1
    slow, fast = rec["ranks"]
    for r in rec["ranks"]:
        assert r["gossip_mixes"] + r["gossip_skips"] == 5
    # The slow rank mixes the fast one's snapshots (JAX's check is the
    # fleet's total); the fast rank may finish before the slow one's
    # process has published anything.
    assert rec["gossip_mixes"] > 0 and slow["gossip_mixes"] > 0, rec
    rows = _rows(rec)
    assert not any("version_sum" in row for row in rows)  # no collective, no barrier
    assert any("gossip_lag" in row for row in rows)
    assert fast["consumed_blocks"] == slow["consumed_blocks"] == 5
    assert slow["wall_s"] >= 5 * 8 * pad
    assert fast["wall_s"] < 5 * 8 * pad, rec
    assert fast["learner_idle_s"] < slow["learner_idle_s"], rec


# ------------------------------------------------------------------- CLI


def _cli(argv, capsys):
    assert train.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    return json.loads(lines[-1]), lines


def test_cli_gossip_single_process(tmp_path, capsys, cpu_learner):
    """A fleet of one, and the warm-up plan JAX's `plan_warmup` gives for the
    same flags (every rank plans alike, so their captures and collectives
    match)."""
    from actor_critic_tpu import config as jax_config
    from actor_critic_tpu.envs.jax_env import EnvSpec as JaxSpec
    from actor_critic_tpu.utils import compile_cache as jax_cc

    metrics = tmp_path / "m.jsonl"
    summary, lines = _cli(HOST_TINY + ["--async-actors", "2", "--iterations", "2",
                                       "--distributed", "--gossip", "--metrics", str(metrics)],
                          capsys)
    assert summary["multihost_consumed_blocks"] == 2 and summary["multihost_world"] == 1
    assert summary["multihost_gossip_mixes"] == 0  # a fleet of one has no peer
    rows = [json.loads(x) for x in open(tmp_path / "m.host0.jsonl")]
    assert [r["iter"] for r in rows] == [1, 2] and not metrics.exists()
    plan = next(x for x in lines if x.startswith("warmup: ")).rpartition(": ")[2].split(", ")
    jcfg = jax_config.resolve("ppo_halfcheetah", None, "native:Pendulum-v1", {}).config
    want = jax_cc.plan_warmup(jax_cc.WarmupContext(
        algo="ppo", fused=False, spec=JaxSpec((3,), 1, False), cfg=jcfg, iterations=2,
        async_actors=2, async_correction="vtrace", data_plane="host", queue_depth=4))
    assert plan == [name for name, _ in want] == ["ppo.make_async_update_step"]


def test_cli_sync_world_one_over_gloo(tmp_path, capsys, cpu_learner):
    import torch.distributed as dist

    tel = tmp_path / "tel"
    summary, _ = _cli(HOST_TINY + [
        "--async-actors", "2", "--iterations", "3", "--log-every", "1", "--distributed",
        "--coordinator", f"127.0.0.1:{launch.free_port()}", "--metrics", str(tmp_path / "m.jsonl"),
        "--telemetry-dir", str(tel)], capsys)
    assert not dist.is_initialized()  # the CLI leaves no process group behind
    assert summary["multihost_world"] == 1 and summary["multihost_check_ms"] > 0
    assert summary["multihost_version_consistent"] and summary["multihost_fingerprint_consistent"]
    rows = [json.loads(x) for x in open(tmp_path / "m.host0.jsonl")]
    assert [r["version_sum"] for r in rows] == [1.0, 2.0, 3.0]
    assert all(r["fingerprint_ok"] for r in rows)
    spans = [json.loads(x) for x in open(tel / "host0" / "spans.jsonl")]
    assert any(e.get("name") == "process_name" and e["args"]["name"] == "host0" for e in spans)


def test_cli_gossip_rank_joins_no_process_group(tmp_path, capsys, cpu_learner, monkeypatch):
    """A gossip rank never enters a collective: with a `--coordinator` on
    the command line it still joins no process group (so ranks may share
    one card), and its rank is `--process-id`. Alone at world 2 its peer
    has published nothing, so every exchange is a skip."""
    import torch.distributed as dist

    def no_group(*args, **kwargs):
        raise AssertionError("a gossip rank joined a process group")

    monkeypatch.setattr(multihost, "distributed_init", no_group)
    summary, _ = _cli(HOST_TINY + [
        "--async-actors", "2", "--iterations", "2", "--distributed", "--gossip",
        "--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "1",
        "--mailbox-dir", str(tmp_path / "mailbox"), "--metrics", str(tmp_path / "m.jsonl")],
        capsys)
    assert not dist.is_initialized()
    assert summary["multihost_rank"] == 1 and summary["multihost_world"] == 2
    assert summary["multihost_gossip_mixes"] == 0 and summary["multihost_gossip_skips"] == 2
    rows = [json.loads(x) for x in open(tmp_path / "m.host1.jsonl")]
    assert [r["iter"] for r in rows] == [1, 2]


def test_rank_seed_stride_and_paths():
    import argparse
    import dataclasses

    from actor_critic_tpu_torch.config import PRESETS

    preset = dataclasses.replace(PRESETS["ppo_halfcheetah"], env="native:Pendulum-v1")
    pools = {}
    for rank in (0, 1):
        args = argparse.Namespace(seed=3, scale_actions=None, distributed=True, process_id=rank)
        made = train.build_actor_pools(preset, args, 2)
        first = [p.reset()[0].copy() for p in made]
        for p in made:
            p.close()
        pools[rank] = first
    # Rank 1's fleet starts from other seeds than rank 0's.
    assert not any(np.array_equal(a, b) for a in pools[0] for b in pools[1])
    args = argparse.Namespace(process_id=2, telemetry_dir="/x/tel", metrics="runs/m.jsonl")
    train.rank_paths(args)
    assert args.telemetry_dir == os.path.join("/x/tel", "host2")
    assert args.metrics == "runs/m.host2.jsonl"


REFUSALS = [
    (["--distributed"], "--async-actors N"),
    (["--distributed", "--async-actors", "2", "--algo", "sac"], "PPO multi-host learner"),
    (["--distributed", "--async-actors", "2"], "needs --coordinator"),
    (["--distributed", "--async-actors", "2", "--coordinator", "127.0.0.1:1",
      "--async-correction", "none"], "--async-correction none is not supported"),
    (["--distributed", "--async-actors", "2", "--gossip", "--num-processes", "2"],
     "needs a shared --mailbox-dir"),
]


@pytest.mark.parametrize("extra,match", REFUSALS)
def test_distributed_refusals_are_jax_words(extra, match):
    """Each of JAX's `--distributed` refusals, before any env, device or
    rendezvous work, with the JAX CLI's own message."""
    import train as jtrain  # the JAX package's CLI, at the repository root

    argv = ["--preset", "ppo_halfcheetah", "--env", "native:Pendulum-v1", *extra]
    if "--algo" in extra:
        argv = ["--env", "native:Pendulum-v1", *extra]
    with pytest.raises(SystemExit, match=match) as port_exit:
        train.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        jtrain.main(argv)
    assert str(port_exit.value) == str(jax_exit.value)


def test_distributed_refuses_checkpoints_and_the_sidecar():
    with pytest.raises(SystemExit, match="--distributed runs don't support"):
        train.main(HOST_TINY + ["--async-actors", "2", "--distributed", "--gossip",
                                "--ckpt-dir", "/tmp/x"])
    with pytest.raises(SystemExit, match="serve_fleet"):
        train.main(HOST_TINY + ["--async-actors", "2", "--distributed", "--gossip",
                                "--serve-port", "0"])
