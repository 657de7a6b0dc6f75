"""Local multi-process launcher of the multi-process actor-learner
(counterpart of the JAX package's `scripts/launch_multihost.py`).

Spawns N worker processes, one learner each (`multihost.train_multihost`),
against a localhost coordinator in sync mode (the all-reduce learner) or
with a shared temporary mailbox in gossip mode, drains every worker's
pipes at once, and prints one JSON line with the fleet's record.

    python -m actor_critic_tpu_torch.parallel.launch --processes 2 --device cpu   # sync
    python -m actor_critic_tpu_torch.parallel.launch --processes 2 --mode gossip --device cpu
    python -m actor_critic_tpu_torch.parallel.launch --processes 2 --mode gossip \\
        --straggler-rank 0 --device cpu                      # a slow rank
    python -m actor_critic_tpu_torch.parallel.launch --smoke # 2-process sync check, CPU
    python -m actor_critic_tpu_torch.parallel.launch --processes 2 --mode gossip \\
        --preset ppo_halfcheetah --env native:Pendulum-v1 --num-envs 8 --actors 2 \\
        --rollout-steps 256 --epochs 2 --minibatches 32 --async-correction none   # the card

By default a worker trains a small PPO on the sleep-padded CartPole
(`envs/sleep_pad.py`, which needs gymnasium): real dynamics under a
simulator-shaped wall cost. `--preset NAME` takes that preset's config
(with `--epochs`/`--minibatches` where given), `--env` any host or native
pool. Sync mode on the card is NCCL's and needs one card a rank; gossip
ranks share the card. `--straggler-rank R` pads rank R's envs further
(sleep-pad envs): a sync fleet waits for it at the all-reduce, a gossip
fleet only loses R's own blocks.

Exit codes: 0 ok; 1 a worker failed or a consistency check tripped.
JAX's `--bench` grid belongs to the port's benchmark, not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# worker (one a process)
# ---------------------------------------------------------------------------


def worker_config(args):
    """The learner's config: the preset's (with the given epochs and
    minibatches) or the small sleep-pad one, at `--num-envs` envs a
    process and `--rollout-steps`."""
    import dataclasses

    from actor_critic_tpu_torch.algos import ppo

    if args.preset:
        from actor_critic_tpu_torch.config import PRESETS

        cfg = PRESETS[args.preset].config
        over = {"num_envs": args.num_envs, "rollout_steps": args.rollout_steps}
        if args.epochs is not None:
            over["epochs"] = args.epochs
        if args.minibatches is not None:
            over["num_minibatches"] = args.minibatches
        return dataclasses.replace(cfg, **over)
    return ppo.PPOConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                         epochs=args.epochs or 2, num_minibatches=args.minibatches or 2,
                         lr=args.lr, hidden=(32,), entropy_coef=0.001)


def worker_pools(args, cfg):
    """One pool an actor, seeds strided by (rank·A + i)·100003 as the
    training CLI strides them."""
    from actor_critic_tpu_torch.envs.host_pool import HostEnvPool

    E_a = cfg.num_envs // args.actors
    seeds = [args.seed + (args.rank * args.actors + i) * 100_003 for i in range(args.actors)]
    if args.env:
        import dataclasses

        from actor_critic_tpu_torch import train

        sub = dataclasses.replace(cfg, num_envs=E_a)
        return [train.make_host_pool(args.env, "ppo", sub, s) for s in seeds]
    from actor_critic_tpu_torch.envs.sleep_pad import QUALIFIED_CARTPOLE_ID

    sleep_s = args.sleep_s + (args.straggler_extra_s if args.rank == args.straggler_rank else 0.0)
    return [HostEnvPool(QUALIFIED_CARTPOLE_ID, E_a, seed=s, env_kwargs={"sleep_s": sleep_s})
            for s in seeds]


def run_worker(args) -> int:
    import torch

    from actor_critic_tpu_torch import resolve_device, telemetry
    from actor_critic_tpu_torch.parallel import multihost

    device = torch.device(args.device)
    if args.mode == "sync":
        device = multihost.distributed_init(f"127.0.0.1:{args.port}", args.processes,
                                            args.rank, args.device)
    else:
        device = resolve_device(device)
    if device.type == "cpu":
        # The learner's ops beside the actor threads: one intra-op thread
        # (the training CLI's setting for async runs on the CPU), and a
        # 0.1 ms GIL switch interval: at the default 5 ms each learner op
        # and each gloo collective waits up to that long for an actor's
        # numpy loop to let go of the GIL.
        torch.set_num_threads(1)
        sys.setswitchinterval(1e-4)
    session = None
    if args.telemetry_dir:
        session = telemetry.TelemetrySession(
            os.path.join(args.telemetry_dir, f"host{args.rank}"),
            run_info={"multihost_rank": args.rank, "mode": args.mode, "seed": args.seed},
            serve_port=0)
        telemetry.set_current(session)
        multihost.host_lane(args.rank)
        if args.mailbox_dir:
            from actor_critic_tpu_torch.telemetry import fleet

            fleet.announce_endpoint(args.mailbox_dir, args.rank,
                                    f"http://127.0.0.1:{session.exporter_port}")
    cfg = worker_config(args)
    pools = worker_pools(args, cfg)
    launch_counts = None
    if device.type == "cuda":
        from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

        launch_counts = (gae_cuda, vtrace_cuda)
        for k in launch_counts:
            k.reset_launch_count()
    try:
        _, history, summary = multihost.train_multihost(
            pools, cfg, args.iterations if args.duration_s <= 0 else 1_000_000,
            duration_s=args.duration_s if args.duration_s > 0 else None,
            rank=args.rank, world=args.processes, mode=args.mode, seed=args.seed,
            log_every=args.log_every, queue_depth=args.queue_depth,
            max_staleness=args.max_staleness, correction=args.async_correction,
            gossip=multihost.GossipConfig(every=args.gossip_every, weight=args.gossip_weight),
            mailbox_dir=args.mailbox_dir or None, device=device)
        if launch_counts is not None:
            summary["launches"] = {"gae": launch_counts[0].launch_count(),
                                   "vtrace": launch_counts[1].launch_count()}
        summary["rows"] = [dict(m, iter=i) for i, m in history]
        last = history[-1][1] if history else {}
        summary["last_loss"] = last.get("loss")
        print(json.dumps(summary), flush=True)
        return 0
    finally:
        for p in pools:
            p.close()
        if session is not None:
            session.close()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parent: spawn a fleet, gather its record
# ---------------------------------------------------------------------------


def worker_env() -> dict:
    """The children's environment: this package importable from the
    checkout's root."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
    return env


def run_cluster(
    processes: int,
    mode: str,
    *,
    device: str,
    iterations: int = 30,
    duration_s: float = 0.0,
    rollout_steps: int = 16,
    num_envs: int = 4,
    actors: int = 1,
    sleep_s: float = 0.002,
    straggler_rank: int = -1,
    straggler_extra_s: float = 0.0,
    gossip_every: int = 1,
    gossip_weight: float = 0.5,
    seed: int = 0,
    telemetry_dir: str = "",
    mailbox_dir: str = "",
    timeout_s: float = 600.0,
    extra_args: tuple = (),
) -> dict:
    """One N-process local run on `device` ("cuda" or "cpu", always named:
    a fleet never lands on the CPU and gloo unasked); returns the fleet's
    record (raises when a worker fails or outlasts `timeout_s`).
    `mailbox_dir` keeps the gossip mailbox (a temporary one, removed after,
    by default)."""
    port = free_port()
    env = worker_env()
    with tempfile.TemporaryDirectory(prefix="mh_mailbox_") as tmp_mailbox:
        mailbox = mailbox_dir or tmp_mailbox
        cmd_base = [
            sys.executable, "-m", "actor_critic_tpu_torch.parallel.launch", "--worker",
            "--processes", str(processes), "--mode", mode, "--port", str(port),
            "--mailbox-dir", mailbox, "--iterations", str(iterations),
            "--duration-s", str(duration_s), "--rollout-steps", str(rollout_steps),
            "--num-envs", str(num_envs), "--actors", str(actors), "--sleep-s", str(sleep_s),
            "--straggler-rank", str(straggler_rank),
            "--straggler-extra-s", str(straggler_extra_s),
            "--gossip-every", str(gossip_every), "--gossip-weight", str(gossip_weight),
            "--seed", str(seed), "--telemetry-dir", telemetry_dir, "--device", device,
            *extra_args,
        ]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd_base + ["--rank", str(rank)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
                 for rank in range(processes)]
        # Drain every worker at once: with communicate() in turn, a later rank
        # filling its stderr pipe would block before its next collective and
        # stall the fleet until the timeout.
        outs: list = [None] * processes

        def drain(i: int, p) -> None:
            try:
                out, err = p.communicate(timeout=timeout_s)
                outs[i] = (p.returncode, out, err)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                outs[i] = (None, out, err)

        threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
                   for i, p in enumerate(procs)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=timeout_s + 30)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    summaries = []
    for rank, entry in enumerate(outs):
        if entry is None:
            raise RuntimeError(f"worker {rank} never finished draining")
        rc, out, err = entry
        if rc is None:
            tail = (err or out or "").strip().splitlines()
            raise RuntimeError(f"worker {rank} exceeded {timeout_s:.0f}s and was killed: "
                               + ("\n".join(tail[-8:]) if tail else "no output"))
        line = next((ln for ln in reversed(out.strip().splitlines()) if ln.startswith("{")),
                    None)
        if rc != 0 or line is None:
            tail = (err or out).strip().splitlines()
            raise RuntimeError(f"worker {rank} failed rc={rc}: "
                               + ("\n".join(tail[-12:]) if tail else "no output"))
        summaries.append(json.loads(line))
    total = sum(s["consumed_env_steps"] for s in summaries)
    slowest = max(s["wall_s"] for s in summaries)
    record = {
        "processes": processes,
        "mode": mode,
        "device": device,
        "aggregate_steps_per_s": round(total / slowest, 1) if slowest else 0.0,
        "consumed_env_steps": total,
        "fleet_wall_s": round(slowest, 2),
        "launcher_wall_s": round(wall, 2),
        "version_consistent": all(s.get("version_consistent", True) for s in summaries),
        "fingerprint_consistent": all(s.get("fingerprint_consistent", True) for s in summaries),
        "per_rank_steps_per_s": [s["consumed_steps_per_s"] for s in summaries],
        "gossip_mixes": sum(s.get("gossip_mixes", 0) for s in summaries),
        "gossip_lag_max": max((s.get("gossip_lag_max", 0) for s in summaries), default=0),
        "ranks": summaries,
    }
    if straggler_rank >= 0:
        record["straggler"] = {"rank": straggler_rank, "extra_s": straggler_extra_s}
    if telemetry_dir:
        merged = merge_host_traces(telemetry_dir, processes)
        if merged:
            record["trace"] = merged
    return record


def merge_host_traces(telemetry_dir: str, processes: int) -> str:
    """Merge the ranks' `host<rank>/spans.jsonl` into one Chrome-trace JSONL
    (`<telemetry-dir>/fleet_spans.jsonl`): each rank keeps its pid lane
    (named `host<rank>` by `multihost.host_lane`), and its timestamps are
    shifted onto one axis by the `clock_sync` metadata its tracer wrote
    (each tracer's ts starts at 0; the unix epoch at ts 0 is the shared
    clock)."""
    hosts = []
    for rank in range(processes):
        path = os.path.join(telemetry_dir, f"host{rank}", "spans.jsonl")
        if not os.path.exists(path):
            continue
        events = []
        epoch0 = None
        with open(path) as f:
            for ln in f:
                try:
                    evt = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if evt.get("name") == "clock_sync":
                    epoch0 = evt.get("args", {}).get("unix_epoch_at_ts0")
                events.append(evt)
        if epoch0 is not None:
            hosts.append((epoch0, events))
    if not hosts:
        return ""
    base = min(e for e, _ in hosts)
    out_path = os.path.join(telemetry_dir, "fleet_spans.jsonl")
    with open(out_path, "w") as f:
        for epoch0, events in hosts:
            shift_us = (epoch0 - base) * 1e6
            for evt in events:
                if "ts" in evt:
                    evt = dict(evt, ts=round(evt["ts"] + shift_us, 1))
                f.write(json.dumps(evt) + "\n")
    return out_path


def run_smoke(args) -> int:
    """The 2-process sync check on the CPU (gloo): the fleet comes up on
    localhost, trains a few blocks, and every iteration's all-reduced
    version counter and parameter fingerprint agree exactly (each rank's
    row of every block is in the record)."""
    rec = run_cluster(2, "sync", iterations=args.iterations or 5, rollout_steps=8, num_envs=2,
                      actors=1, sleep_s=0.0, seed=args.seed, device="cpu",
                      timeout_s=args.run_timeout, extra_args=("--log-every", "1"))
    ok = rec["version_consistent"] and rec["fingerprint_consistent"]
    print(json.dumps({"smoke": "multihost_sync_2proc", "ok": ok, **rec}))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--processes", type=int, default=2,
                   help="fleet size (local processes, one learner each)")
    p.add_argument("--mode", choices=("sync", "gossip"), default="sync",
                   help="sync = the all-reduce learner (a straggler stalls the fleet); gossip = "
                   "independent learners mixing parameters over a ring (a straggler slows "
                   "only itself)")
    p.add_argument("--iterations", type=int, default=0,
                   help="blocks consumed per learner (0 = 30, the smoke's 5)")
    p.add_argument("--duration-s", type=float, default=0.0,
                   help="wall-bounded run: consume as many blocks as fit in this window (sync "
                   "fleets vote the stop, so every rank exits after the same block)")
    p.add_argument("--preset", default="", help="take this preset's PPO config (default: a "
                   "small sleep-pad CartPole config)")
    p.add_argument("--env", default="", help="host:<gym id> or native:<id> pools (default: "
                   "the sleep-padded CartPole)")
    p.add_argument("--rollout-steps", type=int, default=16)
    p.add_argument("--num-envs", type=int, default=4,
                   help="envs per process (split across --actors)")
    p.add_argument("--actors", type=int, default=1, help="actor threads per process")
    p.add_argument("--epochs", type=int, default=None, help="default 2 (the preset's with "
                   "--preset)")
    p.add_argument("--minibatches", type=int, default=None, help="default 2 (the preset's "
                   "with --preset)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--async-correction", choices=("vtrace", "none"), default="vtrace",
                   help="the learner's staleness correction (sync mode needs vtrace)")
    p.add_argument("--sleep-s", type=float, default=0.002,
                   help="per-env-step wall pad of the sleep-pad envs")
    p.add_argument("--straggler-rank", type=int, default=-1,
                   help="rank whose envs get --straggler-extra-s more pad (-1 off)")
    p.add_argument("--straggler-extra-s", type=float, default=0.006)
    p.add_argument("--gossip-every", type=int, default=1,
                   help="consumed blocks between gossip exchanges")
    p.add_argument("--gossip-weight", type=float, default=0.5,
                   help="peer mixing weight in [0, 1]")
    p.add_argument("--queue-depth", type=int, default=4)
    p.add_argument("--max-staleness", type=int, default=8, help="-1 = unbounded")
    p.add_argument("--mailbox-dir", default="",
                   help="the shared gossip mailbox (a temporary directory by default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=0,
                   help="worker rows every N blocks (their first and last always)")
    p.add_argument("--telemetry-dir", default="",
                   help="per-rank telemetry under <dir>/host<rank>; the parent merges the "
                   "spans into <dir>/fleet_spans.jsonl")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--run-timeout", type=float, default=600.0,
                   help="per-run kill budget (seconds)")
    p.add_argument("--smoke", action="store_true",
                   help="the 2-process sync check on the CPU (exit 1 on failure)")
    p.add_argument("--bench", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.bench:
        raise SystemExit("--bench is not ported yet (the multi-process scaling grid belongs to "
                         "the port's benchmark harness, ROADMAP Queue 1 item 12)")
    if args.worker:
        if args.max_staleness < 0:
            args.max_staleness = None
        return run_worker(args)
    if args.smoke:
        return run_smoke(args)
    rec = run_cluster(
        args.processes, args.mode, iterations=args.iterations or 30,
        duration_s=args.duration_s, rollout_steps=args.rollout_steps, num_envs=args.num_envs,
        actors=args.actors, sleep_s=args.sleep_s, straggler_rank=args.straggler_rank,
        straggler_extra_s=args.straggler_extra_s if args.straggler_rank >= 0 else 0.0,
        gossip_every=args.gossip_every, gossip_weight=args.gossip_weight, seed=args.seed,
        telemetry_dir=args.telemetry_dir, mailbox_dir=args.mailbox_dir, device=args.device,
        timeout_s=args.run_timeout, extra_args=launch_extra(args))
    print(json.dumps(rec))
    ok = rec["version_consistent"] and rec["fingerprint_consistent"]
    return 0 if ok else 1


def launch_extra(args) -> tuple:
    """The worker flags `run_cluster` does not take itself."""
    out = ["--lr", str(args.lr), "--async-correction", args.async_correction,
           "--queue-depth", str(args.queue_depth), "--max-staleness", str(args.max_staleness),
           "--log-every", str(args.log_every)]
    for flag, value in (("--preset", args.preset), ("--env", args.env),
                        ("--epochs", args.epochs), ("--minibatches", args.minibatches)):
        if value:
            out += [flag, str(value)]
    return tuple(out)


if __name__ == "__main__":
    sys.exit(main())
