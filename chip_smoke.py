#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (from nvidia-smi);
2. build: every CUDA kernel of the main paths (GAE and V-trace), from
   `actor_critic_tpu_torch/csrc`, one nvcc each, all started together;
   the probe of the host env path: whether gymnasium and MuJoCo import
   (their versions) and the presets' three MuJoCo envs reset (missing
   MuJoCo is reported, and the host phases then run on the C++ engine's
   `native:Pendulum-v1`), then the engine's g++ build (a failed build
   fails);
3. kernels: the launch floor (the device time of a one-element zero_());
   each kernel against its plain PyTorch version on the card, at its main
   paths' shapes (async PPO's [256, 4] and [256, 8] among them) and at
   boundary shapes (ragged strips, chunk boundaries
   in T, bases off 16 bytes), with its tolerance, and its time beside the
   plain version's, the card's bound and the launch floor; the precision
   the card computes at (the port pins it where an entry point picks the
   card: full float32 convolutions and products, bf16 products reduced
   in float32): one IMPALA update at `impala_pong`'s full width on the
   card against the CPU's under torch's default precision (TF32
   convolutions) and under the pinned flags, and `impala_pong`'s ms a
   graph replay under each; then one A2C update and one IMPALA update on
   the card against the same update on the CPU, in float32 and in bf16
   (`--update-dtype bf16`, at bf16's tolerances);
4. graph equals eager: for `a2c_cartpole`, `ppo_cartpole`, `a2c_mixture`,
   `impala_pong` and `a3c_pong` at full width, a few iterations through
   the loop's CUDA-graph path against the same iterations run eagerly from
   the same seed, every carried tensor compared (for the mixture: every
   member slot, the types, the curriculum weights and stage; for IMPALA:
   the actors' copy and RMSProp's moments) and the generator's state; the
   same for the off-policy learners of `ddpg_walker2d`, `td3_walker2d` and
   `sac_humanoid` on `jax:pendulum` with the warm-up cut to 128 env steps
   (6 iterations: the 1M ring, its stats, targets, every Adam state, log α;
   the update gate must first open on a replayed iteration); then
   each eval as replays of captured blocks against the eager loop from one
   generator state (`a2c_cartpole`'s and `impala_pong`'s greedy evals,
   `a2c_mixture`'s greedy eval and its four typed evals through one set of
   graphs), returns and generator states equal, times printed; in bf16,
   graph against eager at 0.0 for `a2c_cartpole`, `ppo_cartpole`,
   `impala_pong`, `a2c_mixture` and the `sac_humanoid` learner, the
   advantage kernels launched once an iteration as in float32;
5. main paths, each through `actor_critic_tpu_torch.train.main` with every
   launch count reset just before and read just after:
   - `a2c_cartpole` at full width (E=4096, T=64), GAE on its path, the
     step replayed as a CUDA graph;
   - `ppo_cartpole` at full width (E=256, T=128, 4 epochs × 8
     minibatches), GAE on its path, the step replayed as a CUDA graph;
     it must solve CartPole (best greedy eval >= 400) in 30 iterations;
   - `impala_pong` at full width (E=64, T=20, 84×84×2 frames, Nature
     CNN), V-trace on its path, the step replayed as a CUDA graph;
   - `a3c_pong`, the same trainer through GAE, for a few iterations;
   - `a2c_mixture` at full width (E=1024, T=32, CartPole, Pendulum,
     Acrobot and the maze in one fleet, physics ±20%), GAE on its path,
     the step replayed as a CUDA graph, with the per-type eval matrix;
     then a few iterations with `--curriculum`, whose install of new type
     weights must show in the replayed fleet;
   - resume: `a2c_cartpole`, `impala_pong` and `a2c_mixture` (with a
     curriculum stage crossed before the save) for N iterations straight
     and for k plus a resumed N − k (`--ckpt-dir`, `--resume`), the final
     checkpoints equal at 0.0 over every carried tensor and the generator;
   - `--chunk 4` against `--chunk 1` on `a2c_cartpole`, the final
     checkpoints equal at 0.0 and GAE launched once an iteration;
   - the off-policy trainers: the learners of `ddpg_walker2d`,
     `td3_walker2d` and `sac_humanoid` at their published width (E=1,
     K=J=64, batch 256, hidden (256, 256), a 1M-transition ring) on
     `jax:pendulum`, each for 44 iterations across its preset's
     warm-up cut to 2,000 env steps (the gate opens at iteration 32,
     inside the replays), update count read back from the final
     checkpoint; SAC
     learning Pendulum (best greedy eval >= -250 in 1,000 iterations) and
     TD3 the point mass (> -1.0) through the graph; `td3_walker2d` with
     `--replay-dtype mixed` 8 straight against 4 + `--resume` 4, and
     `sac_humanoid` `--chunk 4` against `--chunk 1`, at 0.0; and SAC's 64
     updates at Humanoid-v5's shapes (obs 348, action 17) over a full 1M
     ring in fp32 and mixed as one captured graph (ms an update, launches,
     peak memory);
   - `--update-dtype bf16` through `train.main`: the six fused presets
     (warmed: the CUDA graph from iteration 1), host and async `ppo_halfcheetah`
     and host and async `sac_humanoid` (the warm-up cut), GAE's and
     V-trace's launches counted as in float32; the host PPO update's graph
     against eager at 0.0 in bf16 (`HostContract`, the mirror acting in
     float32); a bf16 served policy (`ppo_cartpole`, `ppo_halfcheetah`'s
     shapes), every bucket's graph = its eager act at 0.0;
   then IMPALA's learning check on the two-state MDP, and where a train
   step's time goes for `a2c_cartpole` and `impala_pong` (eager and as
   graph replays in the same call, host clock;
   torch.profiler on the graph, V-trace's own time inside it), each in
   float32 and then in bf16, with ms and launches a step compared;
   - the host env path, on each preset's MuJoCo env or the engine's
     Pendulum (as the probe found): `ppo_halfcheetah` at full width (E=8,
     T=256, 10 × 32 minibatches) through `train.main`, the update one
     CUDA graph from iteration 1 (warmed), GAE launched once an iteration and
     counted on the card, ms an iteration and the split into collect,
     wait, dispatch (host clock), upload and update (device); the
     off-policy presets at full width for 50 iterations past their
     warm-up cut to 2,000 env steps (the ingest and 64 updates one
     graph, the
     update count read back), ms an iteration and updates/s after the
     gate; for each of the four a second run under `HostContract`: the
     update's graph equal to its eager run on one block at 0.0, every
     uploaded block equal to its host block and every mirror snapshot
     equal to the parameters the update read, bitwise, with overlap on;
     and `td3_walker2d`'s host checkpoint round trip at 0.0 (learner,
     pool stats, generator, env steps) with the ring and without;
   - the async actor-learner, on the same env (the runs that check
     equality or launch counts at two epochs): a capture in "thread_local"
     mode while a thread enqueues blocks into the device ring (puts inside
     every capture, replays equal to eager); async PPO with one actor,
     depth 1, one update a block and correction none against
     `train_host` at 0.0 on the host plane and the device plane (fp32),
     the device-plane run also holding its update graph (gather, decode,
     update) against its eager run and showing in torch.profiler's trace
     that the learner's thread copies nothing to the card while the actor
     enqueues; `ppo_halfcheetah --async-actors 2` at full width through
     `train.main` on the host plane and the device plane (fp32 and int8),
     each at two epochs,
     V-trace's launches counted on the card equal to the consumed blocks,
     ms a consumed block, consumed env-steps/s, the split (collect per
     actor, learner idle, upload, update), drops and staleness, then the
     host plane's V-trace update graph against its eager run; the other
     async flags (`--updates-per-block 2 --max-staleness 4 --queue-depth 2
     --async-correction none`: GAE twice a block, counted); the three
     off-policy presets with one actor on both planes across their
     warm-up cut to 2,000 env steps (updates/s after the gate) and the
     device plane's
     ingest + update graph against its eager run; async PPO's checkpoint
     on both planes (every actor pool's stats, the ring's stats at int8):
     the round trip at 0.0, a resume of a complete run starting no actor,
     a resume that trains on;
   - policy serving: `PolicyEngine` at full width for `ppo_cartpole` and
     the policies of `ppo_halfcheetah`, `td3_walker2d` (HalfCheetah-v5's and
     Walker2d-v5's shapes: 17 obs, 6 actions) and `sac_humanoid`
     (Humanoid-v5's: 348, 17), every bucket 1..64 one CUDA graph equal to
     the eager act at 0.0 and timed against it, rows against batch-1,
     batch-1 p50 / p99, `auto`'s choice and walls, the sampled stream
     against its softmax; `python -m actor_critic_tpu_torch.serve
     --preset ppo_cartpole --random-init --port 0` in a subprocess with
     `--max-inflight` 1 and 2 and client threads here: mixed sizes at once
     = the in-process batch-1 actions, HTTP batch-1 p50 / p99, rows/s of 16
     clients, /healthz and /metrics (the SLO histograms), a /v1/swap from
     an exported checkpoint and swaps under load with no torn (version,
     actions); serve-while-training through `train.main --serve-port 0`:
     async `ppo_halfcheetah` (2 actors, the device plane, V-trace: its
     launches = consumed blocks) and `sac_humanoid` (one actor), polled by
     a client process, versions monotone, the store at blocks + 1, the
     served action = the learner's greedy act at 0.0, latency during
     training against the idle gateway, consumed env-steps/s against the
     async phase's run without the sidecar;
   - the multi-process actor-learner and the serving fleet
     (`parallel/`, `ppo_halfcheetah` at full width on the same env, two
     epochs): the sync learner at world 1 over NCCL through `train.main
     --distributed --coordinator 127.0.0.1:<port> --async-actors 2`
     (warmed: every all-reduce of the update counted inside its capture;
     `version_sum` and `fingerprint_ok` at every block, V-trace once a
     block), then through `multihost.train_multihost`: one capture, a
     replay equal to the single-host async update at 0.0, the replay's ms
     with and without the group, the consistency check's ms; gossip at
     world 2, both ranks on the one card, through `python -m
     actor_critic_tpu_torch.parallel.launch` with `--async-correction
     none` (both exit 0, mixes and lags on each, GAE once a block counted
     in each rank's process); sync at world 2 over NCCL where the machine
     has two cards, else one line saying it was not run and why; two
     `serve --distributed` replicas behind `serve_fleet`, replica 0 syncing
     the gossip run's mailbox (a newer version swapped in with the
     recompile counter unchanged), `/fleetz` listing both, and the proxy
     failing over when replica 1 is killed;
   - data and sequence parallelism of the fused trainers over a one-rank
     NCCL group made through `parallel/mesh.py` (the card's machine has one
     card): `distribute_state` → `make_dp_train_step` → `fused_train_loop`
     for `a2c_cartpole` (E=4096, T=64) and `impala_pong` (E=64, T=20),
     graph = eager and dp = the group-less step at 0.0, GAE / V-trace
     launched once an iteration, the all-reduces inside the capture
     counted; the dp learners of `td3_walker2d` (int8 ring) and
     `sac_humanoid` on `jax:pendulum`, graph = eager at 0.0, the
     quantizer's pmean and pmax counted inside the capture; IMPALA's
     `make_sp_update` and `make_sp_train_step` at `impala_pong`'s width
     against the unsharded update and step (tolerances stated, differing
     elements counted) and their graphs against eager at 0.0, and
     `seqpar_gae` / `seqpar_vtrace` at [4096, 64] against the kernels, one
     launch of each a call, device times;
   - telemetry and the stall watchdog: `a2c_cartpole`'s graph-vs-eager
     check and its resume run with the resource sampler reading the card
     every 20 ms through their "global"-mode captures (still 0.0);
     `a2c_cartpole` at full width through `train.main` with `--chunk 4
     --ckpt-dir --save-every 8 --stall-timeout 30 --telemetry-dir
     --telemetry-port 0 --telemetry-sample-s 0.02`, scraped live, a
     2-dispatch profile window armed after its captures (GAE 8 times in
     the window's trace), spans canonical and their update/log/checkpoint
     sequence the CPU run's, the card's live and peak bytes, recompiles =
     captures = `compile` events (seconds printed), and
     `scripts/run_report.py` on it (exit 0, run beside the next phases);
     the session's cost in turns without a client (off, the default 5 s
     sampling, 20 ms), each run's `chunk_wall.json` within 1.5 x 4 x its
     replay ms + 5 ms; short host and async `ppo_halfcheetah` runs of
     their own with `--telemetry-dir` (the update span: the graph's host
     launch; env_step on both actor threads, queue_wait/update on the
     learner's, the `device_ring` gauge); a child process stalled on a GPU
     spin inside an `update` span (exit 42 naming it, a `stall` event, a
     flight dump); `serve.py --telemetry-dir` (the request hops as spans
     and flows, the card's memory on /metrics);
   - the runtime sanitizers (`actor_critic_tpu_torch/analysis/`) on the
     card: racesan's quick profile over the port's queue, publisher,
     mailbox and batcher and its device-ring exerciser with the ring's
     storage on the card; numsan's quick profile with the host PPO update
     (the GAE kernel's launches counted: one an update), the bf16 update,
     the checkpoint and the codecs on the card; padsan's quick profile with
     every seam on the card and the kernel seam (the scan kernels' ragged
     strips and chunks at E = 7, 96, 200 and T = 100, inputs and outputs
     tailed by zeros and by poison) at 21 seeds, both kernels' launches
     counted by E and equal to the calls made, the serving buckets
     captured and replayed; every reverted mode of the three caught, and
     padsan's `chunked` refused (no counterpart seam); fleetsan's quick
     profile (gossip fleet and gateway schedules over the port's mailbox,
     `PolicyStore` and syncer), its replica sweep and its three reverted
     modes, then one real-process chaos at world 2 on the card (gossip
     workers of `parallel.launch` on `native:CartPole-v1`, one SIGKILLed
     mid-run and restarted: its time to recover, its flight ring harvested
     into a dump, the survivors' mixes, V-trace launches = consumed blocks
     in each worker); perfsan's quick profile against its manifest's
     `cuda` values (every program's dispatches, transfers, bytes and
     recompiles a block; GAE and V-trace launches inside the PPO and
     mixture programs = the blocks and iterations they consumed) and its
     three reverted modes, each caught on its budget key;
   - the static analyzer (`python -m actor_critic_tpu_torch.analysis.torchlint`,
     run over the port's tree in the background from the script's start):
     exit 0 and no finding the baseline does not cover, its checks and
     seconds printed; then three of its capture checks grounded on the
     card, in two child processes: the flag twins of tracer-leak (a sync
     inside a capture) and prng-reuse (an unregistered generator drawn
     inside a capture) raise or bake in what they read, donation-aliasing's
     (a restored tensor rebound into a captured state) makes graph != eager,
     and each ok twin gives graph = eager at 0.0;
6. a `{"kernels": [...]}` line (each kernel's launches on every main path
   that runs it under `launches_by_path`), then the card's name and power
   limit;
7. last line: `{"ok": true, "device": {"platform": "gpu", ...}}`.

Exits non-zero, printing no result, where no CUDA device is present.
Imports nothing of JAX. Every process it starts is stopped when it ends,
passed or failed: the script reaps its orphaned descendants
(`PR_SET_CHILD_SUBREAPER`), and whatever still runs below it at the end is
listed and killed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import time
from typing import Optional

MAIN_PATH_ITERATIONS = 50
PPO_ITERATIONS = 30      # tests/test_ppo.py's bar: best eval at 20/25/30 >= 400
IMPALA_ITERATIONS = 60   # > max_steps / T = 50: every env ends an episode
A3C_ITERATIONS = 3
MIXTURE_ITERATIONS = 50
MIXTURE_EVAL_EVERY = 25
CURRICULUM_ITERATIONS = 8   # evals at 4 (a replay: the install lands on replays) and 8
GRAPH_CHECK_ITERATIONS = 5  # the loop's eager warm-up, a capture, then replays
RESUME_ITERATIONS, RESUME_AT = 8, 4  # N straight against k + a resumed N − k
CHUNK, CHUNK_ITERATIONS = 4, 12      # warm-up, a short chunk, two full chunks
# `ppo_halfcheetah`'s epochs in the runs that check what does not depend on
# the update's depth (graph = eager, lockstep, uploads, launch counts): at
# the preset's 10 epochs × 32 minibatches each run's two eager blocks and
# its capture of the ~151,000-node update take ~20 s of the script's time.
CHECK_EPOCHS = 2
# Checkpoints and metrics of the drives, inside the checkout (gitignored).
SCRATCH = "build/chip_smoke"
# Past this many seconds every thread's stack goes to stderr (the run goes
# on): where a run that outlasts its time limit stood.
STACKS_AFTER_S = 1100
# Kernel vs plain version: the same tolerances as the JAX package's kernel
# tests (tests/test_pallas_scan.py). The GAE kernel rounds every operation
# in the plain version's order, so on the card the two should agree
# exactly; V-trace also takes an exp on each side (expf in the kernel,
# PyTorch's exp in the plain version), so it may differ in the last bit.
ATOL = RTOL = 1e-6
VTRACE_ATOL, VTRACE_RTOL = 1e-6, 1e-5
GAMMA, LAM = 0.99, 0.95
# H100 SXM published peaks at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call of `fn`, from CUDA events over `iters`
    back-to-back calls after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_kernels(fn, iters: int) -> tuple[dict[str, tuple[int, float]], float]:
    """Run `fn` `iters` times under torch.profiler; returns ({kernel name:
    (launches, device microseconds)}, wall seconds of the profiled run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {
        e.key: (e.count, e.self_device_time_total)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    }
    return kernels, wall


def launch_floor_ms() -> float:
    """Device time of the smallest kernel, a one-element zero_() on a
    preallocated CUDA tensor, under torch.profiler: what any kernel costs
    at a launch-bound shape."""
    import torch

    x = torch.empty(1, device="cuda")
    prof, _ = profile_kernels(x.zero_, iters=100)
    assert len(prof) == 1, f"expected one kernel for zero_(), the profiler saw {list(prof)}"
    (n, us), = prof.values()
    return us / n / 1e3


def time_against_bound(label: str, kernel: str, fn, plain, bytes_moved: int, flops: int) -> dict:
    """Time the wrapper call `fn` (whose kernel's name contains `kernel`)
    and its plain version `plain`, print both beside the card's bound, and
    return the kernels-line timing keys. The kernel's time is its own
    device time under torch.profiler; back-to-back calls timed by CUDA
    events include the wrapper's host time when the host is the slower
    side, and are the fall back where the profiler records none. The
    inputs stay warm in L2 between calls, as they are on the main path."""
    event_ms = cuda_ms(fn, iters=500)
    prof, _ = profile_kernels(fn, iters=100)
    rows = [(n, us) for k, (n, us) in prof.items() if kernel in k]
    ms = rows[0][1] / rows[0][0] / 1e3 if rows else event_ms
    plain_ms = cuda_ms(plain, iters=20)
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S else "operations"
    print(
        f"{label}: kernel {ms * 1e3:.3f} us on the device "
        f"({'torch.profiler, inputs warm in L2' if rows else 'not measured by the profiler; CUDA events'}), "
        f"{event_ms * 1e3:.3f} us a call back to back (CUDA events), plain {plain_ms * 1e3:.3f} us, "
        f"bound {bound_s * 1e6:.4f} us ({bound_by}: {bytes_moved} B, {flops} flop)",
        flush=True,
    )
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by}


def off_by_one_float(x):
    """A contiguous copy of `x` that starts one float into its buffer, so
    the kernels must take their 4-byte copies."""
    import torch

    return torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape).copy_(x)


def gae_inputs(T: int, E: int, seed: int, done_at_t0: bool = False, offset: bool = False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rewards = torch.randn((T, E), generator=g, device="cuda")
    values = torch.randn((T, E), generator=g, device="cuda")
    dones = (torch.rand((T, E), generator=g, device="cuda") < 0.1).float()
    if done_at_t0:
        dones.zero_()
        dones[0] = 1.0
    if offset:
        rewards, values, dones = map(off_by_one_float, (rewards, values, dones))
    bootstrap = torch.randn((E,), generator=g, device="cuda")
    return rewards, values, dones, bootstrap


def check_gae(floor_ms: float) -> dict:
    """GAE kernel vs `ops.returns.gae` on the card; returns its kernels-line
    entry. Prints each timed shape's time over the launch floor."""
    import torch

    from actor_critic_tpu_torch.ops import gae_cuda, returns

    # (name, T, E, input options). The kernel walks T in chunks of 64 rows
    # (T65 and multi-chunk cross chunk boundaries) over strips of 16 env
    # columns (E7, E200, multi-block: ragged strips), with 16-byte copies
    # where E % 4 == 0 and the planes start on 16 bytes (offset-base,
    # multi-block and multi-chunk take the 4-byte ones).
    cases = [
        ("preset", 64, 4096, {}),
        ("ppo preset", 128, 256, {}),
        ("mixture preset", 32, 1024, {}),
        ("host ppo", 256, 8, {}),
        ("T17-E512", 17, 512, {}),
        ("E7", 17, 7, {}),
        ("E96", 17, 96, {}),
        ("E200", 17, 200, {}),
        ("T1", 1, 512, {}),
        ("T65", 65, 4096, {}),
        ("done-at-t0", 4, 512, {"done_at_t0": True}),
        ("multi-block", 64, 4096 + 37, {}),
        ("multi-chunk", 256, 4133, {}),
        ("offset-base", 20, 64, {"offset": True}),
        ("async A=2", 256, 4, {}),
    ]
    max_err = 0.0
    for i, (name, T, E, opts) in enumerate(cases):
        args = gae_inputs(T, E, seed=i, **opts)
        adv, ret = gae_cuda.gae(*args, GAMMA, LAM)
        adv_p, ret_p = returns.gae(*args, GAMMA, LAM)
        torch.cuda.synchronize()
        for got, want in ((adv, adv_p), (ret, ret_p)):
            assert got.shape == (T, E) and bool(torch.isfinite(got).all()), name
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL, msg=lambda m: f"gae {name}: {m}")
        err = max(float((adv - adv_p).abs().max()), float((ret - ret_p).abs().max()))
        max_err = max(max_err, err)
        print(f"gae {name:12s} T={T:3d} E={E:5d} max_abs_err={err:.3e}", flush=True)

    # a2c_cartpole's shape (the kernels-line entry), then ppo_cartpole's
    # (two chunks of 64 rows, double-buffered), a2c_mixture's, a3c_pong's
    # and the host path's ppo_halfcheetah (one ragged strip of 8 of the
    # tile's 16 columns, four chunks of 64 rows).
    timings = []
    for T, E in ((64, 4096), (128, 256), (32, 1024), (20, 64), (256, 8), (256, 4)):
        args = gae_inputs(T, E, seed=100)
        timings.append(time_against_bound(
            f"gae [{T},{E}]", "gae_kernel", lambda: gae_cuda.gae(*args, GAMMA, LAM),
            lambda: returns.gae(*args, GAMMA, LAM),
            bytes_moved=(5 * T * E + E) * 4,  # 3 inputs + 2 outputs [T,E], bootstrap [E]
            flops=8 * T * E))  # sub, 2 mul, add, sub; 2 mul, add; add per element
        print(f"gae [{T},{E}]: {timings[-1]['ms'] / floor_ms:.2f}x the launch floor, "
              f"{timings[-1]['ms'] / timings[-1]['bound_ms']:.2f}x its bound", flush=True)
    return {
        "name": "gae",
        "route": "cuda",
        "source": "actor_critic_tpu_torch/csrc/gae.cu",
        "replaces": "actor_critic_tpu/ops/pallas_scan.py:107",
        "launches": None,
        "max_abs_err": max_err,
        **timings[0],
        # No single PyTorch call computes GAE.
        "library_ms": None,
    }


def vtrace_inputs(T: int, E: int, seed: int, done_at_t0: bool = False,
                  lp_scale: float = 0.3, capped: bool = False, offset: bool = False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    tlp = torch.randn((T, E), generator=g, device="cuda") * lp_scale
    blp = torch.randn((T, E), generator=g, device="cuda") * lp_scale
    if capped:  # log-ratios far above the cap of 20 (exp(100) is inf in float32)
        tlp = torch.where(torch.rand((T, E), generator=g, device="cuda") < 0.05, 100.0, tlp)
    if offset:
        tlp, blp = off_by_one_float(tlp), off_by_one_float(blp)
    return (tlp, blp, *gae_inputs(T, E, seed + 1000, done_at_t0, offset))


def check_vtrace() -> dict:
    """V-trace kernel vs `ops.returns.vtrace` on the card; returns its
    kernels-line entry."""
    import torch

    from actor_critic_tpu_torch.ops import returns, vtrace_cuda

    # (name, T, E, input options, rho_bar, c_bar, lam); chunks and strips
    # as in check_gae.
    cases = [
        ("preset", 20, 64, {}, 1.0, 1.0, 1.0),
        ("T17-E512", 17, 512, {}, 1.0, 1.0, 0.9),
        ("E7", 17, 7, {}, 1.0, 1.0, 1.0),
        ("E96", 17, 96, {}, 1.0, 1.0, 1.0),
        ("E200", 17, 200, {}, 1.0, 1.0, 1.0),
        ("E300", 17, 300, {}, 1.0, 1.0, 1.0),
        ("T1", 1, 512, {}, 1.0, 1.0, 1.0),
        ("T65", 65, 4096, {}, 1.0, 2.0, 0.9),
        ("done-at-t0", 4, 512, {"done_at_t0": True}, 1.0, 1.0, 1.0),
        ("cbar>rhobar", 17, 512, {"lp_scale": 1.0}, 1.0, 2.0, 0.9),
        ("capped-ratio", 4, 128, {"capped": True}, 1e9, 1.0, 1.0),
        ("multi-block", 20, 4096 + 37, {}, 1.0, 1.0, 1.0),
        ("multi-chunk", 129, 4133, {"lp_scale": 1.0}, 1.0, 2.0, 0.9),
        ("offset-base", 20, 64, {"offset": True}, 1.0, 1.0, 1.0),
        ("async A=2", 256, 4, {}, 1.0, 1.0, LAM),
        ("async A=1", 256, 8, {}, 1.0, 1.0, LAM),
    ]
    max_err = 0.0
    for i, (name, T, E, opts, rho_bar, c_bar, lam) in enumerate(cases):
        args = vtrace_inputs(T, E, seed=i, **opts)
        got = vtrace_cuda.vtrace(*args, GAMMA, rho_bar, c_bar, lam)
        want = returns.vtrace(*args, GAMMA, rho_bar, c_bar, lam)
        torch.cuda.synchronize()
        err = 0.0
        for field in want._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert g.shape == (T, E) and bool(torch.isfinite(g).all()), (name, field)
            torch.testing.assert_close(g, w, atol=VTRACE_ATOL, rtol=VTRACE_RTOL,
                                       msg=lambda m: f"vtrace {name} {field}: {m}")
            err = max(err, float((g - w).abs().max()))
        if name == "capped-ratio":
            # ρ = exp(20) ≈ 4.85e8 here, so the outputs are of that order
            # and held by the relative tolerance; the other cases' values are
            # of order 1, and `max_abs_err` is taken over those.
            assert float(got.clipped_rhos.max()) > 4e8, "the capped ratio did not reach rho"
        else:
            max_err = max(max_err, err)
        print(f"vtrace {name:12s} T={T:3d} E={E:5d} max_abs_err={err:.3e}", flush=True)

    # impala_pong's shape (the kernels-line entry), then async PPO's at
    # ppo_halfcheetah's width with two actors and with one.
    timings = []
    for T, E in ((20, 64), (256, 4), (256, 8)):
        args = vtrace_inputs(T, E, seed=100)
        timings.append(time_against_bound(
            f"vtrace [{T},{E}]", "vtrace_kernel", lambda: vtrace_cuda.vtrace(*args, GAMMA),
            lambda: returns.vtrace(*args, GAMMA),
            bytes_moved=(8 * T * E + E) * 4,  # 5 inputs + 3 outputs [T,E], bootstrap [E]
            flops=21 * T * E))  # 20 float operations and one exp per element
    timing = timings[0]
    return {
        "name": "vtrace",
        "route": "cuda",
        "source": "actor_critic_tpu_torch/csrc/vtrace.cu",
        "replaces": "actor_critic_tpu/ops/pallas_scan.py:238",
        "launches": None,
        "max_abs_err": max_err,
        **timing,
        # No single PyTorch call computes V-trace.
        "library_ms": None,
    }


@contextlib.contextmanager
def precision_flags(tf32: bool, deterministic: bool):
    """cuDNN's TF32 and deterministic-algorithm flags as given inside the
    block (torch's defaults: True, False; with TF32, cuBLAS's bf16 products
    are also let reduce in bf16, torch's default), the port's pinned flags
    (`pin_precision`) again afterwards. Only for measuring what the pin
    changes: single-threaded, outside the phases that capture beside
    threads."""
    import torch

    from actor_critic_tpu_torch import pin_precision

    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = tf32
    try:
        yield
    finally:
        pin_precision()


def update_on_card_vs_cpu(mod, env, cfg, cpu, traj, default_precision: bool = False):
    """One `mod.update` on the card against the same update on the CPU (the
    kernels' plain versions there), from a copy of the CPU train state `cpu`
    and the rollout `traj`; `cpu` itself takes the CPU's update. The card
    runs with the port's pinned precision, or with torch's defaults
    (`default_precision`). Returns ({name: (before, CPU after, card
    after)}, CPU metrics, card metrics)."""
    import copy

    import torch

    from actor_critic_tpu_torch.algos.common import RolloutState, ScheduleTable, Transition

    gpu = copy.deepcopy(cpu)
    for f in dataclasses.fields(gpu):
        v = getattr(gpu, f.name)
        if isinstance(v, (torch.Tensor, torch.nn.Module)):
            setattr(gpu, f.name, v.cuda())
        elif isinstance(v, ScheduleTable):
            setattr(gpu, f.name, ScheduleTable(*(t.cuda() for t in v)))
    for f in dataclasses.fields(gpu.opt_state):
        v = getattr(gpu.opt_state, f.name)
        if isinstance(v, dict):
            setattr(gpu.opt_state, f.name, {k: t.cuda() for k, t in v.items()})
        elif isinstance(v, torch.Tensor):
            setattr(gpu.opt_state, f.name, v.cuda())
    # The update reads the next obs of the rollout state, not the env state.
    gpu.rollout = RolloutState(env_state=None, obs=gpu.rollout.obs.cuda())
    before = {k: p.detach().clone() for k, p in cpu.net.named_parameters()}
    m_cpu = mod.update(env, cfg, mod.make_optimizer(cfg), cpu, traj)
    flags = precision_flags(tf32=True, deterministic=False) if default_precision else None
    with flags or contextlib.nullcontext():
        m_gpu = mod.update(env, cfg, mod.make_optimizer(cfg), gpu,
                           Transition(*(x.cuda() for x in traj)))
        torch.cuda.synchronize()
    params = {k: (before[k], pc.detach(), pg.detach().cpu())
              for (k, pc), (_, pg) in zip(cpu.net.named_parameters(), gpu.net.named_parameters(),
                                          strict=True)}
    return params, m_cpu, {k: v.cpu() for k, v in m_gpu.items()}


def fp32_gaps(params: dict, m_cpu: dict, m_gpu: dict, metric_keys) -> tuple[float, float]:
    """(largest parameter difference, largest relative metric difference)
    of a card-against-CPU update."""
    worst = max(float((pg - pc).abs().max()) for _, pc, pg in params.values())
    rel = max(float((m_gpu[k] - m_cpu[k]).abs() / max(float(m_cpu[k].abs()), 1e-12))
              for k in metric_keys)
    return worst, rel


def assert_fp32_update(label: str, params: dict, m_cpu: dict, m_gpu: dict, param_atol: float,
                       metric_keys, metric_atol: float, metric_rtol: float) -> None:
    import torch

    for k, (_, pc, pg) in params.items():
        torch.testing.assert_close(pg, pc, atol=param_atol, rtol=1e-6,
                                   msg=lambda m, k=k: f"{label}, {k}: {m}")
    for k in metric_keys:
        torch.testing.assert_close(m_gpu[k], m_cpu[k], atol=metric_atol, rtol=metric_rtol,
                                   msg=lambda m, k=k: f"{label}, metric {k}: {m}")


# A bf16 update against the same update elsewhere (tests/test_torch_bf16.py
# holds the port against JAX at these tolerances): the products round to
# bf16 where the two sums differ in order, so gradients differ at bf16's
# 8 bits and Adam's first steps (about lr·g/|g| each) by up to 2·lr where a
# gradient element lies within that error of 0.
BF16_STEP_MAX = 0.5        # of lr, any parameter after the update
BF16_STEP_REL_L2 = 2e-2    # the whole update's (new − old) relative L2 difference
BF16_METRIC_RTOL, BF16_METRIC_ATOL = 2e-2, 1e-3


def assert_bf16_update(label: str, params: dict, m_cpu: dict, m_gpu: dict, lr: float,
                       metric_keys) -> str:
    """A bf16 update on the card against the CPU's at the bf16 tolerances;
    returns the printed summary."""
    import torch

    before = torch.cat([b.double().ravel() for b, _, _ in params.values()])
    cpu = torch.cat([c.double().ravel() for _, c, _ in params.values()])
    gpu = torch.cat([g.double().ravel() for _, _, g in params.values()])
    worst = float((gpu - cpu).abs().max()) / lr
    rel = float(torch.linalg.norm(gpu - cpu) / torch.linalg.norm(cpu - before))
    differ = int((gpu != cpu).sum())
    for k in metric_keys:
        torch.testing.assert_close(m_gpu[k], m_cpu[k], atol=BF16_METRIC_ATOL,
                                   rtol=BF16_METRIC_RTOL,
                                   msg=lambda m, k=k: f"{label}, metric {k}: {m}")
    assert worst <= BF16_STEP_MAX and rel <= BF16_STEP_REL_L2, (label, worst, rel)
    return (f"{differ} of {gpu.numel()} parameters differ, worst {worst:.4f}·lr (bound "
            f"{BF16_STEP_MAX}), the update's relative L2 difference {rel:.5f} (bound "
            f"{BF16_STEP_REL_L2})")


A2C_METRICS = ("loss", "pg_loss", "v_loss", "entropy", "mean_finished_return")
IMPALA_METRICS = ("loss", "pg_loss", "v_loss", "entropy", "mean_rho")


def check_update_on_card(bf16: bool = False) -> None:
    """One A2C update on the card against the same update on the CPU (plain
    GAE there), from the same state and rollout at a small size, with the
    port's pinned precision: the slice as a whole, kernel included, gives
    the CPU's answer. float32: parameters atol 1e-5·lr + rtol 1e-6 (see
    tests/test_torch_a2c.py), loss metrics rtol 1e-5 (sums taken in another
    order); bf16: the bf16 tolerances above."""
    from actor_critic_tpu_torch.algos import a2c
    from actor_critic_tpu_torch.envs import make_cartpole

    cfg = a2c.A2CConfig(num_envs=64, rollout_steps=16, lr=1e-3, anneal_iters=10,
                        lr_final=0.0, entropy_coef_final=0.0, bf16_compute=bf16)
    env = make_cartpole()
    cpu = a2c.init_state(env, cfg, seed=3, device="cpu")
    traj = a2c.rollout(env, cfg, cpu)
    params, m_cpu, m_gpu = update_on_card_vs_cpu(a2c, env, cfg, cpu, traj)
    if bf16:
        summary = assert_bf16_update("bf16 A2C update on card", params, m_cpu, m_gpu, cfg.lr,
                                     A2C_METRICS)
    else:
        assert_fp32_update("update on card", params, m_cpu, m_gpu, 1e-5 * cfg.lr, A2C_METRICS,
                           0.0, 1e-5)
        summary = f"max abs parameter difference {fp32_gaps(params, m_cpu, m_gpu, A2C_METRICS)[0]:.3e}"
    print(f"{'bf16 ' if bf16 else ''}update on card vs CPU (E=64, T=16): {summary}", flush=True)


def check_impala_update_on_card(bf16: bool = False) -> None:
    """One IMPALA update on the card against the same update on the CPU
    (plain V-trace there), from the same state and a stale-actor rollout at
    a small pixel size (42 px, E=8, T=4), with the port's pinned precision
    (full float32 convolutions). float32 tolerances: loss metrics rtol
    1e-4, parameters atol 1e-4·lr + rtol 1e-6. cuDNN sums the convolutions
    in another order than the CPU (and may transform them, Winograd or
    FFT), so grads agree to ~1e-5 relative, not to the bit; RMSProp moves a
    parameter by at most ~3.2·lr·|g|, which bounds the parameter difference
    by ~3.2·lr·|Δg|. bf16: the bf16 tolerances above."""
    import torch

    from actor_critic_tpu_torch.algos import impala
    from actor_critic_tpu_torch.envs import make_pong

    cfg = impala.ImpalaConfig(num_envs=8, rollout_steps=4, lr=1e-3, actor_refresh_every=2,
                              bf16_compute=bf16)
    env = make_pong(size=42)
    cpu = impala.init_state(env, cfg, seed=3, device="cpu")
    # The learner's policy head sharpened after the actors' copy was taken,
    # so that the compared update's ratios are well away from 1.
    with torch.no_grad():
        cpu.net.policy.weight.mul_(1000.0)
    traj = impala.rollout(env, cfg, cpu)
    params, m_cpu, m_gpu = update_on_card_vs_cpu(impala, env, cfg, cpu, traj)
    assert 0.0 < float(m_cpu["mean_rho"]) < 0.99, m_cpu["mean_rho"]
    if bf16:
        summary = assert_bf16_update("bf16 IMPALA update on card", params, m_cpu, m_gpu, cfg.lr,
                                     IMPALA_METRICS)
    else:
        assert_fp32_update("impala update on card", params, m_cpu, m_gpu, 1e-4 * cfg.lr,
                           IMPALA_METRICS, 1e-6, 1e-4)
        summary = (f"max abs parameter difference "
                   f"{fp32_gaps(params, m_cpu, m_gpu, IMPALA_METRICS)[0]:.3e}")
    print(f"{'bf16 ' if bf16 else ''}impala update on card vs CPU (42 px, E=8, T=4, the pinned "
          f"precision): {summary}, mean_rho {float(m_gpu['mean_rho']):.6f} (CPU "
          f"{float(m_cpu['mean_rho']):.6f})", flush=True)


def check_graph_equals_eager(preset_name: str, bf16: bool = False) -> int:
    """The loop's CUDA-graph path against eager execution, at a preset's
    full width: two states from one seed, each taken through
    `fused_train_loop` for GRAPH_CHECK_ITERATIONS iterations, one eagerly and
    one through the graph (the eager warm-up, a capture, then replays). The
    step is the trainer's rollout and update, plus a copy of each
    iteration's actions into a buffer at the row of the state's step
    counter (in place, so that replays write it too). Holds every carried
    tensor (`common.carried_tensors`: parameters, IMPALA's actor copy,
    optimizer moments and count, rollout obs, env state leaf by leaf,
    episode accounting, step counter), the actions, the last metrics and the
    generator's state of the two at 1e-6 (expected 0.0: the same kernels on
    the same inputs, the same random numbers), the advantage kernel's
    launches (counted on the card: V-trace for IMPALA, GAE otherwise) equal
    to the iterations on both sides, and the actions of consecutive replays
    different. Both sides run with the port's pinned precision; with
    `bf16` the preset's networks compute in bf16 (`--update-dtype bf16`).
    Returns the advantage kernel's launches in the graph run."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.algos.common import carried_tensors
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    preset = PRESETS[preset_name]
    mod, cfg = train.ALGOS[preset.algo], dataclasses.replace(preset.config, bf16_compute=bf16)
    kernel = vtrace_cuda if getattr(cfg, "correction", "") == "vtrace" else gae_cuda
    env = train.make_env(preset.env, preset.env_kwargs)
    n = GRAPH_CHECK_ITERATIONS
    runs = {}
    for capturable in (False, True):
        state = mod.init_state(env, cfg, seed=2, device="cuda")
        drawn = torch.zeros((n, cfg.rollout_steps, cfg.num_envs), dtype=torch.int64, device="cuda")

        def make_recording_step(env, cfg, drawn=drawn):
            opt = mod.make_optimizer(cfg)

            def step(state):
                traj = mod.rollout(env, cfg, state)
                drawn.index_copy_(0, state.step_counter, traj.action[None])
                return state, mod.update(env, cfg, opt, state, traj)

            return step

        kernel.reset_launch_count()
        t0 = time.perf_counter()
        state, metrics = loop.fused_train_loop(
            make_recording_step, mod.init_state, env, cfg, n, state=state, capturable=capturable)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tensors = dict(carried_tensors(state), actions=drawn,
                       generator=state.generator.get_state())
        tensors.update({f"metric {k}": v for k, v in metrics.items()})
        runs[capturable] = (tensors, state.update_step, kernel.launch_count(), seconds)

    (eager, eager_steps, eager_launches, eager_s), (graph, graph_steps, graph_launches, graph_s) = (
        runs[False], runs[True])
    assert sorted(eager) == sorted(graph)
    diffs = {k: float((graph[k].double() - eager[k].double()).abs().max()) for k in eager}
    worst = max(diffs.values())
    drawn = graph["actions"]
    changed = [float((drawn[i] != drawn[i + 1]).float().mean())
               for i in range(loop.WARMUP_ITERATIONS, n - 1)]
    name = kernel.__name__.rsplit(".", 1)[-1].removesuffix("_cuda")
    print(
        f"graph vs eager, {preset_name}{' bf16' if bf16 else ''} (E={cfg.num_envs}, "
        f"T={cfg.rollout_steps}), {n} iterations "
        f"({loop.WARMUP_ITERATIONS} eager warm-up, then replays): max abs difference {worst:.3e} "
        f"over {len(diffs)} tensors (worst: {max(diffs, key=diffs.get)}), the generator's state "
        f"{'equal' if diffs['generator'] == 0 else 'DIFFERENT'}; update_step {graph_steps} (eager "
        f"{eager_steps}); {name} launches {graph_launches} (eager {eager_launches}); share of "
        f"actions changed between consecutive replays {', '.join(f'{c:.3f}' for c in changed)}; "
        f"{graph_s:.2f} s (eager {eager_s:.2f} s, capture included)",
        flush=True,
    )
    assert worst <= 1e-6, {k: d for k, d in diffs.items() if d > 1e-6}
    assert graph_steps == eager_steps == n, (graph_steps, eager_steps)
    assert graph_launches == eager_launches == n, (graph_launches, eager_launches)
    assert all(c > 0 for c in changed), changed
    assert state.net.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
    return graph_launches


def check_eval_graphs() -> None:
    """Each eval as replays of `BlockedEval`'s captured blocks (what
    `train.main` runs on the card) against the plain eager loop
    (`common.evaluate`) from one state of the eval generator: the returns
    equal (0.0) and the generator's state after equal, for `a2c_cartpole`'s
    and `impala_pong`'s greedy evals and `a2c_mixture`'s greedy eval and
    its four typed evals, which share one set of graphs (the type enters
    through the eager reset as a device tensor). Prints each eval's time:
    eager, the first graph call (capture included) and a replayed call,
    and the captures' own seconds."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos.common import default_eval_steps, evaluate
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.envs import mixture

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = float(fn())
        return out, time.perf_counter() - t0

    gen = torch.Generator(device="cuda")
    for preset_name in ("a2c_cartpole", "impala_pong", "a2c_mixture"):
        preset = PRESETS[preset_name]
        mod, cfg = train.ALGOS[preset.algo], preset.config
        env = train.make_env(preset.env, preset.env_kwargs)
        state = mod.init_state(env, cfg, seed=4, device="cuda")
        act = lambda obs: state.net(obs)[0].mode()
        steps = default_eval_steps(env)
        cases = [("greedy", mod.make_eval_fn(env, cfg), 32, None)]
        if isinstance(env, mixture.MixtureEnv):
            typed = mixture.make_typed_eval(env)
            type_ids = torch.arange(env.n_types, device="cuda")
            cases += [(f"typed {name}", typed, 16, type_ids[t])
                      for t, name in enumerate(env.member_names)]
        for label, fn, num_envs, tid in cases:
            call = (lambda: fn(state, gen)) if tid is None else (lambda: fn(state, gen, tid))
            reset = None if tid is None else (lambda k, g, tid=tid: env.reset_typed(k, g, tid))
            gen.manual_seed(21)
            eager, eager_s = timed(lambda: evaluate(env, act, gen, num_envs, steps, reset))
            eager_gen = gen.get_state()
            results = []
            for _ in range(2):  # the first call captures, the second only replays
                gen.manual_seed(21)
                results.append((*timed(call), gen.get_state()))
            (first, first_s, first_gen), (again, again_s, again_gen) = results
            (blocked,) = fn.evals.values()
            print(f"eval {preset_name} {label} ({num_envs} envs, {steps} steps): return "
                  f"{again:.4f}, eager {eager:.4f}; {again_s * 1e3:.1f} ms as graph replays "
                  f"(first call {first_s * 1e3:.1f} ms, captures "
                  f"{', '.join(f'{n} steps {c:.3f} s' for n, c in blocked.capture_s.items())}), "
                  f"eager {eager_s * 1e3:.1f} ms", flush=True)
            assert first == again == eager, (preset_name, label, first, again, eager)
            assert torch.equal(first_gen, eager_gen) and torch.equal(again_gen, eager_gen), (
                preset_name, label)
        if isinstance(env, mixture.MixtureEnv):
            assert len(typed.evals) == 1 and sorted(next(iter(typed.evals.values())).graphs) == sorted(
                {16, steps % 16} - {0}), "one set of typed-eval graphs serves every member type"


def drive(argv: list[str], show_every: int) -> tuple[list[dict], dict, dict[str, int]]:
    """Run `train.main(argv)` with every kernel's launch count reset just
    before and read just after; returns (logged rows, summary row,
    launches). A warmed run (the CLI's default) resets the counts again
    when its warm-up is done, right before the first dispatch of the site
    that completed it, so that the counts are the real iterations' and not
    the warm-up's eager steps'; its `warmup_done` must report no error.
    Prints the first and last rows, every `show_every`-th, the summary,
    and the lines that are not JSON (the curriculum's, the resume's, the
    warm-up's plan), but not the run's config line."""
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda
    from actor_critic_tpu_torch.utils import compile_cache

    buf = io.StringIO()
    if "--metrics" not in argv:
        argv = argv + ["--metrics", f"{SCRATCH}/metrics.jsonl"]
    runners = []

    def warmed(runner) -> None:
        runners.append(runner)
        if not any("skipped" in r for r in runner.results):  # else the run has ended
            gae_cuda.reset_launch_count()
            vtrace_cuda.reset_launch_count()

    gae_cuda.reset_launch_count()
    vtrace_cuda.reset_launch_count()
    compile_cache.WARMUP_DONE_HOOKS.append(warmed)
    try:
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv)
    finally:
        compile_cache.WARMUP_DONE_HOOKS.remove(warmed)
    launches = {"gae": gae_cuda.launch_count(), "vtrace": vtrace_cuda.launch_count()}
    assert rc == 0, f"train.main returned {rc}"
    assert len(runners) == (0 if "--no-warmup" in argv else 1), runners
    for runner in runners:
        errors = [r for r in runner.results if "error" in r]
        assert not errors, f"warm-up errors: {errors}"
    lines = buf.getvalue().splitlines()
    for line in lines:
        if not line.startswith(("{", "algo=")):
            print(line, flush=True)
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    logged, summary = [r for r in rows if "iter" in r], rows[-1]
    for r in logged:
        if r["iter"] in (1, logged[-1]["iter"]) or r["iter"] % show_every == 0:
            print(json.dumps(r), flush=True)
    print(json.dumps(summary), flush=True)
    return logged, summary, launches


def check_rows(logged: list[dict], iterations: int,
               keys: tuple[str, ...] = ("loss", "pg_loss", "v_loss", "entropy")) -> None:
    """Every iteration 1..`iterations` logged or the first and last; the
    losses `keys` finite on every logged row."""
    import math

    assert logged[0]["iter"] == 1 and logged[-1]["iter"] == iterations, (logged[0], logged[-1])
    for r in logged:
        for k in keys:
            assert r[k] is not None and math.isfinite(r[k]), (r["iter"], k, r[k])


def per_iteration(logged: list[dict], summary: dict, after: int = 1) -> tuple[float, float]:
    """(host seconds per iteration from the first logged row at or after
    iteration `after` to the last, evals left out; env steps per
    iteration)."""
    rows = [r for r in logged if r["iter"] >= after]
    first, last = rows[0], rows[-1]
    per_iter_s = (last["wall_s"] - first["wall_s"]) / (last["iter"] - first["iter"])
    return per_iter_s, summary["env_steps"] / summary["iterations"]


def graph_timing(logged: list[dict], summary: dict) -> str:
    """ms/iteration and env-steps/s of a run through the loop's CUDA graph:
    over the whole run after the first iteration (warm-up and capture
    included) and over the replays after the capture."""
    from actor_critic_tpu_torch.algos import loop

    per_iter_s, steps_per_iter = per_iteration(logged, summary)
    replay_s, _ = per_iteration(logged, summary, after=loop.WARMUP_ITERATIONS + 2)
    return (f"{per_iter_s * 1e3:.3f} ms/iteration after the first "
            f"({steps_per_iter / per_iter_s:.0f} env-steps/s), {replay_s * 1e3:.3f} ms/iteration "
            f"over the replays after the capture ({steps_per_iter / replay_s:.0f} env-steps/s)")


def run_a2c_cartpole() -> dict[str, int]:
    """Train the a2c_cartpole preset at full width through the CLI's main(),
    the step replayed as a CUDA graph; returns each kernel's launches during
    that run."""
    n = MAIN_PATH_ITERATIONS
    logged, summary, launches = drive(
        ["--preset", "a2c_cartpole", "--iterations", str(n), "--log-every", "10",
         "--eval-every", str(n), "--seed", "0"], show_every=10)
    check_rows(logged, n)
    first, last = logged[0], logged[-1]
    assert launches == {"gae": n, "vtrace": 0}, launches
    assert last["mean_finished_return"] > first["mean_finished_return"], (
        first["mean_finished_return"], last["mean_finished_return"])
    assert last.get("eval_return") is not None, last
    _, steps_per_iter = per_iteration(logged, summary)
    print(
        f"main path a2c_cartpole (CUDA graph): {n} iterations of {steps_per_iter:.0f} env steps, "
        f"{graph_timing(logged, summary)}; mean_finished_return "
        f"{first['mean_finished_return']:.3f} -> {last['mean_finished_return']:.3f}, "
        f"greedy eval {last['eval_return']:.3f}; launches {launches}",
        flush=True,
    )
    return launches


def run_ppo_cartpole() -> dict[str, int]:
    """Train the ppo_cartpole preset at full width (E=256, T=128) through the
    CLI's main(), the step replayed as a CUDA graph, with a greedy eval every
    5 iterations: the best eval at iterations 20, 25 and 30 must reach 400
    (tests/test_ppo.py's bar). Returns each kernel's launches during that
    run."""
    n = PPO_ITERATIONS
    logged, summary, launches = drive(
        ["--preset", "ppo_cartpole", "--iterations", str(n), "--eval-every", "5",
         "--seed", "0"], show_every=5)
    check_rows(logged, n)
    assert launches == {"gae": n, "vtrace": 0}, launches
    evals = {r["iter"]: r["eval_return"] for r in logged if "eval_return" in r}
    best = max(evals[i] for i in (20, 25, 30))
    _, steps_per_iter = per_iteration(logged, summary)
    print(
        f"main path ppo_cartpole (CUDA graph): {n} iterations of {steps_per_iter:.0f} env steps, "
        f"{graph_timing(logged, summary)}; greedy evals {evals}, best at 20/25/30 {best:.3f}; "
        f"launches {launches}",
        flush=True,
    )
    assert best >= 400.0, f"ppo_cartpole did not learn CartPole: best greedy eval {best}"
    return launches


def run_impala_pong() -> dict[str, int]:
    """Train the impala_pong preset at full width (E=64, T=20, 84 px) through
    the CLI's main(), the step replayed as a CUDA graph, every iteration
    logged; returns each kernel's launches during that run."""
    import math

    n = IMPALA_ITERATIONS
    logged, summary, launches = drive(
        ["--preset", "impala_pong", "--iterations", str(n), "--log-every", "1",
         "--eval-every", str(n), "--seed", "0"], show_every=10)
    check_rows(logged, n)
    assert [r["iter"] for r in logged] == list(range(1, n + 1))
    assert launches == {"gae": 0, "vtrace": n}, launches
    for r in logged:
        assert 0.0 < r["mean_rho"] <= 1.0, (r["iter"], r["mean_rho"])
    episodes = sum(r["episodes_finished"] for r in logged)
    assert episodes >= 64, f"only {episodes} episodes finished in {n} iterations"
    ev = logged[-1].get("eval_return")
    assert ev is not None and math.isfinite(ev), logged[-1]
    per_iter_s, steps_per_iter = per_iteration(logged, summary)
    print(
        f"main path impala_pong (CUDA graph): {n} iterations of {steps_per_iter:.0f} env steps, "
        f"{graph_timing(logged, summary)}; {episodes:.0f} episodes finished, "
        f"mean_rho {min(r['mean_rho'] for r in logged):.6f}..{max(r['mean_rho'] for r in logged):.6f}, "
        f"greedy eval {ev:.3f}; launches {launches}",
        flush=True,
    )
    return launches


def run_a3c_pong() -> dict[str, int]:
    """The same trainer with correction="none": GAE, not V-trace, on its path."""
    n = A3C_ITERATIONS
    logged, summary, launches = drive(
        ["--preset", "a3c_pong", "--iterations", str(n), "--log-every", "1", "--seed", "0"],
        show_every=1)
    check_rows(logged, n)
    assert launches == {"gae": n, "vtrace": 0}, launches
    assert all(r["mean_rho"] == 1.0 for r in logged), logged
    per_iter_s, _ = per_iteration(logged, summary)
    print(f"main path a3c_pong (warmed: CUDA graph from iteration 1): {n} iterations, "
          f"{per_iter_s * 1e3:.3f} ms/iteration after the first; launches {launches}", flush=True)
    return launches


def run_a2c_mixture() -> dict[str, int]:
    """Train the a2c_mixture preset at full width (E=1024, T=32, four env
    types) through the CLI's main(), the step replayed as a CUDA graph, a
    greedy eval and the per-type eval matrix every MIXTURE_EVAL_EVERY
    iterations. GAE's launches, counted on the card, must equal the
    iterations and V-trace's be 0; every metric finite; all four types live
    in the trained fleet; the eval matrix finite. Returns the launches."""
    import math

    from actor_critic_tpu_torch.envs.mixture import SOLVE_BARS, eval_matrix_row

    n = MIXTURE_ITERATIONS
    logged, summary, launches = drive(
        ["--preset", "a2c_mixture", "--iterations", str(n), "--log-every", "10",
         "--eval-every", str(MIXTURE_EVAL_EVERY), "--seed", "0"], show_every=10)
    check_rows(logged, n)
    assert launches == {"gae": n, "vtrace": 0}, launches
    for k, v in summary.items():
        assert not isinstance(v, float) or math.isfinite(v), (k, v)
    members = tuple(SOLVE_BARS)
    for r in (r for r in logged if "eval_return" in r):
        shares = {m: r[f"fleet_share_{m}"] for m in members}
        matrix = {m: r[f"eval_return_{m}"] for m in members}
        assert all(s > 0 for s in shares.values()), (r["iter"], shares)
        assert all(v is not None and math.isfinite(v) for v in matrix.values()), (r["iter"], matrix)
        row = {k: v for m in members for k, v in eval_matrix_row(m, matrix[m]).items()}
        print(f"a2c_mixture eval at iteration {r['iter']}: greedy eval {r['eval_return']:.3f}; "
              f"per-type eval matrix {row}; fleet shares {shares}", flush=True)
    _, steps_per_iter = per_iteration(logged, summary)
    first, last = logged[0], logged[-1]
    print(
        f"main path a2c_mixture (CUDA graph): {n} iterations of {steps_per_iter:.0f} env steps, "
        f"{graph_timing(logged, summary)}; mean_finished_return "
        f"{first['mean_finished_return']:.3f} -> {last['mean_finished_return']:.3f}; "
        f"launches {launches} ({launches['gae'] / n:.0f} GAE launch per iteration)",
        flush=True,
    )
    return launches


def run_a2c_mixture_curriculum() -> None:
    """a2c_mixture with `--curriculum` at a threshold the first eval
    crosses, installing weights 0,0,0,1 (the maze alone): the first eval
    (iteration 4, a graph replay) advances the stage and the state hook
    writes the weights before iteration 5. The install must reach the
    replayed graph: the stage read back from the device at the last
    iteration is 1, and the maze's share of the fleet has risen since
    iteration 4 (episode ends redraw types from the installed weights)."""
    n = CURRICULUM_ITERATIONS
    logged, _, launches = drive(
        ["--preset", "a2c_mixture", "--iterations", str(n), "--eval-every", "4",
         "--curriculum=-1e9:0,0,0,1", "--seed", "1"], show_every=4)
    check_rows(logged, n)
    assert launches == {"gae": n, "vtrace": 0}, launches
    rows = {r["iter"]: r for r in logged}
    before, after = rows[4], rows[n]
    assert before["curriculum_stage"] == 1 and before["fleet_stage"] == 0, before
    assert after["fleet_stage"] == 1, after
    assert after["fleet_share_maze"] > before["fleet_share_maze"], (before, after)
    print(
        f"curriculum (a2c_mixture, {n} iterations, install after iteration 4): stage on the "
        f"device {before['fleet_stage']} -> {after['fleet_stage']}; maze share "
        f"{before['fleet_share_maze']:.4f} -> {after['fleet_share_maze']:.4f}; launches {launches}",
        flush=True,
    )


def final_checkpoint(ckpt_dir: str, step: int) -> dict:
    import torch

    return torch.load(f"{ckpt_dir}/{step}/state.pt", map_location="cpu", weights_only=True)


def checkpoint_diff(a: dict, b: dict) -> tuple[float, int]:
    """(largest absolute difference over every carried tensor of two
    checkpoints, 0 or 1 for the generator's state equal or not)."""
    assert sorted(a["tensors"]) == sorted(b["tensors"])
    worst = max(float((a["tensors"][k].double() - b["tensors"][k].double()).abs().max())
                for k in a["tensors"])
    return worst, int(not bool((a["generator"] == b["generator"]).all()))


def run_resume(preset_name: str, extra: list[str]) -> None:
    """`train.main` for RESUME_ITERATIONS iterations straight, and for
    RESUME_AT then `--resume` to RESUME_ITERATIONS from the checkpoint (a
    fresh init restored in place, its own warm-up and capture), both
    through the CUDA graph; the two final checkpoints must agree at 0.0 over
    every carried tensor and the generator's state, and the resumed leg's
    launches be its iterations. With a curriculum (`extra`), the stage is
    crossed at the first leg's eval and installed before its save: the
    resumed leg reads stage 1 back from the device and does not re-fire."""
    import shutil

    n, k = RESUME_ITERATIONS, RESUME_AT
    base = ["--preset", preset_name, "--seed", "3", "--log-every", "4", *extra]
    dirs = {leg: f"{SCRATCH}/resume_{preset_name}_{leg}" for leg in ("straight", "legs")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    kernel = "vtrace" if preset_name == "impala_pong" else "gae"
    t0 = time.perf_counter()
    straight, _, l_straight = drive(base + ["--iterations", str(n), "--ckpt-dir", dirs["straight"],
                                            "--save-every", "0"], show_every=n)
    _, _, l_first = drive(base + ["--iterations", str(k), "--ckpt-dir", dirs["legs"],
                                  "--save-every", str(k)], show_every=n)
    resumed, _, l_resumed = drive(base + ["--iterations", str(n), "--ckpt-dir", dirs["legs"],
                                          "--save-every", str(k), "--resume"], show_every=n)
    worst, gen_differs = checkpoint_diff(final_checkpoint(dirs["straight"], n),
                                         final_checkpoint(dirs["legs"], n))
    rows = {r["iter"]: r for r in resumed}
    stage = f"; stage read back after the resume {rows[n]['fleet_stage']}" if extra else ""
    print(f"resume {preset_name}: {n} straight vs {k} + resumed {n - k}, through the CUDA graph: "
          f"max abs difference {worst:.3e} over every carried tensor, generator state "
          f"{'equal' if not gen_differs else 'DIFFERENT'}; {kernel} launches {l_straight[kernel]} / "
          f"{l_first[kernel]} + {l_resumed[kernel]}{stage}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    assert worst == 0.0 and not gen_differs, (worst, gen_differs)
    assert (l_straight[kernel], l_first[kernel], l_resumed[kernel]) == (n, k, n - k)
    assert sorted(rows) == [n], sorted(rows)
    if extra:
        straight_rows = {r["iter"]: r for r in straight}
        assert straight_rows[k]["curriculum_stage"] == 1 and rows[n]["fleet_stage"] == 1, rows
        assert rows[n]["curriculum_stage"] == 1
        strip = lambda r: {key: v for key, v in r.items() if key != "wall_s"}
        assert strip(rows[n]) == strip(straight_rows[n]), (rows[n], straight_rows[n])


def run_chunk() -> None:
    """`--chunk 4` against `--chunk 1` on a2c_cartpole at full width through
    `train.main`, CHUNK_ITERATIONS iterations: warmed, three replays of the
    4-step graph (with `--chunk 1`, twelve of the one-step graph). The final
    checkpoints agree at 0.0 and GAE runs once an iteration in both."""
    import shutil

    n = CHUNK_ITERATIONS
    out = {}
    for chunk in (1, CHUNK):
        d = f"{SCRATCH}/chunk{chunk}"
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        logged, summary, launches = drive(
            ["--preset", "a2c_cartpole", "--iterations", str(n), "--chunk", str(chunk),
             "--ckpt-dir", d, "--save-every", "0", "--log-every", str(CHUNK)], show_every=n)
        out[chunk] = (final_checkpoint(d, n), launches, logged, summary,
                      time.perf_counter() - t0)
    (s1, l1, rows1, sum1, t1), (s4, l4, rows4, sum4, t4) = out[1], out[CHUNK]
    worst, gen_differs = checkpoint_diff(s1, s4)
    per = lambda rows: (rows[-1]["wall_s"] - rows[-2]["wall_s"]) / CHUNK * 1e3
    print(f"--chunk {CHUNK} vs --chunk 1, a2c_cartpole, {n} iterations: max abs difference "
          f"{worst:.3e} over every carried tensor, generator state "
          f"{'equal' if not gen_differs else 'DIFFERENT'}; GAE launches {l4['gae']} (chunk 1: "
          f"{l1['gae']}); {per(rows4):.3f} ms/iteration over the last chunk replay, "
          f"{per(rows1):.3f} over the last 4 one-step replays; {t4:.1f} s (chunk 1: {t1:.1f} s)",
          flush=True)
    assert worst == 0.0 and not gen_differs, (worst, gen_differs)
    assert l1 == l4 == {"gae": n, "vtrace": 0}, (l1, l4)
    assert {k: v for k, v in sum1.items() if k != "wall_s"} == {
        k: v for k, v in sum4.items() if k != "wall_s"}


def check_impala_learns() -> None:
    """IMPALA with a 2-step actor lag on the two-state MDP at
    tests/test_impala.py's shape (E=16, T=8, hidden (32,), lr 3e-3, entropy
    1e-3, 800 iterations), on the card: the greedy policy picks the optimal
    action 1 in both states and the critic heads toward V* = 100."""
    import torch

    from actor_critic_tpu_torch.algos import impala
    from actor_critic_tpu_torch.envs import make_two_state_mdp

    env = make_two_state_mdp()
    cfg = impala.ImpalaConfig(num_envs=16, rollout_steps=8, hidden=(32,), lr=3e-3,
                              actor_refresh_every=2, entropy_coef=0.001)
    t0 = time.perf_counter()
    state, metrics = impala.train(env, cfg, num_iterations=800, seed=0, device="cuda")
    with torch.no_grad():
        dist, values = state.net(torch.eye(2, device="cuda"))
    probs = torch.softmax(dist.logits, -1).cpu()
    values = values.cpu()
    print(f"impala learning check (two-state MDP, 800 iterations, "
          f"{time.perf_counter() - t0:.2f} s): pi(a=1) = {probs[0, 1]:.4f}, {probs[1, 1]:.4f}; "
          f"V = {values[0]:.3f}, {values[1]:.3f}; last mean_rho {float(metrics['mean_rho']):.4f}",
          flush=True)
    assert float(probs[0, 1]) > 0.8 and float(probs[1, 1]) > 0.8, probs
    assert 50.0 < float(values[0]) <= 110.0, values


# ------------------------------------------------------------------ off-policy
# The MuJoCo presets' learners on `jax:pendulum`, each at its published
# width (E=1, K=J=64, batch 256, hidden (256, 256), a 1M-transition ring).
OFFPOLICY_PRESETS = ("ddpg_walker2d", "td3_walker2d", "sac_humanoid")
OFFPOLICY_ENV = "jax:pendulum"
OFFPOLICY_GRAPH_ITERATIONS = 6   # 2 eager, a capture, replays; the gate opens at 4
OFFPOLICY_GRAPH_WARMUP = 128     # env steps: iterations 1-2; the 256-row batch is in at 4
# The off-policy presets' 10,000-step warm-up, cut for the main-path runs:
# the gate still opens inside the replays (iteration 32 of 64 env steps),
# and the iterations cut are replays with the gate shut, which run the same
# graph as the ones kept.
OFFPOLICY_CUT_WARMUP = 2000
OFFPOLICY_MAIN_ITERATIONS = 44
SAC_LEARN_ITERATIONS, SAC_LEARN_EVAL_EVERY = 1000, 500  # the eval at 1000 read -169.5 on an H100
HUMANOID_OBS, HUMANOID_ACT = 348, 17  # Humanoid-v5 (gymnasium 1.2.2)


def offpolicy_setup(preset_name: str, **overrides):
    """(module, config, env) of an off-policy preset's learner on
    `jax:pendulum`, `overrides` applied to its config."""
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS[preset_name]
    cfg = dataclasses.replace(preset.config, **overrides)
    return train.ALGOS[preset.algo], cfg, train.make_env(OFFPOLICY_ENV, {})


def check_offpolicy_graph_equals_eager(preset_name: str, bf16: bool = False) -> None:
    """The loop's CUDA-graph path against eager execution for an off-policy
    preset's learner on Pendulum at full width, with the warm-up cut to 128
    env steps: OFFPOLICY_GRAPH_ITERATIONS iterations each way from one seed.
    Every carried tensor (the 1M-slot ring, its cursor, count and stats,
    both nets, the targets, every Adam state, log α, the counts), the last
    metrics and the generator's state agree at 1e-6 (expected 0.0). The
    update count is read after every iteration: its first rise must fall on
    a replayed iteration (the gate opens on the device, not at capture);
    for TD3 the actor's Adam count is half the critic's. With `bf16` the
    actor and critic compute in bf16."""
    import torch

    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.algos.common import carried_tensors

    mod, cfg, env = offpolicy_setup(preset_name, warmup_steps=OFFPOLICY_GRAPH_WARMUP,
                                    bf16_compute=bf16)
    n = OFFPOLICY_GRAPH_ITERATIONS
    runs = {}
    for capturable in (False, True):
        counts: list[int] = []

        def hook(it, state, counts=counts):
            if it > 0:
                counts.append(int(state.learner.update_count))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = loop.fused_train_loop(
            mod.make_train_step, mod.init_state, env, cfg, n, seed=5, device="cuda",
            capturable=capturable, state_hook=hook)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tensors = dict(carried_tensors(state), generator=state.generator.get_state())
        tensors.update({f"metric {k}": v for k, v in metrics.items()})
        runs[capturable] = (tensors, counts, seconds, state)
    (eager, eager_counts, eager_s, _), (graph, counts, graph_s, state) = runs[False], runs[True]
    assert sorted(eager) == sorted(graph)
    diffs = {k: float((graph[k].double() - eager[k].double()).abs().max()) for k in eager}
    worst = max(diffs.values())
    first_rise = next(i + 1 for i, c in enumerate(counts) if c > 0)
    learner = state.learner
    actor_count, critic_count = int(learner.actor_opt.count), int(learner.critic_opt.count)
    print(
        f"graph vs eager, {preset_name}{' bf16' if bf16 else ''} on {OFFPOLICY_ENV} "
        f"(E={cfg.num_envs}, K=J="
        f"{cfg.steps_per_iter}, batch {cfg.batch_size}, ring {cfg.buffer_capacity}, warm-up "
        f"{cfg.warmup_steps}), {n} iterations ({loop.WARMUP_ITERATIONS} eager, then replays): "
        f"max abs difference {worst:.3e} over {len(diffs)} tensors (worst: "
        f"{max(diffs, key=diffs.get)}), the generator's state "
        f"{'equal' if diffs['generator'] == 0 else 'DIFFERENT'}; update_count by iteration "
        f"{counts} (eager {eager_counts}), first rise at iteration {first_rise}; Adam counts "
        f"actor {actor_count}, critic {critic_count}; {graph_s:.2f} s (eager {eager_s:.2f} s, "
        f"capture included)", flush=True)
    assert worst <= 1e-6, {k: d for k, d in diffs.items() if d > 1e-6}
    assert counts == eager_counts, (counts, eager_counts)
    assert first_rise > loop.WARMUP_ITERATIONS, first_rise
    assert counts[-1] == (n - first_rise + 1) * cfg.updates_per_iter, counts
    if getattr(cfg, "policy_delay", 1) == 2:
        assert 2 * actor_count == critic_count, (actor_count, critic_count)
    assert learner.actor.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)


def run_offpolicy_main(preset_name: str) -> None:
    """An off-policy preset's learner at full width through `train.main`
    (`--preset <name> --env jax:pendulum`) for OFFPOLICY_MAIN_ITERATIONS
    iterations, across the preset's warm-up cut to OFFPOLICY_CUT_WARMUP
    env steps, the step
    replayed as a CUDA graph from iteration 1 (warmed); the final checkpoint gives
    back the update count (it must have risen) and the ring's size. Prints
    ms an iteration over the replays before and after the gate opens,
    env-steps/s and updates/s."""
    import math
    import shutil

    n = OFFPOLICY_MAIN_ITERATIONS
    d = f"{SCRATCH}/main_{preset_name}"
    shutil.rmtree(d, ignore_errors=True)
    logged, summary, launches = drive(
        ["--preset", preset_name, "--env", OFFPOLICY_ENV, "--iterations", str(n),
         "--log-every", "1", "--eval-every", str(n), "--seed", "0", "--ckpt-dir", d,
         "--save-every", "0", "--set", f"warmup_steps={OFFPOLICY_CUT_WARMUP}"], show_every=50)
    check_rows(logged, n, keys=("critic_loss", "actor_loss", "q_mean"))
    assert launches == {"gae": 0, "vtrace": 0}, launches
    saved = final_checkpoint(d, n)["tensors"]
    updates, size = int(saved["learner.update_count"]), int(saved["learner.replay size"])
    env_steps = int(saved["env_steps"])
    _, cfg, _ = offpolicy_setup(preset_name, warmup_steps=OFFPOLICY_CUT_WARMUP)
    opened = -(-cfg.warmup_steps // (cfg.steps_per_iter * cfg.num_envs))  # iteration 32
    assert updates == (n - opened + 1) * cfg.updates_per_iter, (updates, opened)
    assert size == env_steps == n * cfg.steps_per_iter * cfg.num_envs, (size, env_steps)
    for k, v in summary.items():
        assert not isinstance(v, float) or math.isfinite(v), (k, v)
    rows = {r["iter"]: r for r in logged}
    ev = logged[-1].get("eval_return")
    assert ev is not None and math.isfinite(ev), logged[-1]
    per = lambda a, b: (rows[b]["wall_s"] - rows[a]["wall_s"]) / (b - a)
    before, after = per(3, opened - 1), per(opened + 1, n)
    spi = cfg.steps_per_iter * cfg.num_envs
    print(
        f"main path {preset_name} on {OFFPOLICY_ENV} (warmed: a CUDA graph from iteration 1): {n} "
        f"iterations of {spi} env steps and {cfg.updates_per_iter} updates; iteration 1 (the warm-up "
        f"included) {rows[1]['wall_s'] * 1e3:.1f} ms, iteration 2 {per(1, 2) * 1e3:.1f} ms; "
        f"{before * 1e3:.3f} ms/iteration over the replays before the gate opens (3-{opened - 1}),"
        f" {after * 1e3:.3f} after it ({opened + 1}-{n}): {spi / after:.0f} env-steps/s, "
        f"{cfg.updates_per_iter / after:.0f} updates/s; update_count {updates} (the gate opened "
        f"at iteration {opened}), ring size {size}; critic_loss {rows[n]['critic_loss']:.4f}, "
        f"greedy eval {ev:.3f}", flush=True)


def run_offpolicy_learning() -> None:
    """Learning on the card through the CUDA graph: SAC on Pendulum at
    tests/test_sac.py::test_sac_learns_jax_pendulum_fused's config (E=8,
    K=J=8, hidden (128, 128), batch 128, warm-up 1,000; 1,000 iterations, a
    greedy eval of 8 envs × 200 steps every 500; best >= -250), and TD3 on
    the point mass at tests/test_ddpg.py::test_td3_learns_point_mass's
    (250 iterations, seed 2; greedy return of 32 envs × 16 steps > -1.0)."""
    import torch

    from actor_critic_tpu_torch.algos import ddpg, loop, sac
    from actor_critic_tpu_torch.envs import make_pendulum, make_point_mass

    env = make_pendulum()
    cfg = sac.SACConfig(num_envs=8, steps_per_iter=8, updates_per_iter=8, hidden=(128, 128),
                        batch_size=128, warmup_steps=1000)
    eval_fn = sac.make_eval_fn(env, cfg)
    gen = torch.Generator(device="cuda")
    evals = {}

    def hook(it, state):
        if it > 0 and it % SAC_LEARN_EVAL_EVERY == 0:
            gen.manual_seed(1)
            evals[it] = float(eval_fn(state, gen, 8, 200))

    t0 = time.perf_counter()
    loop.fused_train_loop(sac.make_train_step, sac.init_state, env, cfg, SAC_LEARN_ITERATIONS,
                          seed=0, device="cuda", capturable=True, state_hook=hook)
    torch.cuda.synchronize()
    sac_s = time.perf_counter() - t0
    best = max(evals.values())
    print(f"SAC learns Pendulum on the card ({SAC_LEARN_ITERATIONS} iterations through the "
          f"graph, {sac_s:.1f} s with the evals): greedy evals {evals}, best {best:.3f} "
          f"(bar -250)", flush=True)
    assert best >= -250.0, evals

    env = make_point_mass()
    cfg = ddpg.td3_config(num_envs=16, steps_per_iter=4, updates_per_iter=4,
                          buffer_capacity=32768, batch_size=64, hidden=(32, 32), actor_lr=1e-3,
                          critic_lr=1e-3, warmup_steps=256, exploration_noise=0.2)
    t0 = time.perf_counter()
    state, _ = ddpg.train(env, cfg, num_iterations=250, seed=2, device="cuda")
    gen.manual_seed(99)
    ret = float(ddpg.make_eval_fn(env, cfg)(state, gen, 32, 16))
    print(f"TD3 learns the point mass on the card (250 iterations through the graph, "
          f"{time.perf_counter() - t0:.1f} s): greedy return {ret:.4f} (bar -1.0)", flush=True)
    assert ret > -1.0, ret


def run_offpolicy_resume_and_chunk() -> None:
    """`td3_walker2d` on Pendulum with `--replay-dtype mixed` (warm-up cut to
    128 env steps so that the legs update): RESUME_ITERATIONS straight
    against RESUME_AT plus a resumed rest through `train.main`, the final
    checkpoints equal at 0.0 (the int8 ring, its stats, both targets, both
    Adam states, the counts) and the generator's state equal; then
    `--chunk 4` against `--chunk 1` for `sac_humanoid` on Pendulum over
    CHUNK_ITERATIONS, the same."""
    import shutil

    import torch

    n, k = RESUME_ITERATIONS, RESUME_AT
    base = ["--preset", "td3_walker2d", "--env", OFFPOLICY_ENV, "--replay-dtype", "mixed",
            "--set", f"warmup_steps={OFFPOLICY_GRAPH_WARMUP}", "--seed", "3"]
    dirs = {leg: f"{SCRATCH}/resume_td3_{leg}" for leg in ("straight", "legs")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    drive(base + ["--iterations", str(n), "--ckpt-dir", dirs["straight"], "--save-every", "0"],
          show_every=n)
    drive(base + ["--iterations", str(k), "--ckpt-dir", dirs["legs"], "--save-every", str(k)],
          show_every=n)
    drive(base + ["--iterations", str(n), "--ckpt-dir", dirs["legs"], "--save-every", str(k),
                  "--resume"], show_every=n)
    a, b = final_checkpoint(dirs["straight"], n), final_checkpoint(dirs["legs"], n)
    worst, gen_differs = checkpoint_diff(a, b)
    updates = int(a["tensors"]["learner.update_count"])
    print(f"resume td3_walker2d on {OFFPOLICY_ENV} (mixed ring): {n} straight vs {k} + resumed "
          f"{n - k}, through the CUDA graph: max abs difference {worst:.3e} over "
          f"{len(a['tensors'])} tensors, generator state "
          f"{'equal' if not gen_differs else 'DIFFERENT'}; update_count {updates}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert worst == 0.0 and not gen_differs, (worst, gen_differs)
    assert updates > 0 and a["tensors"]["learner.replay storage.obs"].dtype == torch.int8

    n = CHUNK_ITERATIONS
    out = {}
    for chunk in (1, CHUNK):
        d = f"{SCRATCH}/chunk_sac{chunk}"
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        _, summary, _ = drive(
            ["--preset", "sac_humanoid", "--env", OFFPOLICY_ENV, "--iterations", str(n),
             "--set", f"warmup_steps={OFFPOLICY_GRAPH_WARMUP}", "--chunk", str(chunk),
             "--ckpt-dir", d, "--save-every", "0", "--log-every", str(CHUNK)],
            show_every=n)
        out[chunk] = (final_checkpoint(d, n), summary, time.perf_counter() - t0)
    (s1, sum1, t1), (s4, sum4, t4) = out[1], out[CHUNK]
    worst, gen_differs = checkpoint_diff(s1, s4)
    print(f"--chunk {CHUNK} vs --chunk 1, sac_humanoid on {OFFPOLICY_ENV}, {n} iterations: max "
          f"abs difference {worst:.3e} over every carried tensor, generator state "
          f"{'equal' if not gen_differs else 'DIFFERENT'}; update_count "
          f"{int(s4['tensors']['learner.update_count'])}; {t4:.1f} s (chunk 1: {t1:.1f} s)",
          flush=True)
    assert worst == 0.0 and not gen_differs, (worst, gen_differs)
    assert {k: v for k, v in sum1.items() if k != "wall_s"} == {
        k: v for k, v in sum4.items() if k != "wall_s"}


def check_humanoid_update_loop() -> None:
    """`sac_humanoid`'s learner at Humanoid-v5's shapes (obs 348, action 17;
    hidden (256, 256), batch 256) over a full 1M-transition ring, in `fp32`
    and in `mixed`: the ring filled by `add_batch` with seeded synthetic
    transitions (on the card, 65,536 a call), then its J=64 updates
    captured as one CUDA graph and replayed. Prints ms an update (CUDA
    events over replays), kernel launches and device busy time per replay
    (torch.profiler), the ring's bytes and `torch.cuda.max_memory_allocated`;
    the losses stay finite and the update count advances by 64 a replay.
    The peak counts what the process held before the phase (earlier
    phases' graph pools and caches), so the peak above that is printed
    beside it."""
    import math

    import torch

    from actor_critic_tpu_torch import replay
    from actor_critic_tpu_torch.algos import loop, sac
    from actor_critic_tpu_torch.algos.common import OffPolicyTransition
    from actor_critic_tpu_torch.config import PRESETS

    from actor_critic_tpu_torch.algos.ddpg import example_transition

    base = PRESETS["sac_humanoid"].config
    for name, (obs_dim, act_dim) in (("Pendulum", (3, 1)),
                                     ("Humanoid-v5", (HUMANOID_OBS, HUMANOID_ACT))):
        sizes = []
        for mode in replay.quantize.MODES:
            one = replay.init(example_transition((obs_dim,), act_dim, torch.device("cpu")), 1,
                              replay.offpolicy_codecs(mode))
            r = replay.quantize.capacity_report(one, replay.offpolicy_codecs(mode))
            sizes.append(f"{mode} {r['bytes_per_transition']} B ({r['capacity_multiplier']}x)")
        print(f"ring bytes a transition at {name}'s shapes (obs {obs_dim}, action {act_dim}): "
              f"{', '.join(sizes)}", flush=True)
    for mode in ("fp32", "mixed"):
        held = torch.cuda.memory_allocated()  # earlier phases' graphs and caches
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(base, replay_dtype=mode)
        learner = sac.init_learner((HUMANOID_OBS,), HUMANOID_ACT, cfg,
                                   torch.Generator().manual_seed(0), "cuda")
        codecs = replay.offpolicy_codecs(mode)
        g = torch.Generator(device="cuda").manual_seed(1)
        chunk = 1 << 16
        t0 = time.perf_counter()
        for _ in range(-(-cfg.buffer_capacity // chunk)):
            obs = torch.randn((chunk, HUMANOID_OBS), generator=g, device="cuda")
            batch = OffPolicyTransition(
                obs=obs,
                action=torch.rand((chunk, HUMANOID_ACT), generator=g, device="cuda") * 2 - 1,
                reward=torch.randn((chunk,), generator=g, device="cuda"),
                next_obs=obs + 0.1 * torch.randn((chunk, HUMANOID_OBS), generator=g,
                                                 device="cuda"),
                terminated=(torch.rand((chunk,), generator=g, device="cuda") < 0.01).float(),
                done=(torch.rand((chunk,), generator=g, device="cuda") < 0.01).float())
            replay.add_batch(learner.replay, batch, codecs)
        torch.cuda.synchronize()
        fill_s = time.perf_counter() - t0
        report = replay.quantize.capacity_report(learner.replay, codecs)
        assert int(learner.replay.size) == cfg.buffer_capacity
        update_loop = sac.make_update_loop(HUMANOID_ACT, cfg)
        do_update = torch.ones((), dtype=torch.bool, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            update_loop(learner, do_update, g)  # warm-up: cuBLAS, tables, autograd
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(g)
        t0 = time.perf_counter()
        with loop.capture(graph):
            metrics = update_loop(learner, do_update, g)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        count0 = int(learner.update_count)
        ms = cuda_ms(graph.replay, iters=10, warmup=2)
        kernels, wall = profile_kernels(graph.replay, iters=1)
        busy_us = sum(us for _, us in kernels.values())
        launches = sum(c for c, _ in kernels.values())
        assert int(learner.update_count) == count0 + 13 * cfg.updates_per_iter
        values = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in values.values()), values
        peak = torch.cuda.max_memory_allocated()
        print(
            f"SAC update loop at Humanoid-v5's shapes (obs {HUMANOID_OBS}, action "
            f"{HUMANOID_ACT}, hidden {cfg.hidden}, batch {cfg.batch_size}), {mode} ring of "
            f"{cfg.buffer_capacity} ({report['bytes_per_transition']} B a transition, ring "
            f"{report['ring_bytes'] / 1e9:.3f} GB, {report['capacity_multiplier']}x fp32's "
            f"transitions a byte), filled in {fill_s:.2f} s: {cfg.updates_per_iter} updates "
            f"as one CUDA graph (capture {capture_s:.2f} s), {ms:.3f} ms a replay, "
            f"{ms / cfg.updates_per_iter * 1e3:.1f} us an update (CUDA events); "
            f"{launches:.0f} kernel launches a replay, device busy {busy_us / 1e3:.3f} ms "
            f"(torch.profiler); max_memory_allocated {peak / 1e9:.3f} GB, {(peak - held) / 1e9:.3f} "
            f"GB above the {held / 1e9:.3f} GB held before this ring; last critic_loss "
            f"{values['critic_loss']:.4f}, alpha {values['alpha']:.4f}", flush=True)
        del learner, graph, metrics


def profile_step(preset_name: str, n: int = 3, env_spec: str = "",
                 bf16: bool = False) -> tuple[dict, Optional[tuple]]:
    """Where a full-width train step of a preset goes, in one call (on
    `env_spec` instead of the preset's env where one is given): for an
    on-policy trainer, host-clock rollout and update times of `n` eager
    steps; then the step run eagerly and, for a capturable trainer, as
    replays of the loop's CUDA graph, each with its host-clock time per
    step over `n` steps (synchronised), and the graph's device busy time,
    busy share and kernel launches per step from torch.profiler over `n`
    more (the eager step is not profiled: the profiler's bookkeeping of its
    ~5,000–51,000 ops a step took longer than the steps). The busy share is
    the busy time over the unprofiled host-clock time. With `bf16` the
    networks compute in bf16, and for a capturable trainer only the graph
    is timed. Returns ({mode: (host-clock ms a step, kernel launches a
    step, device busy ms a step; None for the eager step's)}, (state,
    step, its `CapturedStep`) or None): a graph reads its
    state's tensors and generator and the env's tables (which the step
    holds), so all three are kept together."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS[preset_name]
    mod, cfg = train.ALGOS[preset.algo], dataclasses.replace(preset.config, bf16_compute=bf16)
    env = train.make_env(env_spec or preset.env, {} if env_spec else preset.env_kwargs)
    state = mod.init_state(env, cfg, seed=1, device="cuda")
    step = mod.make_train_step(env, cfg)
    name = f"{preset_name} bf16" if bf16 else preset_name
    side = torch.cuda.Stream()
    for _ in range(loop.WARMUP_ITERATIONS):
        loop.eager_step(step, state, side)
    torch.cuda.synchronize()
    graph_only = bf16 and mod.CAPTURABLE
    if hasattr(mod, "rollout") and not graph_only:
        opt = mod.make_optimizer(cfg)
        t_roll = t_upd = 0.0
        for _ in range(n):
            t0 = time.perf_counter()
            traj = mod.rollout(env, cfg, state)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mod.update(env, cfg, opt, state, traj)
            torch.cuda.synchronize()
            t_roll += t1 - t0
            t_upd += time.perf_counter() - t1
        print(
            f"{name} train step at E={cfg.num_envs}, T={cfg.rollout_steps} "
            f"(host clock, synchronised, eager): rollout {t_roll / n * 1e3:.3f} ms, "
            f"update {t_upd / n * 1e3:.3f} ms",
            flush=True,
        )
    modes = [] if graph_only else [("eager", lambda: step(state))]
    captured = None
    if mod.CAPTURABLE:
        captured = loop.CapturedStep(step, state)
        modes.append(("graph", captured.replay))
    out = {}
    for label, fn in modes:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        if label == "eager":
            out[label] = (host_ms, None, None)
            print(f"{name} {label}: {host_ms:.3f} ms/step (host clock, synchronised)",
                  flush=True)
            continue
        kernels, wall = profile_kernels(fn, iters=n)
        busy_us = sum(us for _, us in kernels.values())
        launches = sum(c for c, _ in kernels.values())
        out[label] = (host_ms, launches / n, busy_us / n / 1e3)
        if busy_us > 0:
            print(
                f"{name} {label}: {host_ms:.3f} ms/step (host clock, synchronised); "
                f"profiled {n} steps: wall {wall / n * 1e3:.3f} ms/step under the profiler, "
                f"device busy {busy_us / n / 1e3:.3f} ms/step "
                f"({busy_us / n / 1e3 / host_ms:.1%} of the unprofiled step), "
                f"{launches / n:.0f} kernel launches/step",
                flush=True,
            )
        else:
            print(f"{name} {label}: {host_ms:.3f} ms/step (host clock, synchronised); "
                  f"device time not measured (the profiler recorded none)", flush=True)
        for key, (count, us) in kernels.items():
            for kernel in ("gae_kernel", "vtrace_kernel"):
                if kernel in key:
                    print(f"{name} {label}: {kernel} {us / count:.3f} us a launch on the "
                          f"device (torch.profiler, {count} launches)", flush=True)
    return out, (state, step, captured) if captured is not None else None


# -- the host env path ----------------------------------------------------

HOST_MUJOCO_ENVS = {"ppo_halfcheetah": "HalfCheetah-v5", "ddpg_walker2d": "Walker2d-v5",
                    "td3_walker2d": "Walker2d-v5", "sac_humanoid": "Humanoid-v5"}
HOST_FALLBACK_ENV = "native:Pendulum-v1"  # the C++ engine, where MuJoCo is missing
HOST_PPO_ITERATIONS = 12     # two eager, a capture, then replays
HOST_LOG_EVERY = 4           # the main paths log (and so wait for the card) every 4th / 10th
HOST_OFFPOLICY_LOG_EVERY = 10  # iteration, so the iterations between overlap host and card
HOST_CHECK_ITERATIONS = 6    # the graph-vs-eager and upload checks: iterations 1-6
HOST_CHECK_AT = 4            # a replayed iteration
HOST_OFFPOLICY_ITERATIONS = 50  # the warm-up (OFFPOLICY_CUT_WARMUP) ends at iteration 32
HOST_RESUME_ITERATIONS = 3


def probe_host_envs() -> dict:
    """Whether gymnasium and MuJoCo import (with their versions) and the
    three MuJoCo envs of the presets reset; missing MuJoCo is reported, not
    failed. Then the C++ env engine is built (g++), and a failed build
    fails. Returns {preset: the env its host phases run on}."""
    from actor_critic_tpu_torch import native

    found = {}
    for mod in ("gymnasium", "mujoco"):
        try:
            found[mod] = __import__(mod).__version__
        except ImportError as e:
            found[mod] = None
            print(f"probe: {mod} does not import ({e})", flush=True)
    resets = {}
    if all(found.values()):
        import gymnasium as gym

        for env_id in sorted(set(HOST_MUJOCO_ENVS.values())):
            try:
                env = gym.make(env_id)
                obs, _ = env.reset(seed=0)
                env.close()
                resets[env_id] = tuple(obs.shape)
            except Exception as e:  # reported: the phases then run on the engine
                resets[env_id] = f"{type(e).__name__}: {e}"
    mujoco = all(found.values()) and all(isinstance(v, tuple) for v in resets.values())
    print(f"probe: gymnasium {found['gymnasium']}, mujoco {found['mujoco']}; resets {resets}; "
          f"the host phases run on {'MuJoCo' if mujoco else HOST_FALLBACK_ENV}", flush=True)
    t0 = time.perf_counter()
    native.load()
    lib = native.library_path()
    print(f"probe: native env engine built in {time.perf_counter() - t0:.2f} s (g++ "
          f"{' '.join(native.CXX_FLAGS)}) into {lib.relative_to(lib.parent.parent.parent)}",
          flush=True)
    return {p: (f"host:{e}" if mujoco else HOST_FALLBACK_ENV) for p, e in HOST_MUJOCO_ENVS.items()}


def host_split(logged: list[dict], after: int) -> str:
    """The mean split of the logged iterations from `after` on: collect,
    wait and dispatch on the host clock, upload and update on the device."""
    rows = [r for r in logged if r["iter"] >= after]
    mean = lambda k: sum(r[k] for r in rows) / len(rows)
    return (f"collect {mean('collect_s') * 1e3:.3f} ms, wait {mean('wait_s') * 1e3:.3f} ms, "
            f"dispatch {mean('dispatch_s') * 1e3:.3f} ms (host clock); upload "
            f"{mean('upload_ms'):.3f} ms, update {mean('update_ms'):.3f} ms (device, CUDA events)")


def graph_vs_eager(run) -> dict:
    """A host trainer's update (`run.update`, a replay by now) once eagerly
    and once as its graph from the same state and block: every tensor it
    writes, its metrics and the generator's state, the worst difference
    (expected 0.0); then one more replay timed on the host clock and one
    under torch.profiler. The state is put back after each."""
    import torch

    from actor_critic_tpu_torch.algos import loop

    assert run.update.captured is not None, "the update is not a graph yet"
    torch.cuda.synchronize()
    carried = run.carried()
    start = {k: t.clone() for k, t in carried.items()}
    gen = run.update.generator
    gen_start = gen.get_state()
    _, eager_metrics = loop.eager_step(run.update._step, run.update, run.update.stream)
    eager = {k: t.clone() for k, t in carried.items()}
    eager.update({f"metric {k}": v.clone() for k, v in eager_metrics.items()})
    eager_gen = gen.get_state()
    with torch.no_grad():
        for k, t in carried.items():
            t.copy_(start[k])
    gen.set_state(gen_start)
    graph_metrics = run.update.captured.replay()
    torch.cuda.synchronize()
    diffs = {k: float((t.double() - eager[k].double()).abs().max())
             for k, t in carried.items()}
    diffs.update({f"metric {k}": float((v.double() - eager[f'metric {k}'].double()).abs().max())
                  for k, v in graph_metrics.items()})
    out = dict(worst=max(diffs.values()), tensors=len(diffs),
               generator_equal=bool(torch.equal(gen.get_state(), eager_gen)))
    # One more replay from the same state: its host-clock time
    # (launch to synchronised end), its host time to return, and
    # its kernels under torch.profiler.
    for timed in (True, False):
        with torch.no_grad():
            for k, t in carried.items():
                t.copy_(start[k])
        gen.set_state(gen_start)
        if timed:
            t0 = time.perf_counter()
            run.update.captured.replay()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out.update(launch_ms=(t1 - t0) * 1e3, replay_ms=(time.perf_counter() - t0) * 1e3)
        else:
            kernels, _ = profile_kernels(run.update.captured.replay, iters=1)
            out.update(
                busy_ms=sum(us for _, us in kernels.values()) / 1e3,
                launches=sum(c for c, _ in kernels.values()))
    with torch.no_grad():
        for k, t in carried.items():
            t.copy_(start[k])
    gen.set_state(gen_start)
    return out


class HostContract:
    """An `iteration_hook` for a host trainer on the card, overlap on:

    - the upload: after each iteration's dispatch, a device clone of every
      static block buffer (in stream order after the update, before the
      next upload) and a host copy of the block; at the end each uploaded
      block must equal its host block bitwise;
    - the snapshot: the mirror's snapshot enqueued before iteration N+1's
      update must equal the acting module's parameters after update N
      (cloned on the device in stream order at iteration N's hook),
      bitwise, in the mirror's layout;
    - graph vs eager: at iteration `check_at` (a replay) the update runs
      once eagerly and once as the graph from the same state and block,
      and every tensor it writes, its metrics and the generator's state
      must agree at 0.0; the state is then put back.
    Nothing here waits for the device except the snapshot's own event and
    the graph-vs-eager check."""

    def __init__(self, module_of, check_at: int):
        self.module_of, self.check_at = module_of, check_at
        self.blocks: list[tuple[dict, dict]] = []
        self.params_after: dict[int, dict] = {}
        self.snapshots: dict[int, dict] = {}
        self.graph_vs_eager: dict = {}

    def __call__(self, it, run) -> None:
        self.blocks.append(({k: v.copy() for k, v in run.buffers.block().items()},
                            {k: v.clone() for k, v in run.buffers.static.items()}))
        module = self.module_of(run)
        self.params_after[it] = {k: p.detach().clone() for k, p in module.named_parameters()}
        if it > 1:
            tree = run.snapshot.params()
            self.snapshots[it] = {k: v.copy() for k, v in flat_tree(tree).items()}
        if it == self.check_at:
            self.graph_vs_eager = graph_vs_eager(run)

    def check(self, label: str) -> None:
        import numpy as np

        import torch

        torch.cuda.synchronize()
        fields = 0
        for host, device in self.blocks:
            assert sorted(host) == sorted(device), (sorted(host), sorted(device))
            for k, v in host.items():
                assert np.array_equal(device[k].cpu().numpy(), v), (label, k)
                fields += 1
        for it, tree in self.snapshots.items():
            want = mirror_layout(self.params_after[it - 1])
            assert sorted(tree) == sorted(want), (sorted(tree), sorted(want))
            for k, v in want.items():
                assert np.array_equal(tree[k], v), (label, it, k)
        g = self.graph_vs_eager
        print(f"host contract {label}: {len(self.blocks)} blocks uploaded, {fields} fields equal "
              f"to the host blocks bitwise; {len(self.snapshots)} mirror snapshots equal to the "
              f"parameters the update read, bitwise; graph vs eager on one block (iteration "
              f"{self.check_at}): max abs difference {g['worst']:.3e} over {g['tensors']} tensors "
              f"and metrics, the generator's state {'equal' if g['generator_equal'] else 'DIFFERENT'}; "
              f"one replay {g['replay_ms']:.3f} ms (host clock, synchronised; the launch call "
              f"returned after {g['launch_ms']:.3f} ms), device busy {g['busy_ms']:.3f} ms, "
              f"{g['launches']} kernel launches (torch.profiler)", flush=True)
        assert len(self.blocks) >= 4 and len(self.snapshots) >= 3, (len(self.blocks), len(self.snapshots))
        assert g["worst"] == 0.0 and g["generator_equal"], g


def flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def mirror_layout(params: dict) -> dict:
    """A module's parameters (by `named_parameters` name) as the mirror's
    flat tree: `weight` → `kernel`, transposed to [in, out]."""
    out = {}
    for k, t in params.items():
        path, _, leaf = k.rpartition(".")
        if leaf == "weight":
            out[f"params.{path}.kernel"] = t.t().contiguous().cpu().numpy()
        else:
            out[f"params.{k}"] = t.cpu().numpy()
    return out


def host_pool(preset_name: str, env: str):
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS[preset_name]
    cfg = preset.config
    return train.make_host_pool(env, preset.algo, cfg, 0), cfg


def run_host_ppo(env: str) -> int:
    """`ppo_halfcheetah` at its full width (E=8, T=256, 10 epochs × 32
    minibatches, hidden (64, 64)) on `env` through `train.main`, the update
    replayed as one CUDA graph from iteration 1 (warmed); then the same trainer
    under a `HostContract`
    (graph vs eager, the upload and the snapshot). Returns GAE's launches
    on the main path (one an iteration)."""
    import math

    n = HOST_PPO_ITERATIONS
    logged, summary, launches = drive(
        ["--preset", "ppo_halfcheetah", "--env", env, "--iterations", str(n), "--log-every",
         str(HOST_LOG_EVERY), "--eval-every", str(n), "--eval-envs", "4", "--eval-steps", "1000",
         "--seed", "0"], show_every=HOST_LOG_EVERY)
    check_rows(logged, n)
    assert launches == {"gae": n, "vtrace": 0}, launches
    assert math.isfinite(logged[-1]["eval_return"]), logged[-1]
    after = 2 * HOST_LOG_EVERY
    per_iter_s, steps = per_iteration(logged, summary, after=HOST_LOG_EVERY)
    print(f"main path ppo_halfcheetah on {env} (E=8, T=256, 10x32 minibatches, the update a CUDA "
          f"graph from iteration 1, warmed, logged every {HOST_LOG_EVERY}): {n} iterations, GAE launches "
          f"{launches['gae']}; iteration 1 (the warm-up included) {logged[0]['wall_s'] * 1e3:.1f} ms; "
          f"{per_iter_s * 1e3:.3f} ms/iteration over the replays {HOST_LOG_EVERY + 1}-{n} "
          f"({steps / per_iter_s:.0f} env-steps/s); split of iterations {after}, ..., {n} "
          f"{host_split(logged, after)}; greedy eval {logged[-1]['eval_return']:.2f}", flush=True)

    check_host_ppo_contract(env)
    return launches["gae"]


def run_telemetry_host_async(env: str) -> None:
    """The session on the host and async paths, in runs of their own (the
    main-path runs stay session-free, their ms the baselines of other
    phases): `ppo_halfcheetah` at full width on `env` through `train.main
    --telemetry-dir`, on the host for TELEMETRY_HOST_ITERATIONS iterations
    (`check_host_telemetry`), then `--async-actors 2 --data-plane device
    --async-correction vtrace` for TELEMETRY_ASYNC_BLOCKS consumed blocks
    at two epochs (what it checks does not depend on the update's depth),
    sampled every TELEMETRY_ASYNC_SAMPLE_S so that the short run writes
    ring rows, V-trace's launches counted (`check_async_telemetry`)."""
    import shutil

    n = TELEMETRY_HOST_ITERATIONS
    tel = f"{SCRATCH}/telemetry_host"
    shutil.rmtree(tel, ignore_errors=True)
    logged, _, launches = drive(
        ["--preset", "ppo_halfcheetah", "--env", env, "--iterations", str(n), "--log-every", "2",
         "--eval-every", str(n), "--eval-envs", "4", "--eval-steps", "1000", "--seed", "0",
         "--telemetry-dir", tel], show_every=n)
    check_rows(logged, n)
    assert launches == {"gae": n, "vtrace": 0}, launches
    check_host_telemetry(tel, n, env)

    n = TELEMETRY_ASYNC_BLOCKS
    tel = f"{SCRATCH}/telemetry_async"
    shutil.rmtree(tel, ignore_errors=True)
    logged, _, launches = drive(
        ["--preset", "ppo_halfcheetah", "--env", env, "--async-actors", str(ASYNC_ACTORS),
         "--iterations", str(n), "--log-every", "2", "--seed", "0", "--data-plane", "device",
         "--async-correction", "vtrace", "--set", "epochs=2", "--telemetry-dir", tel,
         "--telemetry-sample-s", str(TELEMETRY_ASYNC_SAMPLE_S)], show_every=n)
    check_rows(logged, n)
    check_async_kernel_launches(logged, launches, n, 1)
    print(f"telemetry async ppo_halfcheetah on {env} (two epochs): V-trace launches "
          f"{launches['vtrace']} in {n} consumed blocks", flush=True)
    check_async_telemetry(tel, n, env)


def check_host_telemetry(tel: str, n: int, env: str) -> None:
    """The host PPO run's spans: per iteration an `iteration` span holding
    `env_step`, `host_to_device`, `update` (the host's launch of the update
    graph: a replay returns once queued) and `log`, names canonical; the
    update span's ms printed (warmed: every iteration a replay)."""
    check_canonical(tel)
    spans = [e for e in span_events(tel) if e["ph"] == "X"]
    counts = {name: sum(e["name"] == name for e in spans)
              for name in ("iteration", "env_step", "host_to_device", "update", "log", "eval")}
    update_ms = [e["dur"] / 1e3 for e in spans if e["name"] == "update"]
    print(f"telemetry host ppo_halfcheetah on {env}: spans {counts}; update span (the host's "
          f"launch; warmed: every iteration a replay) "
          f"{', '.join(f'{m:.3f}' for m in update_ms)} ms", flush=True)
    assert counts == {"iteration": n, "env_step": n, "host_to_device": n, "update": n,
                      "log": counts["log"], "eval": 1} and counts["log"] >= 2, counts


def check_host_ppo_contract(env: str, bf16: bool = False) -> None:
    """`ppo_halfcheetah`'s host trainer on `env` under a `HostContract`
    (graph vs eager on one block at 0.0, the uploads and the mirror
    snapshots bitwise); with `bf16` the update computes in bf16 while the
    numpy mirror acts in float32 from the float32 master parameters."""
    import torch

    from actor_critic_tpu_torch.algos import ppo

    pool, cfg = host_pool("ppo_halfcheetah", env)
    cfg = dataclasses.replace(cfg, bf16_compute=bf16, epochs=CHECK_EPOCHS)
    contract = HostContract(lambda run: run.device_state["params"], HOST_CHECK_AT)
    try:
        ppo.train_host(pool, cfg, HOST_CHECK_ITERATIONS, seed=1, log_every=0, device="cuda",
                       iteration_hook=contract)
    finally:
        pool.close()
    torch.cuda.synchronize()
    contract.check(f"ppo_halfcheetah{' bf16' if bf16 else ''} on {env} ({CHECK_EPOCHS} epochs)")


def run_host_offpolicy(preset_name: str, env: str) -> None:
    """An off-policy preset at its full width (E=1, K=J=64, batch 256,
    hidden (256, 256), a 1M ring) on `env` through `train.main` for
    HOST_OFFPOLICY_ITERATIONS iterations, past the warm-up cut to
    OFFPOLICY_CUT_WARMUP env steps (the gate opens at iteration 32, inside
    the replays), losses finite, the
    update count read back from the final checkpoint; then the ingest
    under a `HostContract` with the warm-up cut to 128 env steps."""
    import dataclasses
    import math
    import shutil

    import torch

    from actor_critic_tpu_torch import train

    n = HOST_OFFPOLICY_ITERATIONS
    d = f"{SCRATCH}/host_{preset_name}"
    shutil.rmtree(d, ignore_errors=True)
    logged, summary, launches = drive(
        ["--preset", preset_name, "--env", env, "--iterations", str(n), "--log-every",
         str(HOST_OFFPOLICY_LOG_EVERY), "--eval-every", str(n), "--eval-envs", "2",
         "--eval-steps", "1000", "--seed", "0", "--ckpt-dir", d, "--save-every", "0",
         "--no-save-replay", "--set", f"warmup_steps={OFFPOLICY_CUT_WARMUP}"], show_every=50)
    check_rows(logged, n, keys=("critic_loss", "actor_loss", "q_mean"))
    assert launches == {"gae": 0, "vtrace": 0}, launches
    saved = final_checkpoint(d, n)["tensors"]
    updates = int(saved["device_state.learner.update_count"])
    pool, cfg = host_pool(preset_name, env)
    pool.close()
    cfg = dataclasses.replace(cfg, warmup_steps=OFFPOLICY_CUT_WARMUP)
    opened = -(-cfg.warmup_steps // (cfg.steps_per_iter * cfg.num_envs))  # iteration 32
    assert updates == (n - opened + 1) * cfg.updates_per_iter, (updates, opened)
    assert int(saved["device_state.env_steps"]) == n * cfg.steps_per_iter * cfg.num_envs
    ev = logged[-1]["eval_return"]
    assert math.isfinite(ev), logged[-1]
    rows = {r["iter"]: r for r in logged}
    per = lambda a, b: (rows[b]["wall_s"] - rows[a]["wall_s"]) / (b - a)
    every = HOST_OFFPOLICY_LOG_EVERY
    shut = (every, opened // every * every)       # logged replays with the gate shut: 10-30
    open_ = (-(-opened // every) * every, n)      # and open: 40-60
    before, after = per(*shut), per(*open_)
    spi = cfg.steps_per_iter * cfg.num_envs
    print(f"main path {preset_name} on {env} (E={cfg.num_envs}, K=J={cfg.steps_per_iter}, "
          f"ingest and updates a CUDA graph from iteration 1, warmed, logged every {every}): {n} "
          f"iterations; {before * 1e3:.3f} ms/iteration over the replays {shut[0] + 1}-{shut[1]} "
          f"(the gate shut), {after * 1e3:.3f} over {open_[0] + 1}-{n} (open): "
          f"{spi / after:.0f} env-steps/s, {cfg.updates_per_iter / after:.0f} updates/s; split "
          f"of the logged iterations after the gate {host_split(logged, open_[0])}; update_count "
          f"{updates} (gate opened at iteration {opened}); critic_loss "
          f"{rows[n]['critic_loss']:.4f}, greedy eval {ev:.2f}", flush=True)

    mod = train.ALGOS[train.PRESETS[preset_name].algo]
    pool, cfg = host_pool(preset_name, env)
    cfg = dataclasses.replace(cfg, warmup_steps=OFFPOLICY_GRAPH_WARMUP)
    contract = HostContract(lambda run: run.device_state["learner"].actor, HOST_CHECK_AT)
    try:
        learner, _ = mod.train_host(pool, cfg, HOST_CHECK_ITERATIONS, seed=1, log_every=0,
                                    device="cuda", iteration_hook=contract)
    finally:
        pool.close()
    contract.check(f"{preset_name} on {env} (warm-up {OFFPOLICY_GRAPH_WARMUP})")
    assert int(learner.update_count) > 0


def run_host_resume(preset_name: str, env: str) -> None:
    """A host checkpoint's round trip on the card, with the ring and
    without (`save_replay=False`): HOST_RESUME_ITERATIONS iterations saved,
    then (a) the checkpoint holds the live learner at 0.0, (b) a restore
    into a fresh template gives back at 0.0 the learner (the ring stub
    without the ring), the pool's stats, the generator's state and
    `env_steps`, and (c) the trainer's own resume gives back the learner
    (an empty ring with the stats kept without the ring)."""
    import dataclasses
    import shutil
    import warnings

    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos.common import named_carried
    from actor_critic_tpu_torch.algos.host_loop import host_ckpt_state, pool_state
    from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    mod = train.ALGOS[train.PRESETS[preset_name].algo]
    n = HOST_RESUME_ITERATIONS
    for save_replay in (True, False):
        d = f"{SCRATCH}/host_resume_{preset_name}_{save_replay}"
        shutil.rmtree(d, ignore_errors=True)
        pool, cfg = host_pool(preset_name, env)
        cfg = dataclasses.replace(cfg, warmup_steps=OFFPOLICY_GRAPH_WARMUP)
        try:
            live, _ = mod.train_host(pool, cfg, n, seed=2, log_every=0, ckpt=Checkpointer(d),
                                     save_every=n, save_replay=save_replay, device="cuda")
            pool_saved = pool.get_state()
        finally:
            pool.close()
        saved = final_checkpoint(d, n)
        ring = lambda k: " storage." in k or k.endswith(("insert_pos", "size"))
        live_t = {f"device_state.learner.{k}": t for k, t in named_carried(live, "").items()}
        diff = lambda a, b: float((a.detach().cpu().double() - b.double()).abs().max())
        worst_save = max(diff(t, saved["tensors"][k]) for k, t in live_t.items()
                         if save_replay or not ring(k))

        pool, _ = host_pool(preset_name, env)
        fresh = mod.init_learner(pool.spec.obs_shape, pool.spec.action_dim, cfg,
                                 torch.Generator().manual_seed(99), "cuda")
        gen = torch.Generator(device=fresh.update_count.device)
        from actor_critic_tpu_torch.algos.host_loop import strip_replay

        tmpl = host_ckpt_state(pool, gen, learner=fresh if save_replay else strip_replay(fresh),
                               env_steps=torch.zeros((), dtype=torch.int64))
        Checkpointer(d).restore(tmpl)
        restored = {k: t for k, t in named_carried(tmpl, "").items()}
        worst_restore = max(diff(t, saved["tensors"][k]) for k, t in restored.items())
        gen_equal = bool(torch.equal(gen.get_state(), saved["generator"]))
        pool.set_state(pool_state(tmpl.pool))
        pool_equal = all(
            bool((torch.as_tensor(pool.get_state()[g][f]) == torch.as_tensor(pool_saved[g][f])).all())
            for g in ("obs_rms", "ret_rms") for f in ("mean", "var", "count"))
        env_steps = int(tmpl.device_state["env_steps"])
        pool.close()

        pool, _ = host_pool(preset_name, env)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the replay-free resume warns by design
            resumed, _ = mod.train_host(pool, cfg, n, seed=2, log_every=0, ckpt=Checkpointer(d),
                                        resume=True, save_replay=save_replay, device="cuda")
        pool.close()
        res_t = {f"device_state.learner.{k}": t for k, t in named_carried(resumed, "").items()}
        worst_resume = max(diff(t, live_t[k].cpu()) for k, t in res_t.items()
                           if save_replay or not ring(k))
        empty = int(resumed.replay.size) == 0
        print(f"host resume {preset_name} on {env} ({'with' if save_replay else 'without'} the "
              f"ring): save vs live {worst_save:.3e}, restore vs save {worst_restore:.3e} over "
              f"{len(restored)} tensors, generator {'equal' if gen_equal else 'DIFFERENT'}, pool "
              f"stats {'equal' if pool_equal else 'DIFFERENT'}, env_steps {env_steps}; the "
              f"trainer's resume vs live {worst_resume:.3e}"
              f"{'' if save_replay else f', ring empty after the resume: {empty}'}", flush=True)
        assert worst_save == worst_restore == worst_resume == 0.0
        assert gen_equal and pool_equal and env_steps == n * cfg.steps_per_iter * cfg.num_envs
        assert save_replay or empty


# -- the async actor-learner and the device data plane ----------------------

ASYNC_ACTORS = 2                 # ppo_halfcheetah's E=8 as 2 actors of 4 envs
ASYNC_PPO_BLOCKS = 8             # replays (the warm-up captures before the actors start)
ASYNC_LOG_EVERY = 4
ASYNC_CHECK_BLOCKS = 5           # the graph-vs-eager runs: blocks 1-5, checked at 4
ASYNC_LOCKSTEP_ITERATIONS = 5    # two eager, a capture, replays
# Consumed blocks of the off-policy async drives, on each plane, the
# warm-up cut to OFFPOLICY_CUT_WARMUP: the fleet has collected 250-2,500
# env steps a block before the gate opens on the host plane (its actor
# outruns the learner, with the GIL deciding) and 250-380 on the device
# plane, so the gate opens by block ~8 and ~8-13; each run needs it open
# 5 blocks before its end (at least 167 and 111 env steps a block).
ASYNC_OFFPOLICY_BLOCKS = {"host": 12, "device": 20}
ASYNC_RESUME_BLOCKS = 4
# Consumed env-steps/s of the async PPO phase's runs, by (plane, codec): the
# serve-while-training phase's run without --serve-port.
ASYNC_RATES: dict[tuple[str, str], float] = {}


def host_pools(preset_name: str, env: str, actors: int):
    """`train.build_actor_pools`' fleet for `preset_name` on `env`, and its
    config."""
    import argparse

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.config import PRESETS

    preset = dataclasses.replace(PRESETS[preset_name], env=env)
    args = argparse.Namespace(seed=0, scale_actions=None)
    return train.build_actor_pools(preset, args, actors), preset.config


def async_split(logged: list[dict], after: int, actors: int) -> str:
    """The split of an async run's logged blocks from `after` on: each
    actor's collect ms a block (its cumulative collect seconds over its
    blocks pushed), the learner's idle seconds on the queue, upload and
    update ms (device, CUDA events), wait and dispatch ms (host clock)."""
    rows = [r for r in logged if r["iter"] >= after]
    mean = lambda k: sum(r[k] for r in rows) / len(rows)
    last = logged[-1]
    collect = ", ".join(
        f"actor {i} {last[f'collect_s_{i}'] / max(last[f'blocks_{i}'], 1) * 1e3:.3f} ms a block "
        f"({int(last[f'blocks_{i}'])} blocks)" for i in range(actors))
    return (f"collect {collect}; learner_idle_s {last['learner_idle_s']:.3f} in all; upload "
            f"{mean('upload_ms'):.3f} ms, update {mean('update_ms'):.3f} ms (device, CUDA "
            f"events); wait {mean('wait_s') * 1e3:.3f} ms, dispatch {mean('dispatch_s') * 1e3:.3f} "
            f"ms (host clock)")


def learner_htod_copies(trace_path: str) -> tuple[list[int], list[int]]:
    """(bytes of each host-to-device copy the LEARNER's thread issued, the
    same for every other thread) in a torch.profiler chrome trace. The
    learner's thread is the one that launched the CUDA graphs; a runtime
    memcpy call and its device copy are paired by their correlation id."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaGraphLaunch")]
    assert launches, "no cudaGraphLaunch in the profiled window"
    learner_tids = {e["tid"] for e in launches}
    calls = {e["args"]["correlation"]: e["tid"] for e in events
             if e.get("cat") == "cuda_runtime" and "Memcpy" in e.get("name", "")
             and "correlation" in e.get("args", {})}
    mine, others = [], []
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            corr = e.get("args", {}).get("correlation")
            nbytes = int(e.get("args", {}).get("bytes", -1))
            (mine if calls.get(corr) in learner_tids else others).append(nbytes)
    return mine, others


class ConsumeProfile:
    """An `iteration_hook` that runs torch.profiler over the learner's
    blocks `first`..`last` (replays) and keeps its chrome trace."""

    def __init__(self, first: int, last: int, path: str):
        self.first, self.last, self.path = first, last, path
        self.prof = None

    def __call__(self, it, run) -> None:
        from torch.profiler import ProfilerActivity, profile

        if it == self.first - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif it == self.last and self.prof is not None:
            import torch

            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.prof.export_chrome_trace(self.path)


def gated_graph_vs_eager(run) -> dict:
    """`graph_vs_eager` on an async learner's update, its actors held at
    their block boundaries meanwhile (the eager run's ops would otherwise
    wait on the GIL the actors' numpy loops hold)."""
    run.gate.clear()
    try:
        return graph_vs_eager(run)
    finally:
        run.gate.set()


def check_async_kernel_launches(logged: list[dict], launches: dict, blocks: int,
                                upb: int) -> None:
    assert launches == {"gae": 0, "vtrace": blocks * upb}, (launches, blocks, upb)
    assert logged[-1]["consumed_env_steps"] > 0


def run_async_ppo(env: str) -> int:
    """`ppo_halfcheetah --async-actors 2` at full width (E=8 as two actors of
    4, T=256, 32 minibatches) through `train.main` for ASYNC_PPO_BLOCKS
    consumed blocks at CHECK_EPOCHS, on the device plane with the fp32 codec
    (serve-while-training's baseline), then on the host plane and with the
    int8 codec: V-trace's
    launches counted on
    the card equal the consumed blocks; ms a consumed block, consumed
    env-steps/s, the split, drops and staleness printed. Then the host
    plane's V-trace update graph against its eager run on one block at 0.0,
    and torch.profiler over two replayed blocks: the learner copies each
    block to the card (the device plane's consume path, which copies none,
    is shown in `check_async_strict_lockstep`). Returns V-trace's launches
    on the host plane's run."""
    import os

    from actor_critic_tpu_torch.algos import ppo

    n = ASYNC_PPO_BLOCKS
    host_launches = None
    for plane, codec in (("device", "fp32"), ("host", "fp32"), ("device", "int8")):
        t0 = time.perf_counter()
        logged, summary, launches = drive(
            ["--preset", "ppo_halfcheetah", "--env", env, "--async-actors", str(ASYNC_ACTORS),
             "--iterations", str(n), "--log-every", str(ASYNC_LOG_EVERY), "--seed", "0",
             "--data-plane", plane, "--data-plane-codec", codec, "--set",
             f"epochs={CHECK_EPOCHS}"],
            show_every=ASYNC_LOG_EVERY)
        check_rows(logged, n)
        check_async_kernel_launches(logged, launches, n, 1)
        if plane == "host":
            host_launches = launches["vtrace"]
        ASYNC_RATES[(plane, codec)] = consumed_rate(logged, summary)
        after = 2 * ASYNC_LOG_EVERY
        per_block, _ = per_iteration(logged, summary, after=ASYNC_LOG_EVERY)
        steps = logged[-1]["consumed_env_steps"] / logged[-1]["iter"]
        last = logged[-1]
        print(f"main path async ppo_halfcheetah on {env}, --data-plane {plane} ({codec}, "
              f"{CHECK_EPOCHS} epochs): "
              f"{ASYNC_ACTORS} actors of 4 envs, {n} consumed blocks of {int(steps)} env steps, "
              f"V-trace launches {launches['vtrace']} (= blocks × updates_per_block); "
              f"block 1 (the warm-up included) {logged[0]['wall_s'] * 1e3:.1f} ms; {per_block * 1e3:.3f} ms a consumed "
              f"block over the replays {ASYNC_LOG_EVERY + 1}-{n} ({steps / per_block:.0f} "
              f"consumed env-steps/s); fleet collected {int(last['env_steps'])} env steps; "
              f"drops full {int(last['queue_drops_full'])}, stale {int(last['queue_drops_stale'])}; "
              f"staleness of the last block {int(last['block_staleness'])}, mean_rho "
              f"{last['mean_rho']:.4f}; split of blocks {after}, ..., {n}: "
              f"{async_split(logged, after, ASYNC_ACTORS)}; {time.perf_counter() - t0:.1f} s",
              flush=True)

    pools, cfg = host_pools("ppo_halfcheetah", env, ASYNC_ACTORS)
    cfg = dataclasses.replace(cfg, epochs=CHECK_EPOCHS)
    hook = AsyncContract(os.path.abspath(f"{SCRATCH}/async_consume_host.json"))
    try:
        ppo.train_host_async(pools, cfg, ASYNC_CHECK_BLOCKS, seed=1, log_every=0,
                             data_plane="host", device="cuda", iteration_hook=hook)
    finally:
        for p in pools:
            p.close()
    mine, _ = hook.check(f"ppo_halfcheetah on {env}, host plane (the V-trace update)")
    # The contrast: the host plane's learner copies each block to the card.
    assert mine and max(mine) > 8, mine
    return host_launches


class AsyncContract:
    """An `iteration_hook` for an async PPO learner on the card: at block
    ASYNC_CHECK_BLOCKS - 2 (the capture's block) its update's graph against
    its eager run on that block (`gated_graph_vs_eager`), and torch.profiler
    over the next two blocks (replays), whose chrome trace `check` reads."""

    def __init__(self, trace: str):
        self.out: dict = {}
        self.trace = trace
        self.profiler = ConsumeProfile(ASYNC_CHECK_BLOCKS - 1, ASYNC_CHECK_BLOCKS, trace)

    def __call__(self, it, run) -> None:
        if it == ASYNC_CHECK_BLOCKS - 2:
            self.out.update(gated_graph_vs_eager(run))
        self.profiler(it, run)

    def check(self, label: str) -> tuple[list[int], list[int]]:
        """Print and hold the graph check (0.0); returns the host-to-device
        copies of the learner's thread and of the others in the window."""
        out = self.out
        mine, others = learner_htod_copies(self.trace)
        print(f"async graph vs eager, {label}, on one block (block {ASYNC_CHECK_BLOCKS - 2}): "
              f"max abs difference {out['worst']:.3e} over {out['tensors']} tensors and "
              f"metrics, the generator's state {'equal' if out['generator_equal'] else 'DIFFERENT'}; "
              f"one replay {out['replay_ms']:.3f} ms (launch call {out['launch_ms']:.3f} ms), "
              f"device busy {out['busy_ms']:.3f} ms, {out['launches']} kernel launches; profiled "
              f"blocks {ASYNC_CHECK_BLOCKS - 1}-{ASYNC_CHECK_BLOCKS}: the learner's thread issued "
              f"{len(mine)} host-to-device copies (bytes {sorted(set(mine))}), the other threads "
              f"{len(others)} (bytes {sorted(set(others))})", flush=True)
        assert out["worst"] == 0.0 and out["generator_equal"], out
        return mine, others


def check_capture_beside_enqueues() -> None:
    """The async learners capture their update in "thread_local" mode while
    actor threads may enqueue: a thread puts `ppo_halfcheetah`-shaped int8
    blocks (2 actors' width) into a `DeviceTrajRing` as fast as it can
    (pinned staging, a copy on the slot's stream, events) while this thread
    captures a 1,000-kernel graph five times; puts land inside every
    capture, every capture succeeds, and every replay equals the eager run
    at 0.0."""
    import threading

    import numpy as np
    import torch

    from actor_critic_tpu_torch.algos import loop, ppo
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.data_plane import DeviceTrajRing
    from actor_critic_tpu_torch.envs.env import EnvSpec

    block_spec = ppo.async_block_spec(EnvSpec(obs_shape=(3,), action_dim=1, discrete=False),
                                      PRESETS["ppo_halfcheetah"].config, ASYNC_ACTORS)
    ring = DeviceTrajRing(4, block_spec, "int8", device="cuda")
    rng = np.random.default_rng(0)
    block = {k: rng.normal(size=v.shape).astype(v.dtype) for k, v in block_spec.items()}
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            ring.put(block, version=0, timeout=0.25)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((256, 64), generator=g, device="cuda")
    w = torch.randn((64, 64), generator=g, device="cuda") / 8

    def body():
        y = x
        for _ in range(500):
            y = torch.tanh(y @ w)
        return y

    eager = body()
    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    during = []
    try:
        for _ in range(5):
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream().wait_stream(side)
            with loop.capture(graph, capture_error_mode="thread_local"):
                before = ring.stats()["puts"]
                out = body()
                during.append(ring.stats()["puts"] - before)
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
    finally:
        stop.set()
        thread.join(timeout=30.0)
    puts = ring.stats()["puts"]
    print(f"capture beside enqueues: 5 thread_local captures of 1,000 kernels, puts inside "
          f"each capture {during} ({puts} in all, {ring.bytes_per_block()} B a block), every "
          f"replay equal to the eager run", flush=True)
    assert min(during) > 0, during


def check_async_strict_lockstep(env: str) -> None:
    """Async PPO with one actor, queue depth 1, updates_per_block 1 and
    correction none equals `ppo.train_host` on the card at 0.0 (parameters
    and every Adam state), `ppo_halfcheetah`'s config at full width (E=8,
    T=256, CHECK_EPOCHS × 32 minibatches) for ASYNC_LOCKSTEP_ITERATIONS iterations
    (two eager, a capture, replays), on the host plane and on the device
    plane with the fp32 codec. The device-plane run also holds the device
    plane's update graph (gather, decode, update) against its eager run on
    one block, and shows in torch.profiler's trace that the learner's
    thread copies nothing to the card on its consume path while the actor
    enqueues."""
    import os

    import torch

    from actor_critic_tpu_torch.algos import ppo
    from actor_critic_tpu_torch.algos.common import named_carried

    n = ASYNC_LOCKSTEP_ITERATIONS
    runs = {}
    for plane in (None, "host", "device"):
        pool, cfg = host_pool("ppo_halfcheetah", env)
        cfg = dataclasses.replace(cfg, epochs=CHECK_EPOCHS)
        t0 = time.perf_counter()
        try:
            if plane is None:
                net, opt_state, _ = ppo.train_host(pool, cfg, n, seed=0, log_every=0,
                                                   device="cuda")
            else:
                hook = (AsyncContract(os.path.abspath(f"{SCRATCH}/async_consume_device.json"))
                        if plane == "device" else None)
                net, opt_state, _ = ppo.train_host_async(
                    [pool], cfg, n, seed=0, log_every=0, queue_depth=1, updates_per_block=1,
                    correction="none", strict_lockstep=True, data_plane=plane,
                    plane_codec="fp32", device="cuda", iteration_hook=hook)
        finally:
            pool.close()
        torch.cuda.synchronize()
        runs[plane] = (named_carried({"params": net, "opt_state": opt_state}, ""),
                       time.perf_counter() - t0)
    want, want_s = runs[None]
    for plane in ("host", "device"):
        got, secs = runs[plane]
        assert sorted(got) == sorted(want)
        worst = max(float((got[k].double() - want[k].double()).abs().max()) for k in want)
        print(f"strict lockstep on the card, ppo_halfcheetah on {env}, {plane} plane: async (1 "
              f"actor, depth 1, 1 update a block, correction none) vs train_host over {n} "
              f"iterations of {CHECK_EPOCHS} epochs: max abs difference {worst:.3e} over "
              f"{len(want)} tensors (parameters, "
              f"Adam moments and count); {secs:.1f} s (train_host {want_s:.1f} s)", flush=True)
        assert worst == 0.0, (plane, worst)
    mine, others = hook.check(f"ppo_halfcheetah on {env}, device plane (gather, decode, update)")
    assert not mine, f"the learner copied {mine} bytes to the card on its consume path"
    assert others, "the profiled window saw no actor enqueue"


def run_async_flags(env: str) -> None:
    """The async PPO flags the other phases leave at their defaults, through
    `train.main` on the card: `ppo_halfcheetah` at full width with two
    epochs, `--async-actors 2 --updates-per-block 2 --max-staleness 4
    --queue-depth 2 --async-correction none` for 4 consumed blocks: GAE
    (not V-trace) launched twice a block, counted on the card, no block
    older than 4 versions consumed, the queue never deeper than 2."""
    n = 4
    logged, _, launches = drive(
        ["--preset", "ppo_halfcheetah", "--env", env, "--set", "epochs=2", "--async-actors",
         "2", "--updates-per-block", "2", "--max-staleness", "4", "--queue-depth", "2",
         "--async-correction", "none", "--iterations", str(n), "--log-every", "1", "--seed",
         "0"], show_every=n)
    check_rows(logged, n)
    print(f"async flags, ppo_halfcheetah on {env}: --updates-per-block 2 --max-staleness 4 "
          f"--queue-depth 2 --async-correction none, {n} consumed blocks: launches {launches}; "
          f"staleness {[int(r['block_staleness']) for r in logged]}, queue depth "
          f"{[int(r['queue_depth']) for r in logged]}, drops stale "
          f"{int(logged[-1]['queue_drops_stale'])}", flush=True)
    assert launches == {"gae": 2 * n, "vtrace": 0}, launches
    assert all(r["block_staleness"] <= 4 and r["queue_depth"] <= 2 for r in logged), logged
    assert "mean_rho" not in logged[-1]


def run_async_offpolicy(preset_name: str, env: str) -> None:
    """An off-policy preset at full width (E=1, so one actor; K=J=64, batch
    256, hidden (256, 256), a 1M ring) with `--async-actors 1` through
    `train.main` for ASYNC_OFFPOLICY_BLOCKS consumed blocks on each plane:
    the gate opens once the fleet has collected the warm-up (cut to
    OFFPOLICY_CUT_WARMUP env steps); updates/s over the blocks after it.
    Then the device plane's
    ingest + update graph against its eager run on one block at 0.0 (the
    warm-up cut to 128 env steps)."""
    import dataclasses as dc

    from actor_critic_tpu_torch import train

    mod = train.ALGOS[train.PRESETS[preset_name].algo]
    for plane in ("host", "device"):
        n = ASYNC_OFFPOLICY_BLOCKS[plane]
        t0 = time.perf_counter()
        logged, summary, launches = drive(
            ["--preset", preset_name, "--env", env, "--async-actors", "1", "--iterations", str(n),
             "--log-every", "1", "--seed", "0", "--data-plane", plane, "--set",
             f"warmup_steps={OFFPOLICY_CUT_WARMUP}"], show_every=20)
        check_rows(logged, n, keys=("critic_loss", "actor_loss", "q_mean"))
        assert launches == {"gae": 0, "vtrace": 0}, launches
        cfg = dc.replace(train.PRESETS[preset_name].config, warmup_steps=OFFPOLICY_CUT_WARMUP)
        # The gate reads the fleet's count staged with the block: the row
        # before the first open block already shows it past the warm-up.
        past = [r["iter"] for r in logged if r["env_steps"] >= cfg.warmup_steps]
        assert past and past[0] < n - 5, (
            f"the fleet collected {logged[-1]['env_steps']} env steps in {n} blocks: the gate "
            f"({cfg.warmup_steps}) opened too late to time updates after it")
        opened = past[0] + 1
        rows = {r["iter"]: r for r in logged}
        a, b = min(opened + 2, n - 5), n
        per = (rows[b]["wall_s"] - rows[a]["wall_s"]) / (b - a)
        last = rows[n]
        print(f"main path async {preset_name} on {env}, --data-plane {plane}: 1 actor, {n} "
              f"consumed blocks of {cfg.steps_per_iter}; the gate opened at block ~{opened} "
              f"(fleet collected {int(rows[opened - 1]['env_steps'])} env steps); "
              f"{per * 1e3:.3f} ms a consumed block over {a + 1}-{b} ({cfg.updates_per_iter / per:.0f} "
              f"updates/s); fleet collected {int(last['env_steps'])}; drops full "
              f"{int(last['queue_drops_full'])}; split {async_split(logged, a, 1)}; critic_loss "
              f"{last['critic_loss']:.4f}; {time.perf_counter() - t0:.1f} s", flush=True)

    pools, cfg = host_pools(preset_name, env, 1)
    cfg = dc.replace(cfg, warmup_steps=OFFPOLICY_GRAPH_WARMUP)
    out: dict = {}

    def hook(it, run):
        if it == ASYNC_CHECK_BLOCKS - 1:
            out.update(gated_graph_vs_eager(run))

    try:
        learner, _ = mod.train_host_async(pools, cfg, ASYNC_CHECK_BLOCKS, seed=1, log_every=0,
                                          data_plane="device", device="cuda",
                                          iteration_hook=hook)
    finally:
        for p in pools:
            p.close()
    print(f"async graph vs eager, {preset_name} on {env}, device plane (gather, decode, into "
          f"the 1M ring, gate, {cfg.updates_per_iter} updates on one block, block "
          f"{ASYNC_CHECK_BLOCKS - 1}): max abs difference {out['worst']:.3e} over "
          f"{out['tensors']} tensors and metrics, the generator's state "
          f"{'equal' if out['generator_equal'] else 'DIFFERENT'}; one replay "
          f"{out['replay_ms']:.3f} ms, {out['launches']} kernel launches; update_count "
          f"{int(learner.update_count)}", flush=True)
    assert out["worst"] == 0.0 and out["generator_equal"], out


def run_async_resume(env: str) -> None:
    """Async PPO's checkpoint on the card, both planes (the device plane
    with the int8 codec, whose stats ride the checkpoint):
    `ppo_halfcheetah`'s width with one epoch (E=8 as 2 actors, T=256, 32
    minibatches), ASYNC_RESUME_BLOCKS blocks saved; then (a) a restore into
    a fresh template equals the live net, Adam state and generator at 0.0
    and every actor pool's stats and the ring's stats exactly; (b) a resume
    that finds the run complete starts no actors and logs nothing, its
    pools' stats the saved ones; (c) a resume to 2 more blocks trains on
    (blocks 5 and 6 logged, the checkpoint at 6)."""
    import shutil

    import numpy as np
    import torch

    from actor_critic_tpu_torch.algos import host_loop, ppo
    from actor_critic_tpu_torch.algos.common import named_carried
    from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    n = ASYNC_RESUME_BLOCKS
    for plane, codec in (("host", "fp32"), ("device", "int8")):
        d = f"{SCRATCH}/async_resume_{plane}"
        shutil.rmtree(d, ignore_errors=True)
        kw = dict(seed=2, log_every=1, data_plane=plane, plane_codec=codec, device="cuda")
        pools, cfg = host_pools("ppo_halfcheetah", env, ASYNC_ACTORS)
        cfg = dataclasses.replace(cfg, epochs=1)
        try:
            net, opt_state, _ = ppo.train_host_async(pools, cfg, n, ckpt=Checkpointer(d),
                                                     save_every=n, **kw)
            live = named_carried({"params": net, "opt_state": opt_state}, "")
        finally:
            for p in pools:
                p.close()
        saved = final_checkpoint(d, n)
        pools, _ = host_pools("ppo_halfcheetah", env, ASYNC_ACTORS)
        fresh, fresh_opt = ppo.init_host_params(pools[0].spec, cfg, 99, "cuda")
        gen = torch.Generator(device="cuda")
        state = {"params": fresh, "opt_state": fresh_opt}
        if plane == "device":
            spec = ppo.async_block_spec(pools[0].spec, cfg, ASYNC_ACTORS)
            from actor_critic_tpu_torch.data_plane import DeviceTrajRing

            ring = DeviceTrajRing(1, spec, codec, device="cuda")
            state["ring_quant"] = host_loop.ring_quant_tensors(ring.quant_host())
        tmpl = host_loop.async_host_ckpt_state(pools, gen, **state)
        Checkpointer(d).restore(tmpl)
        restored = named_carried(tmpl, "")
        worst = max(float((restored[f"device_state.{k}"].double().cpu() - t.double().cpu())
                          .abs().max()) for k, t in live.items())
        worst_saved = max(float((t.double().cpu() - saved["tensors"][k].double()).abs().max())
                          for k, t in restored.items())
        gen_equal = bool(torch.equal(gen.get_state(), saved["generator"]))
        pool_keys = [k for k in restored if k.startswith("pools.")]
        quant_keys = [k for k in restored if ".ring_quant." in k]
        pools_state = pools[0].get_state()
        for p in pools:
            p.close()
        # (b) the run is complete: no actor starts, nothing is logged.
        pools, _ = host_pools("ppo_halfcheetah", env, ASYNC_ACTORS)
        try:
            _, _, hist_done = ppo.train_host_async(pools, cfg, n, ckpt=Checkpointer(d),
                                                   resume=True, **kw)
            stats_after = [p.get_state()["obs_rms"]["count"] for p in pools]
        finally:
            for p in pools:
                p.close()
        saved_counts = [float(saved["tensors"][f"pools.{i}.obs_rms.count"])
                        for i in range(ASYNC_ACTORS)]
        # (c) a resume to n + 2 trains on.
        pools, _ = host_pools("ppo_halfcheetah", env, ASYNC_ACTORS)
        try:
            _, _, hist_more = ppo.train_host_async(pools, cfg, n + 2, ckpt=Checkpointer(d),
                                                   resume=True, save_every=n + 2, **kw)
        finally:
            for p in pools:
                p.close()
        later = final_checkpoint(d, n + 2)
        moved = max(float((later["tensors"][k].double() - saved["tensors"][k].double())
                          .abs().max()) for k in saved["tensors"] if k.startswith("device_state.params"))
        print(f"async resume, ppo_halfcheetah on {env}, {plane} plane ({codec}): restore vs live "
              f"{worst:.3e} over {len(live)} tensors, restore vs save {worst_saved:.3e} over "
              f"{len(restored)} ({len(pool_keys)} actor-pool stats, {len(quant_keys)} ring-stat "
              f"tensors), generator {'equal' if gen_equal else 'DIFFERENT'}; a resume of the "
              f"complete run logged {len(hist_done)} rows, obs-stat counts {stats_after} (saved "
              f"{saved_counts}); a resume to {n + 2} logged blocks "
              f"{[it for it, _ in hist_more]}, parameters moved {moved:.3e}", flush=True)
        assert worst == 0.0 and worst_saved == 0.0 and gen_equal
        per_pool = len(host_loop.pool_tensors(pools_state))
        assert len(pool_keys) == per_pool * ASYNC_ACTORS and (plane == "host") == (not quant_keys)
        assert hist_done == [] and np.allclose(stats_after, saved_counts, rtol=0, atol=0)
        assert [it for it, _ in hist_more] == [n + 1, n + 2] and moved > 0.0



# -- policy serving ---------------------------------------------------------

# The presets served at full width; the MuJoCo envs' shapes (the card's
# machine has no MuJoCo): HalfCheetah-v5 and Walker2d-v5 17 obs and 6
# actions, Humanoid-v5 348 and 17.
SERVE_SHAPES = {"ppo_cartpole": None, "ppo_halfcheetah": (17, 6), "td3_walker2d": (17, 6),
                "sac_humanoid": (348, 17)}
SERVE_CALLS = 100             # timed acts a bucket and way (graph, eager)
SERVE_LATENCY_CALLS = 400    # batch-1 acts for p50 / p99 through engine.act
SERVE_HTTP_CALLS = 200        # batch-1 requests for p50 / p99 through HTTP
SERVE_LOAD_S = 1.0            # seconds of mixed-size load for rows/s
SERVE_CLIENTS = 16            # concurrent clients of the load and the checks
SERVE_MIXED_SIZES = (1, 3, 2, 1, 4, 6, 8, 2, 5, 1, 7, 3, 2, 6, 1, 4)
SERVE_SWAPS = 4               # checkpoints swapped in under load (versions 2..5)
SERVE_TRAIN_BLOCKS = 8        # serve-while-training: consumed blocks
SERVE_POLL_CLIENTS = 2        # clients polling the sidecar back to back
SERVE_SAC_WARMUP = 256        # env steps: the SAC learner updates from block 5 on


def serve_spec(preset_name: str):
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.envs.env import EnvSpec
    from actor_critic_tpu_torch.train import make_env

    preset = PRESETS[preset_name]
    shape = SERVE_SHAPES[preset_name]
    if shape is None:
        return make_env(preset.env, preset.env_kwargs).spec, preset
    return EnvSpec(obs_shape=(shape[0],), action_dim=shape[1], discrete=False), preset


def percentiles_ms(walls: list[float]) -> str:
    import numpy as np

    ms = np.asarray(walls) * 1e3
    return f"p50 {np.percentile(ms, 50):.4f} ms, p99 {np.percentile(ms, 99):.4f} ms"


def timed_calls(fn, n: int) -> list[float]:
    fn()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return walls


def check_serving_graphs(presets=tuple(SERVE_SHAPES), bf16: bool = False) -> None:
    """Each preset's policy at full width on the card through `PolicyEngine`
    (the default buckets 1..64, one CUDA graph each, captured by `warm`):
    every bucket's replay equals the eager act on the same lane buffers at
    0.0, and its host time (staging in and out included) beside the eager
    act's; a row's action at every bucket against its batch-1 action
    (equal bytes counted, the largest difference); batch-1 p50 / p99
    through `engine.act`; the choice of `backend="auto"` and the two walls
    it compared; for `ppo_cartpole` the sampled stream against the
    policy's softmax. With `bf16` each policy's config has `bf16_compute`
    (the act graphs run the trainer's bf16 network) and a discrete
    policy's rows equal its batch-1 actions."""
    import numpy as np
    import torch

    from actor_critic_tpu_torch import serving, weights
    from actor_critic_tpu_torch.serving import engine as engine_mod

    for preset_name in presets:
        spec, preset = serve_spec(preset_name)
        cfg, algo = dataclasses.replace(preset.config, bf16_compute=bf16), preset.algo
        engine = serving.PolicyEngine(spec, cfg, algo=algo, device="cuda")
        assert engine._network().compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
        params = engine.prepare_params(serving.init_params(spec, cfg, algo, seed=0))
        t0 = time.perf_counter()
        assert engine.warm(params) == len(engine.buckets)
        capture_s = time.perf_counter() - t0
        assert engine.graphs_captured == len(engine.buckets)
        # torch hands out the 32 streams of a priority pool round robin: the
        # engine's streams come from the high-priority pool, so no
        # normal-priority stream (a learner's capture stream) is one of them.
        pool = {torch.cuda.Stream().cuda_stream for _ in range(64)}
        mine = {lane.stream.cuda_stream for lane in engine._lanes}
        assert len(pool) <= 32 and not (mine & pool), (len(pool), mine & pool)
        rng = np.random.default_rng(0)
        obs64 = rng.normal(size=(engine.max_rows, *spec.obs_shape)).astype(np.float32)
        solo = np.concatenate([engine.act(params, obs64[j:j + 1]) for j in range(len(obs64))])
        lines = []
        for b in engine.buckets:
            obs = obs64[:b]
            graph, eager = engine.act(params, obs), engine.eager_act(params, obs)
            assert graph.dtype == eager.dtype and graph.shape == eager.shape == \
                ((b,) if spec.discrete else (b, spec.action_dim))
            diff = float(np.abs(graph.astype(np.float64) - eager).max())
            assert diff == 0.0 and np.isfinite(graph).all(), (preset_name, b, diff)
            g_ms = np.median(timed_calls(lambda: engine.act(params, obs), SERVE_CALLS)) * 1e3
            e_ms = np.median(timed_calls(lambda: engine.eager_act(params, obs), SERVE_CALLS)) * 1e3
            same = int(sum(graph[j].tobytes() == solo[j].tobytes() for j in range(b)))
            cross = float(np.abs(graph.astype(np.float64) - solo[:b]).max())
            assert same == b or not spec.discrete, (preset_name, b, same)
            lines.append(f"b={b}: graph = eager (max diff {diff}), graph {g_ms:.4f} ms / eager "
                         f"{e_ms:.4f} ms a call (median, host clock, copies included); rows "
                         f"equal to batch-1 {same}/{b} (max diff {cross:.3g})")
        lat = timed_calls(lambda: engine.act(params, obs64[:1]), SERVE_LATENCY_CALLS)
        torch_greedy = engine_mod.make_act_program(spec, cfg, algo)
        net = engine_mod.make_actor(spec, cfg, algo).cuda()
        net.load_state_dict(weights.from_flax(params))
        with torch.no_grad():
            own = torch_greedy(net, torch.from_numpy(obs64).cuda()).cpu().numpy()
        assert own.tobytes() == engine.act(params, obs64).tobytes(), preset_name
        auto = serving.PolicyEngine(spec, cfg, algo=algo, backend="auto", device="cuda")
        choice = auto.resolve_backend(serving.init_params(spec, cfg, algo, seed=0))
        print(f"serving {preset_name}{' bf16' if bf16 else ''} ({algo}, obs {spec.obs_shape}, "
              f"{'discrete' if spec.discrete else 'continuous'} {spec.action_dim}): "
              f"warm captured {engine.graphs_captured} graphs in {capture_s:.2f} s on a "
              f"high-priority stream (64 normal-priority streams made: {len(pool)} distinct); "
              f"batch-1 "
              f"engine.act {percentiles_ms(lat)} over {SERVE_LATENCY_CALLS}; the bucket-64 "
              f"graph = the module's own eager act on the card; auto picks {choice} (batch-1 "
              f"min of 7: device {auto.auto_choice['device_ms']:.4f} ms, mirror "
              f"{auto.auto_choice['mirror_ms']:.4f} ms)", flush=True)
        for line in lines:
            print(f"  {preset_name}{' bf16' if bf16 else ''} {line}", flush=True)
    if bf16:
        return
    spec, preset = serve_spec("ppo_cartpole")
    engine = serving.PolicyEngine(spec, preset.config, sample=True, buckets=(64,),
                                  device="cuda")
    tree = serving.init_params(spec, preset.config, seed=2)
    tree["params"]["policy"]["kernel"] *= 200.0  # logits of order 1: a skewed softmax
    params = engine.prepare_params(tree)
    engine.warm(params)
    obs = np.repeat(np.random.default_rng(4).normal(size=(1, 4)).astype(np.float32), 64, 0)
    draws = np.concatenate([engine.act(params, obs) for _ in range(100)])
    net = engine_mod.make_actor(spec, preset.config)
    net.load_state_dict(weights.from_flax(tree))
    probs = torch.softmax(net(torch.from_numpy(obs[:1]))[0].logits, -1)[0].detach().numpy()
    freq = np.bincount(draws, minlength=spec.action_dim) / draws.size
    assert np.abs(freq - probs).max() < 0.03, (freq, probs)
    print(f"serving ppo_cartpole --sample on the card: {draws.size} draws from one lane's graph, "
          f"frequencies {np.round(freq, 4).tolist()} against the softmax "
          f"{np.round(probs, 4).tolist()}", flush=True)


class ServeProcess:
    """`python -m actor_critic_tpu_torch.serve` in a subprocess, its URL read
    from its output; `stop()` sends SIGINT and waits for exit 0."""

    def __init__(self, argv: list[str]):
        import os
        import signal

        self.signal = signal.SIGINT
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "actor_critic_tpu_torch.serve", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": os.getcwd()})
        self.lines: list[str] = []
        self.url = None
        deadline = time.monotonic() + 180
        while self.url is None and time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                break
            self.lines.append(line.rstrip())
            if line.startswith("serving gateway: "):
                self.url = line.split()[2].removesuffix("/v1/act")
        if self.url is None:
            self.kill()
            raise RuntimeError("the serve CLI did not come up:\n" + "\n".join(self.lines))

    def stop(self) -> None:
        self.proc.send_signal(self.signal)
        rc = self.proc.wait(timeout=30)
        self.lines += self.proc.stdout.read().splitlines()
        assert rc == 0, (rc, self.lines[-5:])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def http_json(url: str, body=None, timeout: float = 30.0):
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=timeout) as r:
            raw, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


class KeepAlive:
    """One HTTP/1.1 connection with TCP_NODELAY, for back-to-back requests."""

    def __init__(self, url: str):
        import http.client
        import socket

        host, port = url.removeprefix("http://").split(":")
        self.conn = http.client.HTTPConnection(host, int(port), timeout=30)
        self.conn.connect()
        self.conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def post(self, path: str, body: dict) -> dict:
        self.conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        r = self.conn.getresponse()
        out = json.loads(r.read())
        assert r.status == 200, (r.status, out)
        return out

    def close(self) -> None:
        self.conn.close()


def run_threads(fn, n: int, timeout: float = 120.0) -> list:
    """`fn(i)` on `n` threads; their results (a raised exception re-raised)."""
    import threading

    out: list = [None] * n

    def target(i):
        try:
            out[i] = ("ok", fn(i))
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            out[i] = ("error", e)

    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    for kind, value in out:
        if kind == "error":
            raise value
    return [value for _, value in out]


def run_serve_cli() -> None:
    """`python -m actor_critic_tpu_torch.serve --preset ppo_cartpole
    --random-init --port 0` (full width, the default buckets 1..64) in a
    subprocess with `--max-inflight` 1 and 2, driven by this process's
    client threads: /healthz 200; mixed sizes from 16 clients at once, every
    row equal to the in-process engine's batch-1 action; batch-1 p50 / p99
    through HTTP on a kept-alive connection; rows/s of 16 clients sending
    mixed sizes for SERVE_LOAD_S; /metrics with the SLO histograms; a
    /v1/swap from an exported checkpoint, then SERVE_SWAPS more under load,
    every response's (version, actions) equal to that version's own act."""
    import os

    import numpy as np

    from actor_critic_tpu_torch import serving

    spec, preset = serve_spec("ppo_cartpole")
    engine = serving.PolicyEngine(spec, preset.config, device="cuda")
    versions = {v: serving.init_params(spec, preset.config, seed=v)
                for v in range(SERVE_SWAPS + 2)}
    ckpts = {}
    for v in range(1, SERVE_SWAPS + 2):
        ckpts[v] = os.path.abspath(f"{SCRATCH}/serve_ck/v{v}")
        serving.export_policy_params(ckpts[v], versions[v])
    prepared = {v: engine.prepare_params(p) for v, p in versions.items()}
    rng = np.random.default_rng(0)
    payloads = [rng.normal(size=(n, 4)).astype(np.float32) for n in SERVE_MIXED_SIZES]
    batch16 = rng.normal(size=(16, 4)).astype(np.float32)
    expect = {v: engine.act(p, batch16) for v, p in prepared.items()}
    for inflight in (1, 2):
        server = ServeProcess(["--preset", "ppo_cartpole", "--random-init", "--port", "0",
                               "--max-inflight", str(inflight), "--slo-ms", "50"])
        try:
            assert http_json(server.url + "/healthz")[0] == 200

            def mixed(i):
                status, body = http_json(server.url + "/v1/act", {"obs": payloads[i].tolist()})
                assert status == 200 and body["version"] == 0, body
                return np.asarray(body["actions"])

            answers = run_threads(mixed, len(payloads))
            rows = 0
            for i, got in enumerate(answers):
                for j in range(len(got)):
                    solo = engine.act(prepared[0], payloads[i][j:j + 1])
                    assert got[j] == solo[0], (i, j)
                    rows += 1
            conn = KeepAlive(server.url)
            obs1 = payloads[0][:1].tolist()
            lat = timed_calls(lambda: conn.post("/v1/act", {"obs": obs1}), SERVE_HTTP_CALLS)
            conn.close()
            stop_at = time.perf_counter() + SERVE_LOAD_S

            def load(i):
                c = KeepAlive(server.url)
                n = k = 0
                while time.perf_counter() < stop_at:
                    body = c.post("/v1/act", {"obs": payloads[(i + k) % len(payloads)].tolist()})
                    n += len(body["actions"])
                    k += 1
                c.close()
                return n

            t0 = time.perf_counter()
            load_rows = sum(run_threads(load, SERVE_CLIENTS))
            load_s = time.perf_counter() - t0
            status, text = http_json(server.url + "/metrics")
            assert status == 200 and 'actor_critic_serving_latency_ms_bucket{policy="default",' \
                'le="+Inf"}' in text and "actor_critic_serving_slo_burn_default" in text, text
            gauges = dict(line.rsplit(" ", 1) for line in text.splitlines()
                          if line.startswith("actor_critic_serving_") and "{" not in line)
            status, body = http_json(server.url + "/v1/swap",
                                     {"policy": "default", "checkpoint": ckpts[1]})
            assert status == 200 and body["version"] == 1, body
            status, body = http_json(server.url + "/v1/act", {"obs": batch16.tolist()})
            assert body["version"] == 1 and np.array_equal(body["actions"], expect[1]), body
            import threading

            stop = threading.Event()

            def swapped_load(i):
                c = KeepAlive(server.url)
                pairs = []
                while not stop.is_set():
                    body = c.post("/v1/act", {"obs": batch16.tolist()})
                    pairs.append((body["version"], body["actions"]))
                c.close()
                return pairs

            clients = threading.Thread(target=lambda: pairs_out.extend(
                run_threads(swapped_load, 4)))
            pairs_out: list = []
            clients.start()
            for v in range(2, SERVE_SWAPS + 2):
                time.sleep(0.2)
                status, body = http_json(server.url + "/v1/swap",
                                         {"policy": "default", "checkpoint": ckpts[v]})
                assert status == 200 and body["version"] == v, body
            time.sleep(0.2)
            stop.set()
            clients.join(60)
            assert not clients.is_alive() and len(pairs_out) == 4
            seen = set()
            for pairs in pairs_out:
                got = [v for v, _ in pairs]
                assert got == sorted(got), got
                for v, actions in pairs:
                    assert np.array_equal(actions, expect[v]), ("torn", v)
                    seen.add(v)
            assert max(seen) == SERVE_SWAPS + 1 and len(seen) >= 3, seen
            n_pairs = sum(len(p) for p in pairs_out)
            server.stop()
        finally:
            server.kill()
        print(f"serve CLI ppo_cartpole --max-inflight {inflight}: {rows} rows of "
              f"{len(payloads)} concurrent mixed-size requests = the in-process batch-1 "
              f"actions; batch-1 through HTTP {percentiles_ms(lat)} over {SERVE_HTTP_CALLS} "
              f"(kept-alive, client clock, the default 2000 us window); {SERVE_CLIENTS} clients of mixed sizes 1-8: "
              f"{load_rows / load_s:.0f} rows/s over {load_s:.2f} s (gateway: occupancy "
              f"{gauges.get('actor_critic_serving_batch_occupancy')}, flushes "
              f"{gauges.get('actor_critic_serving_flushes_total')}, requests "
              f"{gauges.get('actor_critic_serving_requests_total')}, p99 "
              f"{gauges.get('actor_critic_serving_latency_p99_ms')} ms); /v1/swap to v1 and "
              f"{SERVE_SWAPS} swaps under 4 clients' load: {n_pairs} responses, versions "
              f"{sorted(seen)}, none torn", flush=True)


# The sidecar's clients, in a process of their own as real clients are: N
# threads post one request each back to back on kept-alive connections until
# their stdin closes (or the gateway does), then print every (version,
# actions, seconds) as JSON.
POLL_CLIENT = r"""
import http.client, json, socket, sys, threading, time
url, body, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
host, port = url.removeprefix("http://").split(":")
stop = threading.Event()
out = [[] for _ in range(n)]
failed = []
def poll(i):
    try:
        c = http.client.HTTPConnection(host, int(port), timeout=60)
        c.connect()
        c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while not stop.is_set():
            t0, issued = time.perf_counter(), time.time()
            c.request("POST", "/v1/act", body, {"Content-Type": "application/json"})
            r = c.getresponse()
            b = json.loads(r.read())
            if r.status != 200:
                failed.append([r.status, str(b)[:300]])
                continue
            out[i].append([b["version"], b["actions"], time.perf_counter() - t0, issued])
    except (OSError, http.client.HTTPException, ValueError) as e:
        if not stop.is_set():
            failed.append([None, repr(e)[:300]])
threads = [threading.Thread(target=poll, args=(i,)) for i in range(n)]
for t in threads:
    t.start()
sys.stdin.read()
stop.set()
for t in threads:
    t.join(90)
print(json.dumps({"polls": out, "failed": failed}))
"""


class SidecarProbe:
    """Wraps `train.start_serving_sidecar`: records the store, times
    SERVE_HTTP_CALLS requests against the idle gateway, then starts a client
    process (POLL_CLIENT) of SERVE_POLL_CLIENTS threads that request back to
    back until `finish`, which collects their (version, actions, seconds,
    time issued). It also times every closure of the learner's gate
    (`closures`: start and seconds), and `warm_done` is when the run's
    warm-up ended (`time.time()`): a closure that starts after it closed
    the gate during training, and a request issued before it waited for
    the warm-up."""

    def __init__(self, obs):
        self.obs = obs
        self.store = None
        self.idle: list[float] = []
        self.polls: list[list] = []
        self.failed: list = []
        self.gateway = None
        self.proc = None
        self.closures: list[tuple[float, float]] = []
        self.closed_at = None
        self.warm_done = None

    def time_gate(self, gate) -> None:
        clear, set_ = gate.clear, gate.set

        def closing() -> None:
            self.closed_at = time.time()
            clear()

        def opening() -> None:
            if self.closed_at is not None:
                self.closures.append((self.closed_at, time.time() - self.closed_at))
                self.closed_at = None
            set_()

        gate.clear, gate.set = closing, opening

    def gate_line(self) -> str:
        """How long the gate was closed in the warm-up and after it."""
        done = self.warm_done if self.warm_done is not None else float("-inf")
        warm = [d for t, d in self.closures if t < done]
        run = [d for t, d in self.closures if t >= done]
        return (f"the learner's gate closed {len(warm)} time(s) in the warm-up "
                f"({sum(warm):.3f} s) and {len(run)} time(s) after it ({sum(run):.3f} s)")

    def wrap(self, start):
        def start_serving_sidecar(*a, **k):
            gateway, learner_kwargs = start(*a, **k)
            self.time_gate(learner_kwargs["gate"])
            self.store, self.gateway = gateway.store, gateway
            conn = KeepAlive(gateway.url)
            self.idle = timed_calls(lambda: conn.post("/v1/act", {"obs": self.obs.tolist()}),
                                    SERVE_HTTP_CALLS)
            conn.close()
            self.proc = subprocess.Popen(
                [sys.executable, "-c", POLL_CLIENT, gateway.url,
                 json.dumps({"obs": self.obs.tolist()}), str(SERVE_POLL_CLIENTS)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            close = gateway.close

            def close_after_clients():
                # The clients stop before the gateway closes (training
                # over), so every failure they saw is a real one.
                self.finish()
                close()

            gateway.close = close_after_clients
            return gateway, learner_kwargs

        return start_serving_sidecar

    def finish(self) -> None:
        if self.proc is None or self.proc.returncode is not None:
            return
        try:
            out, _ = self.proc.communicate(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait(timeout=30)
        assert self.proc.returncode == 0, self.proc.returncode
        got = json.loads(out)
        self.polls = [[tuple(x) for x in polls] for polls in got["polls"]]
        self.failed = got["failed"]


def serve_drive(argv: list[str], mod, module_of) -> tuple:
    """`drive(argv + --serve-port 0)` with a `SidecarProbe` on the sidecar and
    the learner's final module captured from `mod.train_host_async`'s return
    (`module_of(returned)`): (logged, summary, launches, probe, module)."""
    import numpy as np

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.utils import compile_cache

    probe = SidecarProbe(np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32))
    learned = {}
    start, run = train.start_serving_sidecar, mod.train_host_async

    def capture(*a, **k):
        out = run(*a, **k)
        learned["module"] = module_of(out)
        return out

    def warm_done(_runner) -> None:
        probe.warm_done = time.time()

    train.start_serving_sidecar, mod.train_host_async = probe.wrap(start), capture
    compile_cache.WARMUP_DONE_HOOKS.append(warm_done)
    try:
        logged, summary, launches = drive(argv + ["--serve-port", "0"],
                                          show_every=ASYNC_LOG_EVERY)
    finally:
        compile_cache.WARMUP_DONE_HOOKS.remove(warm_done)
        train.start_serving_sidecar, mod.train_host_async = start, run
        probe.finish()
    return logged, summary, launches, probe, learned["module"]


def consumed_rate(logged: list[dict], summary: dict) -> float:
    """Consumed env-steps/s of an async run over its logged blocks from
    ASYNC_LOG_EVERY on (the replays)."""
    per_block, _ = per_iteration(logged, summary, after=ASYNC_LOG_EVERY)
    return logged[-1]["consumed_env_steps"] / logged[-1]["iter"] / per_block


# -- the multi-process actor-learner and the serving fleet -------------------

MULTIHOST_BLOCKS = 4            # world-1 sync: 2 eager blocks, a capture, replays
MULTIHOST_CHECK_AT = 4          # the block whose replay is held against the single host's
MULTIHOST_TIMED_REPLAYS = 3     # each way, from one restored state
MULTIHOST_TIMED_CHECKS = 10     # consistency checks timed with the actors held
GOSSIP_BLOCKS = 6               # each rank's consumed blocks in the world-2 gossip run
FLEET_ACTS = 6                  # requests through the proxy before and after the kill


class AllReduceCounter:
    """Counts `torch.distributed.all_reduce` calls while installed, and how
    many of them were issued on a stream that was capturing (so were
    recorded into a CUDA graph)."""

    def __init__(self):
        self.calls = self.captured = 0

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self._orig = dist.all_reduce

        def counted(tensor, *args, **kwargs):
            self.calls += 1
            if torch.cuda.is_current_stream_capturing():
                self.captured += 1
            return self._orig(tensor, *args, **kwargs)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self._orig


class SyncContract:
    """An `iteration_hook` for the multi-process sync learner at world 1 over
    NCCL: the update's capture object never changes after it exists (one
    capture), and at block MULTIHOST_CHECK_AT (a replay) the sync graph is
    held against the single-host update (`ppo.make_async_update_step`
    without a group, eager, built here on the run's parameters, optimizer
    state, generator and staged block) on the same block from the same
    state at 0.0; then the sync replay and a captured single-host update
    are timed in turns, and the sync replay's kernels are read under
    torch.profiler (NCCL's among them). `cfg` and `spec` are the run's."""

    def __init__(self, cfg, spec):
        self.cfg, self.spec = cfg, spec
        self.captures: set[int] = set()
        self.out: dict = {}

    def __call__(self, it, run) -> None:
        if run.update.captured is not None:
            self.captures.add(id(run.update.captured))
        if it == MULTIHOST_CHECK_AT:
            run.gate.clear()
            try:
                self.out = sync_against_single(run, it, self.cfg, self.spec)
            finally:
                run.gate.set()


def single_host_update(run, it: int, cfg, spec):
    """The single-host async update (no group) on the sync learner's own
    tensors: its parameters and optimizer state, its generator and its
    staged block, with the schedule and the iteration (block `it` ran at
    iteration `it - 1`) made as `train_multihost` makes them."""
    import torch

    from actor_critic_tpu_torch.algos import ppo

    device = run.update.generator.device
    step = ppo.make_async_update_step(spec, cfg, True)
    schedule = ppo.make_schedule(cfg, device)
    iteration = torch.full((1,), it - 1, dtype=torch.int64, device=device)
    net, opt_state = run.device_state["params"], run.device_state["opt_state"]

    def update() -> dict:
        return step(net, opt_state, schedule, run.update.generator, run.buffers.static,
                    iteration)

    return update


def sync_against_single(run, it: int, cfg, spec) -> dict:
    import torch

    from actor_critic_tpu_torch.algos import host_loop
    from actor_critic_tpu_torch.parallel import mesh, multihost

    assert run.update.captured is not None
    torch.cuda.synchronize()
    carried = run.carried()
    start = {k: t.clone() for k, t in carried.items()}
    gen = run.update.generator
    gen_start = gen.get_state()

    def restore():
        with torch.no_grad():
            for k, t in carried.items():
                t.copy_(start[k])
        gen.set_state(gen_start)

    reference = single_host_update(run, it, cfg, spec)
    ref_metrics = reference()
    ref = {k: t.clone() for k, t in carried.items()}
    ref.update({f"metric {k}": v.clone() for k, v in ref_metrics.items()})
    ref_gen = gen.get_state()
    restore()
    graph_metrics = run.update.captured.replay()
    torch.cuda.synchronize()
    diffs = {k: float((t.double() - ref[k].double()).abs().max()) for k, t in carried.items()}
    diffs.update({f"metric {k}": float((v.double() - ref[f'metric {k}'].double()).abs().max())
                  for k, v in graph_metrics.items()})
    out = dict(worst=max(diffs.values()), tensors=len(diffs),
               generator_equal=bool(torch.equal(gen.get_state(), ref_gen)))
    restore()
    single = host_loop.HostUpdate(reference, gen, capture_error_mode="thread_local",
                                  name="multihost.single_reference")
    single.warm()  # eager calls from a snapshot put back, then the capture
    times: dict[str, list[float]] = {"sync": [], "single": []}
    for _ in range(MULTIHOST_TIMED_REPLAYS):
        for label, graph in (("sync", run.update.captured), ("single", single.captured)):
            restore()
            torch.cuda.synchronize()
            start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start_ev.record()
            graph.replay()
            end_ev.record()
            end_ev.synchronize()
            times[label].append(start_ev.elapsed_time(end_ev))
    restore()
    kernels, _ = profile_kernels(run.update.captured.replay, iters=1)
    restore()
    # The consistency check's own cost, the actors held (the caller cleared
    # their gate): in the run its host time also waits on their GIL.
    check = multihost.make_consistency_check(mesh.world_group(), torch.device("cuda"))
    walls = []
    for i in range(MULTIHOST_TIMED_CHECKS):
        t0 = time.perf_counter()
        check(float(i), 0.5, 0.0)
        walls.append(time.perf_counter() - t0)
    nccl = {k: v for k, v in kernels.items() if "nccl" in k.lower()}
    out.update(sync_ms=sorted(times["sync"])[len(times["sync"]) // 2],
               single_ms=sorted(times["single"])[len(times["single"]) // 2],
               launches=sum(c for c, _ in kernels.values()),
               nccl_kernels=sum(c for c, _ in nccl.values()), nccl_names=sorted(nccl),
               check_alone_ms=1e3 * sorted(walls)[len(walls) // 2])
    del single
    return out


def run_multihost_sync(env: str) -> int:
    """The multi-process sync learner at world 1 over NCCL on the card,
    `ppo_halfcheetah` at full width (E=8 as 2 actors of 4, T=256, 32
    minibatches, CHECK_EPOCHS epochs):

    - through `train.main --distributed --coordinator 127.0.0.1:<port>
      --async-actors 2` (warmed: the update captured before the actors
      start, its all-reduces counted inside the capture): `version_sum` and
      `fingerprint_ok` at every block, V-trace launched once a consumed
      block;
    - through `multihost.train_multihost` with `SyncContract`: one capture,
      the sync replay equal to the single-host async update at 0.0, the
      replay's ms with the group against the single-host learner's, the
      consistency check's ms.
    Returns V-trace's launches on the train.main run."""
    import torch
    import torch.distributed as dist

    from actor_critic_tpu_torch.parallel import launch, multihost

    n = MULTIHOST_BLOCKS
    with AllReduceCounter() as counter:
        logged, summary, launches = drive(
            ["--preset", "ppo_halfcheetah", "--env", env, "--async-actors", str(ASYNC_ACTORS),
             "--iterations", str(n), "--log-every", "1", "--seed", "0",
             "--set", f"epochs={CHECK_EPOCHS}", "--distributed",
             "--coordinator", f"127.0.0.1:{launch.free_port()}"], show_every=n)
    assert not dist.is_initialized(), "train.main left its process group behind"
    check_rows(logged, n)
    check_async_kernel_launches(logged, launches, n, 1)
    assert [r["version_sum"] for r in logged] == [float(i) for i in range(1, n + 1)], logged
    assert all(r["fingerprint_ok"] and r["version_ok"] for r in logged), logged
    # The warm-up's two eager calls and its capture issue the all-reduces
    # (2 a minibatch and 1 for the metrics); the replays issue none from
    # Python; the consistency check adds 2 a block, outside any graph.
    per_update = 2 * CHECK_EPOCHS * 32 + 1
    assert counter.captured == per_update, (counter.captured, per_update)
    assert counter.calls == 3 * per_update + 2 * n, (counter.calls, per_update, n)
    print(f"multihost sync world 1 (NCCL) through train.main: {n} consumed blocks, "
          f"version_sum {[int(r['version_sum']) for r in logged]}, fingerprint_ok at every "
          f"block; V-trace launches {launches['vtrace']} (= blocks); all-reduces issued "
          f"{counter.calls}, of them {counter.captured} inside the update's capture (= 2 × "
          f"{CHECK_EPOCHS} epochs × 32 minibatches + 1 for the metrics); consistency check "
          f"{summary['multihost_check_ms']:.3f} ms a block (host clock, median: 2 all-reduces "
          f"and their read)", flush=True)

    pools, cfg = host_pools("ppo_halfcheetah", env, ASYNC_ACTORS)
    cfg = dataclasses.replace(cfg, epochs=CHECK_EPOCHS)
    hook = SyncContract(cfg, pools[0].spec)
    multihost.distributed_init(f"127.0.0.1:{launch.free_port()}", 1, 0, "cuda")
    try:
        _, history, summary = multihost.train_multihost(
            pools, cfg, n, rank=0, world=1, mode="sync", seed=1, log_every=1,
            device="cuda", iteration_hook=hook)
    finally:
        dist.destroy_process_group()
        for p in pools:
            p.close()
    out = hook.out
    assert len(hook.captures) == 1, hook.captures
    assert summary["version_consistent"] and summary["fingerprint_consistent"], summary
    print(f"multihost sync world 1 (NCCL) against the single-host async update on one block "
          f"(block {MULTIHOST_CHECK_AT}, a replay): max abs difference {out['worst']:.3e} over "
          f"{out['tensors']} tensors and metrics, the generator's state "
          f"{'equal' if out['generator_equal'] else 'DIFFERENT'}; one capture; a replay "
          f"{out['sync_ms']:.3f} ms with the group against {out['single_ms']:.3f} ms for the "
          f"single-host learner's graph (CUDA events, medians of {MULTIHOST_TIMED_REPLAYS} in "
          f"turns; +{out['sync_ms'] - out['single_ms']:.3f} ms); the sync replay ran "
          f"{out['launches']} kernels, {out['nccl_kernels']} of them NCCL's "
          f"{out['nccl_names']} (a one-rank in-place all-reduce launches nothing); consistency "
          f"check {summary['check_ms']:.3f} ms a block in the run (host clock, median, the "
          f"actors' GIL included), {out['check_alone_ms']:.3f} ms with the actors held "
          f"(median of {MULTIHOST_TIMED_CHECKS})", flush=True)
    assert out["worst"] == 0.0 and out["generator_equal"], out
    MULTIHOST_TIMES.update(out, check_ms=summary["check_ms"])
    return launches["vtrace"]


MULTIHOST_TIMES: dict = {}


def run_multihost_gossip(env: str) -> dict[int, int]:
    """Gossip at world 2, both ranks on the one card, through `python -m
    actor_critic_tpu_torch.parallel.launch` (its own processes): each rank
    `ppo_halfcheetah` at full width (E=8 as 2 actors of 4, T=256, 32
    minibatches, CHECK_EPOCHS epochs) with `--async-correction none`, for
    GOSSIP_BLOCKS blocks; both ranks exit 0, each mixes (> 0) with the lag
    reported, and each rank's GAE launches (counted on the card in its own
    process) equal its consumed blocks, V-trace none. The mailbox is kept
    under SCRATCH for the serving fleet. Returns GAE's launches by rank."""
    import os
    import shutil

    from actor_critic_tpu_torch.parallel import launch

    mailbox = os.path.abspath(f"{SCRATCH}/mailbox")
    shutil.rmtree(mailbox, ignore_errors=True)
    os.makedirs(mailbox)
    rec = launch.run_cluster(
        2, "gossip", iterations=GOSSIP_BLOCKS, rollout_steps=256, num_envs=8,
        actors=ASYNC_ACTORS, device="cuda", mailbox_dir=mailbox, timeout_s=300.0,
        extra_args=("--preset", "ppo_halfcheetah", "--env", env, "--epochs", str(CHECK_EPOCHS),
                    "--async-correction", "none", "--log-every", "1"))
    gae = {}
    for r in rec["ranks"]:
        lags = [row["gossip_lag"] for row in r["rows"] if "gossip_lag" in row]
        assert r["consumed_blocks"] == GOSSIP_BLOCKS and r["gossip_mixes"] > 0 and lags, r
        assert r["launches"] == {"gae": GOSSIP_BLOCKS, "vtrace": 0}, r["launches"]
        assert not any("version_sum" in row for row in r["rows"])
        gae[r["rank"]] = r["launches"]["gae"]
        print(f"multihost gossip world 2 rank {r['rank']} (one card): {r['consumed_blocks']} "
              f"blocks, {r['gossip_mixes']} mixes, {r['gossip_skips']} skips, lags {lags} "
              f"(max {r['gossip_lag_max']}); GAE launches {r['launches']['gae']} (= blocks), "
              f"V-trace {r['launches']['vtrace']}; {r['consumed_steps_per_s']:.1f} consumed "
              f"env-steps/s over {r['wall_s']:.2f} s", flush=True)
    print(f"multihost gossip world 2: {rec['aggregate_steps_per_s']:.1f} consumed env-steps/s "
          f"in all, the launcher's wall {rec['launcher_wall_s']:.2f} s (two processes, each "
          f"starting torch and the card)", flush=True)
    return gae


def run_multihost_sync_world2(env: str) -> None:
    """Sync at world 2 over NCCL, one card a rank, where the machine has two
    cards; on one card the fleet refuses two ranks (NCCL's limit), and the
    run is reported as not run."""
    import torch

    from actor_critic_tpu_torch.parallel import launch, multihost

    cards = torch.cuda.device_count()
    if cards < 2:
        try:
            multihost.nccl_ranks_fit(2, cards)
        except RuntimeError as e:
            print(f"multihost sync world 2 over NCCL: not run, this machine has {cards} card "
                  f"(the fleet refuses: {e})", flush=True)
            return
        raise AssertionError("two NCCL ranks on one card were not refused")
    rec = launch.run_cluster(
        2, "sync", iterations=4, rollout_steps=256, num_envs=8, actors=ASYNC_ACTORS,
        device="cuda", timeout_s=300.0,
        extra_args=("--preset", "ppo_halfcheetah", "--env", env, "--epochs", str(CHECK_EPOCHS),
                    "--log-every", "1"))
    assert rec["version_consistent"] and rec["fingerprint_consistent"], rec
    for r in rec["ranks"]:
        assert r["launches"]["vtrace"] == 4 and all(row["fingerprint_ok"] for row in r["rows"])
    print(f"multihost sync world 2 over NCCL ({cards} cards): consistent at every block, "
          f"V-trace launches {[r['launches']['vtrace'] for r in rec['ranks']]}, "
          f"{rec['aggregate_steps_per_s']:.1f} consumed env-steps/s", flush=True)


def metric_value(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not in /metrics")


def run_serving_fleet(env: str) -> None:
    """Two `serve --distributed` replicas on the card behind `serve_fleet`:
    replica 0 syncs the gossip run's mailbox (rank 0), and a newer snapshot
    published there is swapped in with no new capture (the recompile
    counter unchanged); `/fleetz` lists both replicas; the proxy relays and
    fails over when replica 1 is killed."""
    import os

    from actor_critic_tpu_torch.parallel import multihost

    mailbox = os.path.abspath(f"{SCRATCH}/mailbox")
    base = ["--preset", "ppo_halfcheetah", "--env", env, "--random-init", "--port", "0",
            "--buckets", "1,4", "--distributed", "--mailbox-dir", mailbox, "--world", "2",
            "--stale-after-s", "3600"]
    replicas, proxy = [], None
    try:
        for rank in range(2):
            extra = (["--sync-mailbox", mailbox, "--sync-rank", "0", "--sync-poll-s", "0.1"]
                     if rank == 0 else [])
            replicas.append(ServeProcess(base + [
                "--rank", str(rank), "--telemetry-dir",
                os.path.abspath(f"{SCRATCH}/fleet_tel{rank}"), *extra]))
        url0 = replicas[0].url
        trained = multihost.read_version(mailbox, 0)
        deadline = time.monotonic() + 30
        while http_json(url0 + "/v1/policies")[1]["policies"]["default"] != trained:
            assert time.monotonic() < deadline, "the syncer never swapped the mailbox's version"
            time.sleep(0.1)
        obs = {"obs": [[0.1, 0.2, 0.3]]}
        status, before = http_json(url0 + "/v1/act", obs)
        assert status == 200 and before["version"] == trained, before
        captures = metric_value(http_json(url0 + "/metrics")[1], "actor_critic_recompiles_total")
        names = [n for n, _ in engine_names("ppo_halfcheetah", env)]
        _, named = multihost.read_params(mailbox, 0, names)
        multihost.write_params(mailbox, 0, trained + 1,
                               [v + 0.01 for v in named.values()])
        while http_json(url0 + "/v1/policies")[1]["policies"]["default"] != trained + 1:
            assert time.monotonic() < deadline, "the newer version was never swapped in"
            time.sleep(0.05)
        status, after = http_json(url0 + "/v1/act", obs)
        assert status == 200 and after["version"] == trained + 1, after
        after_captures = metric_value(http_json(url0 + "/metrics")[1],
                                      "actor_critic_recompiles_total")
        assert after_captures == captures, (captures, after_captures)
        status, z = http_json(url0 + "/fleetz")
        assert status == 200 and z["reachable"] == [0, 1], z
        status, health = http_json(url0 + "/healthz")
        assert status == 200 and health["fleet"]["ok"], health
        proxy = subprocess.Popen(
            [sys.executable, "-m", "actor_critic_tpu_torch.serve_fleet", "--replica", url0,
             "--replica", replicas[1].url, "--port", "0", "--policy", "round_robin",
             "--health-interval", "0.2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": os.getcwd()})
        line = proxy.stdout.readline()
        assert line.startswith("fleet proxy on http://"), line
        purl = line.split()[3]
        walls = []
        for _ in range(FLEET_ACTS):
            t0 = time.perf_counter()
            status, body = http_json(purl + "/v1/act", obs)
            walls.append(time.perf_counter() - t0)
            assert status == 200, body
        forwards = sorted(r["forwards"] for r in http_json(purl + "/proxyz")[1]["replicas"])
        replicas[1].kill()
        for _ in range(FLEET_ACTS):
            status, body = http_json(purl + "/v1/act", obs)
            assert status == 200 and body["version"] == trained + 1, body
        stats = http_json(purl + "/proxyz")[1]
        assert stats["healthy"] == 1 and stats["relayed"] == 2 * FLEET_ACTS, stats
        print(f"serving fleet: replica 0 swapped the gossip run's version {trained} from the "
              f"mailbox, then {trained + 1} published while it served (recompiles "
              f"{captures:.0f} -> {after_captures:.0f}: no new capture); /fleetz reachable "
              f"{z['reachable']}, /healthz fleet ok; through the proxy {FLEET_ACTS} acts "
              f"(forwards {forwards}; {percentiles_ms(walls)}), replica 1 killed, "
              f"{FLEET_ACTS} more answered by replica 0 (failovers {stats['failovers']}, "
              f"healthy {stats['healthy']})", flush=True)
    finally:
        if proxy is not None:
            proxy.send_signal(__import__("signal").SIGINT)
            try:
                proxy.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proxy.kill()
        for r in replicas:
            if r.proc.poll() is None:
                r.stop()


def engine_names(preset_name: str, env: str):
    """The PPO network's `named_parameters()` for `preset_name` on `env`."""
    from actor_critic_tpu_torch import serve
    from actor_critic_tpu_torch.algos import ppo
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS[preset_name]
    spec = serve.spec_for(env, {})
    return list(ppo.make_network(spec, preset.config).named_parameters())


def run_serve_while_training(env: str, without: float | None = None) -> int:
    """Serve-while-training on the card through `train.main`:
    `ppo_halfcheetah --async-actors 2 --data-plane device --async-correction
    vtrace --serve-port 0` for SERVE_TRAIN_BLOCKS consumed blocks, the
    sidecar polled by a client process of SERVE_POLL_CLIENTS threads back
    to back: V-trace's launches counted on the card equal to the consumed
    blocks, versions monotone, the store at blocks + 1, the served action
    then equal to the learner's own greedy act on its final parameters at
    0.0, p50 / p99 during training against the idle gateway, consumed
    env-steps/s against `without` (the same run without `--serve-port`:
    the async PPO phase's device-plane fp32 run, else run here); then
    `sac_humanoid` with one actor likewise. Returns V-trace's launches on
    the serving PPO run."""
    from actor_critic_tpu_torch.algos import ppo, sac

    base = ["--env", env, "--iterations", str(SERVE_TRAIN_BLOCKS), "--log-every",
            str(ASYNC_LOG_EVERY), "--seed", "0", "--data-plane", "device"]
    ppo_argv = ["--preset", "ppo_halfcheetah", "--async-actors", str(ASYNC_ACTORS),
                "--async-correction", "vtrace", "--set", f"epochs={CHECK_EPOCHS}", *base]
    if without is None:
        without = consumed_rate(*drive(ppo_argv, show_every=ASYNC_LOG_EVERY)[:2])
    logged, summary, launches, probe, net = serve_drive(ppo_argv, ppo, lambda out: out[0])
    check_async_kernel_launches(logged, launches, SERVE_TRAIN_BLOCKS, 1)
    busy = check_sidecar(probe, net, "ppo_halfcheetah", SERVE_TRAIN_BLOCKS,
                         lambda net, o: net(o)[0].mode())
    print(f"serve-while-training ppo_halfcheetah on {env} (device plane, V-trace): "
          f"V-trace launches {launches['vtrace']} in {SERVE_TRAIN_BLOCKS} blocks; consumed "
          f"env-steps/s over blocks {ASYNC_LOG_EVERY}-{SERVE_TRAIN_BLOCKS} "
          f"{consumed_rate(logged, summary):.0f} with the sidecar ({SERVE_POLL_CLIENTS} clients "
          f"back to back), {without:.0f} without; block 1 (the warm-up included) {logged[0]['wall_s']:.2f} s; "
          f"{busy}", flush=True)
    logged, summary, sac_launches, probe, actor = serve_drive(
        ["--preset", "sac_humanoid", "--async-actors", "1", "--set",
         f"warmup_steps={SERVE_SAC_WARMUP}", *base], sac, lambda out: out[0].actor)
    assert sac_launches == {"gae": 0, "vtrace": 0}, sac_launches
    busy = check_sidecar(probe, actor, "sac_humanoid", SERVE_TRAIN_BLOCKS,
                         lambda actor, o: actor(o).mode())
    print(f"serve-while-training sac_humanoid on {env} (device plane, one actor, warm-up "
          f"{SERVE_SAC_WARMUP} env steps): block 1 (the warm-up included) {logged[0]['wall_s']:.2f} s; {busy}",
          flush=True)
    return launches["vtrace"]


def check_sidecar(probe: SidecarProbe, module, label: str, blocks: int, greedy) -> str:
    """The sidecar's contract after a run: each client's versions monotone,
    the store at blocks + 1, its handle's served action (the bucket's graph)
    equal to `greedy(module, obs)` on the card at 0.0; returns the latency
    line."""
    import numpy as np
    import torch

    done = probe.warm_done if probe.warm_done is not None else float("-inf")
    walls = [s for polls in probe.polls for _, _, s, issued in polls if issued >= done]
    waited = [s for polls in probe.polls for _, _, s, issued in polls if issued < done]
    metrics = probe.gateway.batcher.metrics.snapshot()
    assert not probe.failed and metrics["errors_total"] == metrics["shed_total"] == 0, \
        (label, probe.failed[:3], len(probe.failed), metrics)
    assert walls, "no request was served during training"
    seen = sorted({p[0] for polls in probe.polls for p in polls})
    for polls in probe.polls:
        got = [p[0] for p in polls]
        assert got == sorted(got), got
    assert probe.store.ids() == {"learner": blocks + 1}, probe.store.ids()
    handle = probe.store.get("learner")
    served = handle.engine.act(handle.params, probe.obs)
    with torch.no_grad():
        own = greedy(module, torch.from_numpy(probe.obs).cuda()).cpu().numpy()
    diff = float(np.abs(served - own).max())
    assert diff == 0.0, (label, diff)
    # Warmed (the CLI's default): the update was captured before the actors
    # started, so the gate never closes during training.
    assert probe.warm_done is not None and all(t < probe.warm_done for t, _ in probe.closures), (
        label, probe.gate_line())
    return (f"{probe.gate_line()}; "
            f"{len(walls)} requests during training over versions {seen[0]}..{seen[-1]} "
            f"({len(seen)} distinct), monotone; store at {blocks + 1}; final served action = "
            f"the learner's greedy act (max diff {diff}); {len(probe.obs)}-row requests "
            f"issued after the warm-up (during training) {percentiles_ms(walls)}, max "
            f"{max(walls) * 1e3:.1f} ms; {len(waited)} issued in the warm-up waited for its "
            f"end (max {max(waited, default=0.0) * 1e3:.1f} ms); idle gateway "
            f"{percentiles_ms(probe.idle)}")


# -- the warm-up registry and the build cache ------------------------------

WARMUP_A2C_ITERATIONS, WARMUP_A2C_CHUNK = 10, 4  # two full chunks and a 2-iteration tail
WARMUP_HOST_ITERATIONS = 2
CACHE_CHILD = r"""
import json, sys, time
from actor_critic_tpu_torch import _build
from actor_critic_tpu_torch.telemetry import profiler
from actor_critic_tpu_torch.utils import compile_cache

resolved = compile_cache.resolve_cache_dir(sys.argv[1], None)
cache = compile_cache.enable_persistent_cache(resolved or compile_cache.fresh_cache_dir())
t0 = time.perf_counter()
# What a plan entry's build part runs: the path's kernels, the native engine.
compile_cache.Warmup(kernels=("gae", "vtrace"), native=True)()
print(json.dumps({"cache": cache, "seconds": time.perf_counter() - t0,
                  "stats": compile_cache.cache_stats(),
                  "builds": {r["name"]: [r["compile_s"], bool(r.get("cache_hit"))]
                             for r in profiler.compile_records()}}))
"""


@contextlib.contextmanager
def logged_rows(stamps: dict):
    """Stamps `stamps[iteration]` = time.perf_counter() at each row the CLI
    logs (after its float() reads have waited for the card), for the length
    of the block."""
    from actor_critic_tpu_torch.utils.logging import JsonlLogger

    log = JsonlLogger.log

    def stamped(self, iteration, metrics):
        stamps.setdefault(iteration, time.perf_counter())
        return log(self, iteration, metrics)

    JsonlLogger.log = stamped
    try:
        yield stamps
    finally:
        JsonlLogger.log = log


def warmed_against_unwarmed(argv: list[str], label: str, show_every: int) -> dict:
    """`train.main(argv)` warmed (the default) and with `--no-warmup`, each
    with a checkpoint at its end and a telemetry session: the final
    checkpoints (every carried tensor and the generator) and the logged
    metrics of the iterations both log must be equal at 0.0. Returns, by
    mode: the logged rows, the launches, the seconds from `main`'s start to
    each logged row by iteration, the run's `compile` events after its
    `warmup_done` (all of them unwarmed, where captures run in the loop),
    its warm-up events, and its `update` spans' ms."""
    import shutil

    out = {}
    for mode in ("--warmup", "--no-warmup"):
        tel, ck = f"{SCRATCH}/{label}_tel{mode}", f"{SCRATCH}/{label}_ck{mode}"
        for d in (tel, ck):
            shutil.rmtree(d, ignore_errors=True)
        stamps = {}
        t0 = time.perf_counter()
        with logged_rows(stamps):
            logged, summary, launches = drive(
                argv + ["--ckpt-dir", ck, "--save-every", "0", "--telemetry-dir", tel, mode],
                show_every=show_every)
        events = read_jsonl(f"{tel}/events.jsonl")
        done = [i for i, e in enumerate(events) if e["kind"] == "warmup_done"]
        after = events[done[0] + 1:] if done else events
        out[mode] = dict(
            logged=logged, launches=launches, rows_s={it: t - t0 for it, t in stamps.items()},
            loop_compiles=[e for e in after if e["kind"] == "compile" and not e.get("cache_hit")],
            warmup=[e for e in events if e["kind"].startswith("warmup")],
            update_ms=[e["dur"] / 1e3 for e in span_events(tel)
                       if e["ph"] == "X" and e["name"] == "update"],
            state=final_checkpoint(ck, summary["iterations"]))
    warm, cold = out["--warmup"], out["--no-warmup"]
    worst, gen = checkpoint_diff(warm["state"], cold["state"])
    # A warmed run logs its first dispatch's last iteration, an unwarmed one
    # also its eager first: the rows of the iterations both logged.
    common = {r["iter"] for r in warm["logged"]} & {r["iter"] for r in cold["logged"]}

    def rows(run) -> list[dict]:
        return [{k: v for k, v in r.items() if not k.endswith(("_s", "_ms"))}
                for r in run["logged"] if r["iter"] in common]

    rows_equal = warm["logged"][-1]["iter"] in common and rows(warm) == rows(cold)
    done = [e for e in warm["warmup"] if e["kind"] == "warmup_done"]
    entries = [f"{e['entry']} build {e.get('build_s')} s capture {e.get('capture_s')} s"
               for e in warm["warmup"] if e["kind"] == "warmup_compile"]
    captures = [f"{e['name']} {e['compile_s']:.3f} s" for e in cold["loop_compiles"]]
    print(f"warm-up {label}: warmed against --no-warmup, the final checkpoints' worst "
          f"difference {worst:.3e} over {len(warm['state']['tensors'])} tensors, the generator "
          f"{'equal' if not gen else 'DIFFERENT'}, logged metrics at iterations "
          f"{sorted(common)} {'equal' if rows_equal else 'DIFFERENT'}; warm-up {done} "
          f"({', '.join(entries)}); compile events inside the loop: warmed "
          f"{len(warm['loop_compiles'])}, unwarmed {len(cold['loop_compiles'])} "
          f"({', '.join(captures)}); "
          f"seconds from main's start to the end of iteration (logged rows) warmed "
          f"{ {it: round(t, 3) for it, t in warm['rows_s'].items()} }, unwarmed "
          f"{ {it: round(t, 3) for it, t in cold['rows_s'].items()} }; "
          f"update spans warmed {', '.join(f'{m:.3f}' for m in warm['update_ms'])} ms, "
          f"unwarmed {', '.join(f'{m:.3f}' for m in cold['update_ms'])} ms", flush=True)
    assert worst == 0.0 and not gen and rows_equal, (label, worst, gen, rows_equal)
    assert len(done) == 1 and done[0]["errors"] == 0, done
    assert warm["loop_compiles"] == [], warm["loop_compiles"]
    return out


def run_warmup_a2c() -> None:
    """`a2c_cartpole` at full width (E=4096, T=64), `--chunk 4 --iterations
    10` (two full chunks and a 2-iteration tail, so both graphs), warmed
    against `--no-warmup` through `train.main`: equal at 0.0; `compile`
    events inside the loop 0 warmed, 2 unwarmed (the 1-step and the 4-step
    graph); GAE 10 times in 10 real iterations both ways; the seconds from
    `main`'s start to each logged row both ways (the unwarmed run logs its
    eager iteration 1; both log 4, 8 and 10)."""
    n, chunk = WARMUP_A2C_ITERATIONS, WARMUP_A2C_CHUNK
    out = warmed_against_unwarmed(
        ["--preset", "a2c_cartpole", "--iterations", str(n), "--chunk", str(chunk),
         "--log-every", str(chunk), "--seed", "0"], "a2c_cartpole", show_every=n)
    for mode, run in out.items():
        assert run["launches"] == {"gae": n, "vtrace": 0}, (mode, run["launches"])
    assert len(out["--no-warmup"]["loop_compiles"]) == 2, out["--no-warmup"]["loop_compiles"]
    print(f"warm-up a2c_cartpole: GAE launches {out['--warmup']['launches']['gae']} warmed, "
          f"{out['--no-warmup']['launches']['gae']} unwarmed, in {n} iterations", flush=True)


def run_warmup_host_ppo(env: str) -> None:
    """Host `ppo_halfcheetah` on `env` (two epochs), WARMUP_HOST_ITERATIONS
    iterations, warmed against `--no-warmup` through `train.main`: equal at
    0.0; the first iteration's `update` span (a replay warmed, an eager
    update unwarmed) printed; GAE once an iteration both ways."""
    n = WARMUP_HOST_ITERATIONS
    out = warmed_against_unwarmed(
        ["--preset", "ppo_halfcheetah", "--env", env, "--iterations", str(n), "--log-every",
         "1", "--seed", "0", "--set", f"epochs={CHECK_EPOCHS}"], "host_ppo", show_every=1)
    for mode, run in out.items():
        assert run["launches"] == {"gae": n, "vtrace": 0}, (mode, run["launches"])
    print(f"warm-up host ppo_halfcheetah on {env} ({CHECK_EPOCHS} epochs): the first "
          f"iteration's update span {out['--warmup']['update_ms'][0]:.3f} ms warmed (a replay's "
          f"launch), {out['--no-warmup']['update_ms'][0]:.3f} ms unwarmed (an eager update)",
          flush=True)


def _cache_child(value: str) -> subprocess.Popen:
    """A fresh process running a plan entry's build part (CACHE_CHILD) with
    `--compile-cache-dir value`."""
    import os

    return subprocess.Popen([sys.executable, "-c", CACHE_CHILD, value],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": os.getcwd()})


def start_build_cache() -> tuple[str, subprocess.Popen, subprocess.Popen]:
    """The build cache's two cold runs (`none` and an explicit new
    directory), started in the background early in the script: they use
    the host's cores (nvcc, g++), not the card, and `run_build_cache`
    collects them."""
    import os
    import shutil

    explicit = os.path.abspath(f"{SCRATCH}/build_cache")
    shutil.rmtree(explicit, ignore_errors=True)
    return explicit, _cache_child("none"), _cache_child(explicit)


def run_build_cache(started: tuple[str, subprocess.Popen, subprocess.Popen]) -> None:
    """The build cache cold and warm, each a fresh process that runs a plan
    entry's build part for `gae.cu`, `vtrace.cu` and the native engine:
    `--compile-cache-dir none` (a fresh temporary directory: three misses,
    with nvcc's and g++'s seconds) and an explicit new directory, side by
    side (`start_build_cache`, early in the script, beside other phases, so
    their seconds include that contention); then a second process on that
    directory: three hits."""
    import os

    explicit, cold_none, cold_dir = started

    def result(proc: subprocess.Popen) -> dict:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        return json.loads(out.strip().splitlines()[-1])

    runs = {"none (cold)": result(cold_none), "explicit (cold)": result(cold_dir)}
    runs["explicit (warm)"] = result(_cache_child(explicit))
    for label, r in runs.items():
        builds = [f"{k} {s:.2f} s{' (hit)' if hit else ''}" for k, (s, hit) in r["builds"].items()]
        print(f"build cache {label}: {r['cache']}, {r['seconds']:.2f} s, {r['stats']}; "
              f"{', '.join(builds)}", flush=True)
    for label in ("none (cold)", "explicit (cold)"):
        r = runs[label]
        assert r["stats"] == {"hits": 0, "misses": 3}, (label, r)
        assert all(not hit for _, hit in r["builds"].values()), (label, r)
    warm = runs["explicit (warm)"]
    assert warm["stats"] == {"hits": 3, "misses": 0} and warm["cache"] == explicit, warm
    assert runs["none (cold)"]["cache"] != explicit
    assert not os.path.exists(runs["none (cold)"]["cache"]), "the temporary cache outlived its run"


def run_serve_warmup() -> None:
    """The serve CLI (`ppo_cartpole --random-init`, buckets 1 and 4) with
    `--no-warmup`, whose first request captures its bucket's graph, against
    the warmed default: the first batch-1 request's latency each way, and
    the captures each process made before the gateway bound."""
    out = {}
    for mode in ([], ["--no-warmup"]):
        server = ServeProcess(["--preset", "ppo_cartpole", "--random-init", "--port", "0",
                               "--buckets", "1,4", *mode])
        try:
            conn = KeepAlive(server.url)
            walls = []
            for _ in range(21):  # the first request timed too
                t0 = time.perf_counter()
                conn.post("/v1/act", {"obs": [0.01, 0.02, 0.03, 0.04]})
                walls.append(time.perf_counter() - t0)
            conn.close()
        finally:
            server.stop()
        warm = [x for x in server.lines if x.startswith("warm: ")]
        out["--no-warmup" if mode else "warmed"] = (walls, warm)
    for label, (walls, warm) in out.items():
        print(f"serve CLI {label}: first request {walls[0] * 1e3:.3f} ms, the next 20 "
              f"{percentiles_ms(walls[1:])}; {warm}", flush=True)
    assert out["warmed"][1] == ["warm: 2 act buckets captured"], out["warmed"][1]
    assert out["--no-warmup"][1][0].startswith("warm: skipped"), out["--no-warmup"][1]


# -- precision: the TF32 pin and bf16 compute ------------------------------

TF32_REPLAYS = 20            # impala_pong graph replays a turn
BF16_FUSED_PRESETS = ("a2c_cartpole", "ppo_cartpole", "impala_pong", "impala_pong_learn",
                      "a3c_pong", "a2c_mixture")
BF16_GRAPH_PRESETS = ("a2c_cartpole", "ppo_cartpole", "impala_pong", "a2c_mixture")
BF16_ITERATIONS = 5          # through train.main: five replays, warmed
BF16_HOST_PPO_ITERATIONS = 3  # two eager updates, then the graph
BF16_ASYNC_BLOCKS = 5
BF16_SAC_WARMUP = 256        # env steps: the SAC learner's gate opens at iteration 5
BF16_SAC_ITERATIONS = 6
BF16_SERVE_PRESETS = ("ppo_cartpole", "ppo_halfcheetah")
PROFILE_REPLAYS = 6         # graph replays a turn, float32 against bf16
PROFILE_PRESETS = (("a2c_cartpole", 3, ""), ("impala_pong", 3, ""))


def check_tf32() -> None:
    """Queue 3's TF32 fault, measured, then pinned: one IMPALA update at
    `impala_pong`'s full width (84×84×2 frames, E=64, T=20, the Nature CNN)
    on the card against the same update on the CPU, once under torch's
    default precision (cuDNN's float32 convolutions in TF32) and once with
    the port's pinned flags (full float32, deterministic algorithms), the
    largest parameter and relative metric differences of each; the pinned
    one within `check_impala_update_on_card`'s float32 tolerances. Then
    `impala_pong`'s ms a graph replay under torch's defaults, under full
    float32 with cuDNN's free choice of algorithm and under the pin (a
    capture each, replayed in turns there and back; host clock,
    synchronised) and the TF32 kernels each replay runs (torch.profiler)."""
    import copy

    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import impala, loop
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS["impala_pong"]
    cfg = preset.config
    env = train.make_env(preset.env, preset.env_kwargs)
    cpu = impala.init_state(env, cfg, seed=3, device="cpu")
    traj = impala.rollout(env, cfg, cpu)
    gaps = {}
    for default in (True, False):
        params, m_cpu, m_gpu = update_on_card_vs_cpu(impala, env, cfg, copy.deepcopy(cpu), traj,
                                                     default_precision=default)
        gaps[default] = fp32_gaps(params, m_cpu, m_gpu, IMPALA_METRICS)
        print(f"impala_pong update on card vs CPU (84 px, E=64, T=20), "
              f"{'torch default precision (TF32 convolutions)' if default else 'pinned precision'}: "
              f"max abs parameter difference {gaps[default][0]:.3e} ({gaps[default][0] / cfg.lr:.3e}·lr), "
              f"largest relative metric difference {gaps[default][1]:.3e}; metrics on the card "
              f"{ {k: round(float(m_gpu[k]), 6) for k in IMPALA_METRICS} }", flush=True)
        if not default:
            assert_fp32_update("impala_pong update on card, pinned", params, m_cpu, m_gpu,
                               1e-4 * cfg.lr, IMPALA_METRICS, 1e-6, 1e-4)
    assert gaps[False][0] <= gaps[True][0], gaps

    # torch's defaults; full float32 with cuDNN's free choice of algorithm;
    # the pin (full float32, deterministic algorithms).
    settings = {"TF32": (True, False), "float32": (False, False), "pinned": (False, True)}
    state = impala.init_state(env, cfg, seed=1, device="cuda")
    step = impala.make_train_step(env, cfg)
    side = torch.cuda.Stream()
    graphs = {}
    for label, flags in settings.items():
        with precision_flags(*flags):
            for _ in range(loop.WARMUP_ITERATIONS):
                loop.eager_step(step, state, side)
            torch.cuda.synchronize()
            graphs[label] = loop.CapturedStep(step, state)
    ms: dict[str, list[float]] = {label: [] for label in settings}
    for label in (*settings, *reversed(settings)):
        graphs[label].replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TF32_REPLAYS):
            graphs[label].replay()
        torch.cuda.synchronize()
        ms[label].append((time.perf_counter() - t0) / TF32_REPLAYS * 1e3)
    tf32_kernels = {}
    for label in settings:
        kernels, _ = profile_kernels(graphs[label].replay, iters=1)
        tf32_kernels[label] = sum(c for k, (c, _) in kernels.items() if "tf32" in k.lower())
    mean = {label: sum(v) / len(v) for label, v in ms.items()}
    print(f"impala_pong graph replay (E=64, T=20, 84 px; {TF32_REPLAYS} replays a turn, in "
          f"turns {', '.join(settings)} and back): "
          + "; ".join(f"{label} {v[0]:.3f} / {v[1]:.3f} ms" for label, v in ms.items())
          + f" a replay (host clock, synchronised); against TF32, float32 costs "
          f"{mean['float32'] / mean['TF32'] - 1:+.1%} and the pin "
          f"{mean['pinned'] / mean['TF32'] - 1:+.1%}; kernels with 'tf32' in their name a "
          f"replay: {tf32_kernels}", flush=True)
    assert tf32_kernels["pinned"] == 0 and tf32_kernels["float32"] == 0, tf32_kernels


def run_bf16_main_paths(env: str) -> dict[str, dict[str, int]]:
    """`--update-dtype bf16` through `train.main` on every path that reaches
    it, each kernel's launch count reset just before each run and read just
    after: the six fused presets for BF16_ITERATIONS iterations (the CUDA
    graph from iteration 1, warmed), host `ppo_halfcheetah`, async `ppo_halfcheetah`
    (2 actors, device plane; both at CHECK_EPOCHS) and host and async
    `sac_humanoid` (1 actor,
    device plane, the warm-up cut to BF16_SAC_WARMUP env steps) on `env`.
    GAE and V-trace launch once an iteration (or consumed block), as in
    float32. Returns {kernel: {path: launches}}."""
    import math

    from actor_critic_tpu_torch.config import PRESETS

    by_path: dict[str, dict[str, int]] = {"gae": {}, "vtrace": {}}
    n = BF16_ITERATIONS
    for preset_name in BF16_FUSED_PRESETS:
        logged, summary, launches = drive(
            ["--preset", preset_name, "--update-dtype", "bf16", "--iterations", str(n),
             "--log-every", "1", "--seed", "0"], show_every=n)
        check_rows(logged, n)
        kernel = "vtrace" if getattr(PRESETS[preset_name].config, "correction", "") == "vtrace" \
            else "gae"
        assert launches == {**{"gae": 0, "vtrace": 0}, kernel: n}, (preset_name, launches)
        by_path[kernel][f"{preset_name} bf16"] = launches[kernel]
        print(f"main path {preset_name} --update-dtype bf16 (CUDA graph): {n} iterations, "
              f"{graph_timing(logged, summary)}; launches {launches}", flush=True)
    m = BF16_HOST_PPO_ITERATIONS
    logged, summary, launches = drive(
        ["--preset", "ppo_halfcheetah", "--env", env, "--update-dtype", "bf16", "--iterations",
         str(m), "--log-every", "1", "--seed", "0", "--set", f"epochs={CHECK_EPOCHS}"],
        show_every=m)
    check_rows(logged, m)
    assert launches == {"gae": m, "vtrace": 0}, launches
    by_path["gae"]["host ppo_halfcheetah bf16"] = launches["gae"]
    print(f"main path host ppo_halfcheetah --update-dtype bf16 on {env}: {m} iterations of "
          f"{CHECK_EPOCHS} epochs, "
          f"launches {launches}; {host_split(logged, 3)}", flush=True)
    b = BF16_ASYNC_BLOCKS
    logged, summary, launches = drive(
        ["--preset", "ppo_halfcheetah", "--env", env, "--update-dtype", "bf16",
         "--async-actors", str(ASYNC_ACTORS), "--iterations", str(b), "--log-every", "1",
         "--seed", "0", "--data-plane", "device", "--set", f"epochs={CHECK_EPOCHS}"],
        show_every=b)
    check_rows(logged, b)
    check_async_kernel_launches(logged, launches, b, 1)
    by_path["vtrace"]["async ppo_halfcheetah bf16 (device plane)"] = launches["vtrace"]
    print(f"main path async ppo_halfcheetah --update-dtype bf16 on {env} (device plane, "
          f"{CHECK_EPOCHS} epochs): {b} "
          f"consumed blocks, launches {launches}, mean_rho {logged[-1]['mean_rho']:.4f}",
          flush=True)
    k = BF16_SAC_ITERATIONS
    for extra in ([], ["--async-actors", "1", "--data-plane", "device"]):
        logged, summary, launches = drive(
            ["--preset", "sac_humanoid", "--env", env, "--update-dtype", "bf16", "--set",
             f"warmup_steps={BF16_SAC_WARMUP}", "--iterations", str(k), "--log-every", "1",
             "--seed", "0", *extra], show_every=k)
        check_rows(logged, k, keys=("critic_loss", "actor_loss", "q_mean"))
        assert launches == {"gae": 0, "vtrace": 0}, launches
        assert logged[-1]["env_steps"] > BF16_SAC_WARMUP and math.isfinite(summary["critic_loss"])
        print(f"main path {'async ' if extra else 'host '}sac_humanoid --update-dtype bf16 on "
              f"{env}: {k} iterations, warm-up {BF16_SAC_WARMUP}, final critic_loss "
              f"{summary['critic_loss']:.4f}, alpha {summary['alpha']:.4f}", flush=True)
    return by_path


def replays_in_turns(graphs: dict) -> dict[bool, list[float]]:
    """ms a graph replay of a preset's train step in float32 and in bf16
    (`graphs[bf16]`: `profile_step`'s (state, step, `CapturedStep`)), replayed in
    turns: float32, bf16, bf16, float32, PROFILE_REPLAYS replays a turn
    (host clock, synchronised). Returns {bf16: [ms of each turn]}."""
    import torch

    ms: dict[bool, list[float]] = {False: [], True: []}
    for bf16 in (False, True, True, False):
        _, _, captured = graphs[bf16]
        captured.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_REPLAYS):
            captured.replay()
        torch.cuda.synchronize()
        ms[bf16].append((time.perf_counter() - t0) / PROFILE_REPLAYS * 1e3)
    return ms


def compare_profiles(profiles: dict, replays: dict) -> None:
    """float32 against bf16 for each profiled preset, from one call on one
    card: ms a graph replay in turns (`replays_in_turns`), and launches and
    device busy ms a step (`profile_step`, torch.profiler)."""
    for preset_name, _, _ in PROFILE_PRESETS:
        fp32, bf16 = profiles[(preset_name, False)], profiles[(preset_name, True)]
        ms = replays[preset_name]
        a, b = sum(ms[False]) / 2, sum(ms[True]) / 2
        print(f"fp32 vs bf16, {preset_name} graph replays in turns (fp32, bf16, bf16, fp32; "
              f"{PROFILE_REPLAYS} a turn): {ms[False][0]:.3f} / {ms[True][0]:.3f} / "
              f"{ms[True][1]:.3f} / {ms[False][1]:.3f} ms, fp32 {a:.3f} vs bf16 {b:.3f} ms a "
              f"replay ({b / a - 1:+.1%})", flush=True)
        for mode in bf16:
            (ms32, n32, busy32), (ms16, n16, busy16) = fp32[mode], bf16[mode]
            print(f"fp32 vs bf16, {preset_name} {mode}: {n32:.0f} vs {n16:.0f} kernel launches "
                  f"a step ({n16 / n32 - 1:+.1%}), device busy {busy32:.3f} vs {busy16:.3f} ms a "
                  f"step, {ms32:.3f} vs {ms16:.3f} ms a step (host clock, one profile run each)",
                  flush=True)


# -- telemetry and the stall watchdog -----------------------------------

TELEMETRY_ITERATIONS, TELEMETRY_CHUNK, TELEMETRY_SAVE = 24, 4, 8
TELEMETRY_TIMING_ITERATIONS = 32  # 6 logged chunks of replays from iteration 8
TELEMETRY_ROUNDS = 1          # the session's cost: each variant this many times, in turns
TELEMETRY_HOST_ITERATIONS = 4  # four replays (warmed)
TELEMETRY_ASYNC_BLOCKS = 4     # two eager blocks, the capture, a replay
TELEMETRY_ASYNC_SAMPLE_S = 0.5  # the run takes ~4 s: rows while blocks are consumed
TELEMETRY_SAMPLE_S = 0.02     # the sampler ticks through every capture of the run
STALL_TIMEOUT_S, STALL_SPIN_S = 2.0, 15.0


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def span_events(tel: str) -> list[dict]:
    return [e for e in read_jsonl(f"{tel}/spans.jsonl") if e["ph"] != "M"]


def check_canonical(tel: str) -> None:
    from actor_critic_tpu_torch import telemetry

    names = {e["name"] for e in span_events(tel) if e["ph"] in ("X", "i")}
    assert names <= telemetry.CANONICAL_PHASES, names - telemetry.CANONICAL_PHASES


def dispatch_sequence(tel: str, chunk: int) -> list[tuple]:
    """(name, args) of the fused loop's update, log and checkpoint spans at
    chunk boundaries, in file order. The card's eager warm-up dispatches
    (one iteration each, iterations 1 and 2) have no CPU counterpart."""
    out = []
    for e in span_events(tel):
        args = e.get("args", {})
        at = args.get("it", args.get("step"))
        if e["name"] in ("update", "log", "checkpoint") and at % chunk == 0:
            out.append((e["name"], tuple(sorted(args.items()))))
    return out


def replay_ms(logged: list[dict], after: int) -> float:
    """The median ms an iteration between consecutive logged rows from
    iteration `after` on (robust to the chunks a profiler window covered)."""
    import statistics

    rows = [r for r in logged if r["iter"] >= after]
    per = [(b["wall_s"] - a["wall_s"]) / (b["iter"] - a["iter"]) * 1e3
           for a, b in zip(rows, rows[1:])]
    return statistics.median(per)


def gpu_rows(tel: str) -> list[dict]:
    """The card's rows of every resources.jsonl row (`platform` "gpu")."""
    return [d for r in read_jsonl(f"{tel}/resources.jsonl") for d in r.get("devices", [])
            if d.get("platform") == "gpu"]


def sampled(label: str, fn, *args):
    """`fn(*args)` inside a TelemetrySession whose sampler reads the card's
    memory every TELEMETRY_SAMPLE_S, through whatever captures `fn` makes
    (the fused loop captures in "global" mode, where a forbidden CUDA call
    from the sampler's thread would break the capture). Prints the rows and
    the captures' seconds."""
    import shutil

    from actor_critic_tpu_torch import telemetry

    tel = f"{SCRATCH}/sampled_{label}"
    shutil.rmtree(tel, ignore_errors=True)
    session = telemetry.TelemetrySession(tel, resource_interval_s=TELEMETRY_SAMPLE_S)
    telemetry.set_current(session)
    try:
        out = fn(*args)
    finally:
        session.close()
    rows = read_jsonl(f"{tel}/resources.jsonl")
    comps = [e for e in read_jsonl(f"{tel}/events.jsonl") if e["kind"] == "compile"]
    print(f"{label} with the sampler at {TELEMETRY_SAMPLE_S * 1e3:.0f} ms: {len(rows)} rows, "
          f"captures {', '.join(f'{e['name']} {e['compile_s']:.3f} s' for e in comps)}",
          flush=True)
    devs = gpu_rows(tel)
    assert len(rows) >= 3 and comps and devs and max(d["live_bytes"] for d in devs) > 0
    return out


def run_telemetry_a2c(heap: "FrozenHeap") -> subprocess.Popen:
    """`a2c_cartpole` at full width (E=4096, T=64) through `train.main` with
    the session, the exporter, the watchdog and the chunk-wall ratchet:
    `--chunk 4 --ckpt-dir --save-every 8 --stall-timeout 30 --telemetry-dir
    --telemetry-port 0 --telemetry-sample-s 0.02`, 24 iterations. A client
    thread scrapes /metrics and /healthz while it runs and arms a window
    (GET `/profile?iters=2`, JAX's route) once the run's capture is
    counted. Holds: the
    spans canonical and the per-dispatch update/log/checkpoint sequence the
    CPU run's (the same flags at E=64 on the CPU); the card's rows with
    live and peak bytes; `recompiles` = the run's captures = its `compile`
    events (seconds printed); `chunk_wall.json` below the 4-step capture's
    wall (the scraper inflates it: printed); the profile window's trace holding GAE exactly
    2 x 4 times while the device counter's GAE launches equal the
    iterations. The run is warmed (the CLI's default): its one graph, the
    4-step one (24 iterations from 0 run no partial chunk), is captured by
    the warm-up before the first dispatch. Then the session's cost,
    TELEMETRY_TIMING_ITERATIONS iterations a run, the variants in turns for TELEMETRY_ROUNDS rounds,
    every run with the watchdog armed and no client: without the session,
    with it at the default 5 s sampling, with it at 20 ms. Each run's
    `chunk_wall.json` is held within 1.5 x 4 x its own replay ms + 5 ms
    (the ratio printed). Each in-process run starts after `heap.collect()`,
    so that the previous run's garbage is not destroyed inside its timed
    chunks. Returns `scripts/run_report.py` on the run's
    directory, started in a subprocess (its static-findings pass reads the
    whole tree for tens of seconds: it runs beside the next phases, and
    `wait_run_report` holds it to exit 0)."""
    import os
    import shutil
    import statistics
    import threading
    import urllib.request

    from actor_critic_tpu_torch import telemetry
    from actor_critic_tpu_torch.telemetry import profiler

    n, chunk = TELEMETRY_ITERATIONS, TELEMETRY_CHUNK
    tel, ck = f"{SCRATCH}/telemetry_a2c", f"{SCRATCH}/telemetry_a2c_ck"
    common = ["--preset", "a2c_cartpole", "--iterations", str(n), "--chunk", str(chunk),
              "--save-every", str(TELEMETRY_SAVE), "--log-every", str(chunk), "--seed", "0",
              "--stall-timeout", "30"]
    flags = ["--telemetry-dir", tel, "--telemetry-port", "0", "--telemetry-sample-s",
             str(TELEMETRY_SAMPLE_S)]
    for d in (tel, ck, f"{tel}_cpu", f"{ck}_cpu"):
        shutil.rmtree(d, ignore_errors=True)
    base = profiler.recompile_count()
    scraped = {"metrics": 0, "healthz": 0}
    stop = threading.Event()
    errors: list = []

    def client():
        try:
            while telemetry.current() is None or telemetry.current().exporter is None:
                if stop.wait(0.005):
                    return
            session = telemetry.current()
            url = session.exporter.url
            armed = False
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                        body = r.read().decode()
                    scraped["metrics"] += 1
                    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                        assert json.loads(r.read())["status"] == "ok"
                    scraped["healthz"] += 1
                except OSError:
                    # The run's end closes the exporter before it marks the
                    # session closed: a scrape cut by that is not an error.
                    deadline = time.monotonic() + 10
                    while not session.closed and time.monotonic() < deadline:
                        time.sleep(0.01)
                    if session.closed:
                        return
                    raise
                rec = [float(x.split()[-1]) for x in body.splitlines()
                       if x.startswith("actor_critic_recompiles_total ")]
                if not armed and rec and rec[0] >= base + 1:
                    with urllib.request.urlopen(url + "/profile?iters=2", timeout=10) as r:
                        assert r.status == 202
                    armed = True
                    scraped["armed_at_recompiles"] = rec[0] - base
                stop.wait(0.005)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    try:
        heap.collect()
        logged, _, launches = drive(common + flags + ["--ckpt-dir", ck], show_every=n)
    finally:
        stop.set()
        t.join(30)
    assert not errors, errors
    events = read_jsonl(f"{tel}/events.jsonl")
    comps = [e for e in events if e["kind"] == "compile"]
    captures = [e for e in comps if not e.get("cache_hit")]
    rows = read_jsonl(f"{tel}/resources.jsonl")
    devs = gpu_rows(tel)
    made = rows[-1]["recompiles"] - rows[0]["recompiles"]
    done = [e for e in events if e["kind"] == "profile_done"]
    gae_in_window = None
    if len(done) == 1:
        with open(os.path.join(done[0]["path"], "trace.json")) as f:
            gae_in_window = sum(1 for e in json.load(f)["traceEvents"]
                                if e.get("cat") == "kernel" and "gae" in e["name"])
    with open(f"{ck}/chunk_wall.json") as f:
        wall_ms = json.load(f)["chunk_wall_s"] * 1e3
    ms_on = replay_ms(logged, 2 * chunk)
    x4 = [e["compile_s"] * 1e3 for e in captures if e["name"].endswith(f"[x{chunk}]")]

    # The session's cost, the variants in turns; then the CPU run at E=64
    # for the spans.
    variants = {"off": [], "on 5 s": ["--telemetry-port", "0"],
                "on 20 ms": ["--telemetry-port", "0", "--telemetry-sample-s",
                             str(TELEMETRY_SAMPLE_S)]}
    timed = [*common[:common.index("--iterations")], "--iterations",
             str(TELEMETRY_TIMING_ITERATIONS), *common[common.index("--iterations") + 2:]]
    ms = {v: [] for v in variants}
    walls = {v: [] for v in variants}
    for r in range(TELEMETRY_ROUNDS):
        for i, (v, extra) in enumerate(variants.items()):
            d, ck_d = f"{tel}_timing{r}{i}", f"{ck}_timing{r}{i}"
            for x in (d, ck_d):
                shutil.rmtree(x, ignore_errors=True)
            session = ["--telemetry-dir", d, *extra] if extra else []
            heap.collect()
            logged_v, _, launches_v = drive(timed + session + ["--ckpt-dir", ck_d],
                                            show_every=TELEMETRY_TIMING_ITERATIONS)
            assert launches_v["gae"] == TELEMETRY_TIMING_ITERATIONS, (v, launches_v)
            ms[v].append(replay_ms(logged_v, 2 * chunk))
            with open(f"{ck_d}/chunk_wall.json") as f:
                walls[v].append(json.load(f)["chunk_wall_s"] * 1e3)
    cpu_flags = ["--telemetry-dir", f"{tel}_cpu", "--telemetry-sample-s", str(TELEMETRY_SAMPLE_S)]
    heap.collect()
    drive(common + cpu_flags + ["--ckpt-dir", f"{ck}_cpu", "--set", "num_envs=64", "--device",
                                "cpu"], show_every=n)
    card_seq, cpu_seq = dispatch_sequence(tel, chunk), dispatch_sequence(f"{tel}_cpu", chunk)
    live = [d.get("live_bytes") for d in devs]
    med = {v: statistics.median(x) for v, x in ms.items()}
    ratios = {v: [w / (chunk * m) for w, m in zip(walls[v], ms[v])] for v in variants}
    print(f"telemetry a2c_cartpole (E=4096, T=64, --chunk {chunk}, {n} iterations): "
          f"{len(rows)} resource rows, {len(devs)} of the card, live bytes {min(live)} .. "
          f"{max(live)}, peak {max(d.get('peak_bytes', 0) for d in devs)}; recompiles {made}, "
          f"captures {', '.join(f'{e['name']} {e['compile_s']:.3f} s' for e in captures)}; "
          f"{scraped['metrics']} /metrics and {scraped['healthz']} /healthz scrapes; the window "
          f"armed after {scraped.get('armed_at_recompiles')} captures: {done}, GAE "
          f"{gae_in_window} times in its trace (device counter: {launches['gae']} for {n} "
          f"iterations); update/log/checkpoint sequence {'=' if card_seq == cpu_seq else '!='} "
          f"the CPU run's ({len(card_seq)} spans); with this process's client thread scraping "
          f"/metrics and /healthz every 5 ms: {ms_on:.3f} ms/iteration of the replays (median "
          f"of chunks from iteration {2 * chunk}), chunk_wall.json {wall_ms:.3f} ms (the "
          f"{chunk}-step capture {x4} ms)", flush=True)
    for v in variants:
        print(f"telemetry a2c_cartpole, the session's cost ({TELEMETRY_TIMING_ITERATIONS} "
              f"iterations a run, the watchdog armed, no client, {TELEMETRY_ROUNDS} rounds in "
              f"turns): {v}: ms/iteration of the replays {', '.join(f'{x:.3f}' for x in ms[v])} "
              f"(median {med[v]:.3f}, {(med[v] / med['off'] - 1) * 100:+.1f}% against off); "
              f"chunk_wall.json {', '.join(f'{w:.3f}' for w in walls[v])} ms = "
              f"{', '.join(f'{x:.3f}' for x in ratios[v])} x {chunk} x the run's replay ms",
              flush=True)
    check_canonical(tel)
    assert devs and all("live_bytes" in d and d["peak_bytes"] >= d["live_bytes"] for d in devs)
    assert max(live) > 0, live
    assert made == len(captures) == 1, (made, comps)
    assert len(done) == 1 and "cut_by" not in done[0], done
    assert gae_in_window == 2 * chunk, gae_in_window
    assert launches["gae"] == n, launches
    assert x4 and wall_ms < x4[0], (wall_ms, x4)
    for v in variants:
        for w, m in zip(walls[v], ms[v]):
            assert w < 1.5 * chunk * m + 5.0, (v, w, m)
    assert card_seq == cpu_seq, (card_seq, cpu_seq)
    # After the timed runs, so that it does not share the host with them,
    # and after the checks, so that a failed phase leaves no process behind.
    return subprocess.Popen([sys.executable, "scripts/run_report.py", tel, "-o",
                             f"{tel}/report.md"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def wait_run_report(report: subprocess.Popen) -> None:
    out, err = report.communicate(timeout=300)
    assert report.returncode == 0, err[-2000:]
    print(f"scripts/run_report.py on the telemetry a2c_cartpole run: exit 0 "
          f"({report.args[2]}/report.md)", flush=True)


def check_async_telemetry(tel: str, n: int, env: str) -> None:
    """The async PPO run's spans and gauges (device plane, V-trace):
    `env_step` spans on the two actor threads, `queue_wait` and `update` on
    the learner's (one a block), names canonical, and the `device_ring`
    gauge in resources.jsonl (the run's ring: it consumed blocks; rings
    left open by earlier phases keep the plain key, so this one may carry
    a suffix)."""
    check_canonical(tel)
    spans = [e for e in span_events(tel) if e["ph"] == "X"]
    learner = {e["tid"] for e in spans if e["name"] in ("queue_wait", "update")}
    actors = {e["tid"] for e in spans if e["name"] == "env_step"}
    ring = [v for r in read_jsonl(f"{tel}/resources.jsonl") for k, v in r.items()
            if k.startswith("device_ring") and v.get("gets", 0) > 0]
    update_ms = [e["dur"] / 1e3 for e in spans if e["name"] == "update"]
    print(f"telemetry async ppo_halfcheetah on {env}, device plane: env_step spans on "
          f"{len(actors)} actor threads, queue_wait/update on {len(learner)} learner thread; "
          f"{len(ring)} device_ring gauge rows (last: gets {ring[-1]['gets'] if ring else None}, "
          f"drops full {ring[-1]['drops_full'] if ring else None}); update span "
          f"{', '.join(f'{m:.3f}' for m in update_ms)} ms", flush=True)
    assert len(learner) == 1 and len(actors) == ASYNC_ACTORS and not learner & actors, (
        learner, actors)
    assert sum(e["name"] == "update" for e in spans) == n
    assert sum(e["name"] == "queue_wait" for e in spans) == n
    assert ring, "no device_ring gauge row of the run's ring"


STALL_CHILD = r"""
import sys, time
import torch
from actor_critic_tpu_torch import telemetry
from actor_critic_tpu_torch.utils.watchdog import StallWatchdog

session = telemetry.TelemetrySession(sys.argv[1], sample_resources=False)
telemetry.set_current(session)
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
# The spin's clock cycles a second, timed on a short spin.
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
torch.cuda._sleep(100_000_000)
end.record()
end.synchronize()
cycles = int(float(sys.argv[2]) * 100_000_000 / (start.elapsed_time(end) / 1e3))
StallWatchdog(float(sys.argv[3]), startup_grace_s=0.0).start()
print(f"armed {time.time()}", flush=True)
with telemetry.span("update", it=1):
    torch.cuda._sleep(cycles)  # a kernel that spins: the wedged device
    torch.cuda.synchronize()
print("unreachable", flush=True)
"""


def run_stall_on_card(beside=None) -> None:
    """The card's counterpart of the wedge the watchdog exists for: a child
    arms `StallWatchdog(2.0, startup_grace_s=0)` under a session, opens an
    `update` span and synchronizes on a ~15 s GPU spin. It must exit 42
    within timeout + poll + 2 s of arming, its stderr naming `update`, with
    a `stall` event in events.jsonl and a flight dump beside it. `beside()`
    (another phase) runs while the child starts and stalls; a thread
    records the child's exit time."""
    import os
    import shutil
    import threading

    from actor_critic_tpu_torch.telemetry import flight

    tel = os.path.abspath(f"{SCRATCH}/telemetry_stall")
    shutil.rmtree(tel, ignore_errors=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", STALL_CHILD, tel, str(STALL_SPIN_S), str(STALL_TIMEOUT_S)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.getcwd()})
    exits: list[float] = []
    waiter = threading.Thread(target=lambda: (proc.wait(), exits.append(time.time())),
                              daemon=True)
    waiter.start()
    try:
        if beside is not None:
            beside()
        waiter.join(120)
        out = proc.stdout.read()
        armed = [float(x.split()[1]) for x in out.splitlines() if x.startswith("armed ")]
        assert armed and exits, (out, proc.stderr.read())
        armed, exited, rc = armed[0], exits[0], proc.returncode
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    err = proc.stderr.read()
    diag = [x for x in err.splitlines() if "stall-watchdog" in x]
    poll = min(5.0, STALL_TIMEOUT_S / 4)
    stall = [e for e in read_jsonl(f"{tel}/events.jsonl") if e["kind"] == "stall"]
    print(f"stall on the card: exit {rc} {exited - armed:.2f} s after arming (timeout "
          f"{STALL_TIMEOUT_S} s, poll {poll} s, spin {STALL_SPIN_S} s); {diag}; stall event "
          f"{stall}; flight dumps {[os.path.basename(p) for p in flight.find_dumps(tel)]}",
          flush=True)
    assert rc == 42, (rc, err[-2000:])
    assert exited - armed <= STALL_TIMEOUT_S + poll + 2.0, exited - armed
    assert diag and "last open telemetry span: 'update'" in diag[0], err[-2000:]
    assert len(stall) == 1 and stall[0]["phase"] == "update", stall
    assert len(flight.find_dumps(tel)) == 1


def run_telemetry_serve() -> None:
    """`python -m actor_critic_tpu_torch.serve --preset ppo_cartpole
    --random-init --port 0 --telemetry-dir` in a subprocess: requests with
    trace ids give serve_parse, serve_queue_wait, serve_dispatch,
    serve_respond and serve_request spans linked by flows; /metrics has the
    card's memory rows and the serving gauge; the bucket captures are
    `compile` events."""
    import os
    import shutil

    tel = os.path.abspath(f"{SCRATCH}/telemetry_serve")
    shutil.rmtree(tel, ignore_errors=True)
    server = ServeProcess(["--preset", "ppo_cartpole", "--random-init", "--port", "0",
                           "--buckets", "1,4", "--telemetry-dir", tel])
    try:
        import urllib.request

        for i in range(4):
            req = urllib.request.Request(
                server.url + "/v1/act", data=json.dumps({"obs": [0.01 * i] * 4}).encode(),
                headers={"x-trace-id": f"smoke{i}"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert json.loads(r.read())["trace"] == f"smoke{i}"
        with urllib.request.urlopen(server.url + "/metrics", timeout=30) as r:
            body = r.read().decode()
    finally:
        server.stop()
    check_canonical(tel)
    spans = span_events(tel)
    hops = {e["name"] for e in spans if e.get("args", {}).get("trace") == "smoke3"}
    assert hops >= {"serve_parse", "serve_queue_wait", "serve_respond", "serve_request"}, hops
    assert any(e["name"] == "serve_dispatch" for e in spans)
    flows = {e["ph"] for e in spans if e.get("cat") == "flow"}
    assert flows == {"s", "t", "f"}, flows
    mem = [x for x in body.splitlines() if x.startswith("actor_critic_device_live_bytes{")]
    assert mem and float(mem[0].split()[-1]) > 0, mem
    assert "actor_critic_serving_requests_total" in body
    comps = [e for e in read_jsonl(f"{tel}/events.jsonl") if e["kind"] == "compile"]
    assert len(comps) == 2, comps  # buckets 1 and 4, one lane
    print(f"telemetry serve: hops of one request {sorted(hops)}, flows {sorted(flows)}; "
          f"/metrics {mem[0]}; bucket captures "
          f"{', '.join(f'{e['name']} {e['compile_s']:.3f} s' for e in comps)}", flush=True)


# -- data and sequence parallelism of the fused trainers (world 1, NCCL) ----

DP_ITERATIONS = 5        # two eager, a capture, then replays
DP_OFFPOLICY_ITERATIONS = 5  # the same; the gate opens at 4, a replay
SP_ITERATIONS = 3        # make_sp_update / make_sp_train_step: two eager, a capture + replay
SEQPAR_T, SEQPAR_E = 4096, 64
# tests/test_seqpar.py's tolerances: the sharded scans against the plain
# ones (1e-5), the sp learner update against the unsharded one (params
# rtol 1e-4, atol 1e-5; loss and mean ρ rtol 1e-5) and the sp train step's
# parameters (rtol 2e-4, atol 1e-5). At world 1 the sharded V-trace
# rounds where the kernel does not (B = vs − v, then B + v).
SEQPAR_TOL = dict(rtol=1e-5, atol=1e-5)
SP_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
SP_TRAIN_TOL = dict(rtol=2e-4, atol=1e-5)


@contextlib.contextmanager
def nccl_world1():
    """A one-rank NCCL process group on the card for the dp and sp phases
    (`multihost.distributed_init`), destroyed after them."""
    import torch.distributed as dist

    from actor_critic_tpu_torch.parallel import launch, multihost

    multihost.distributed_init(f"127.0.0.1:{launch.free_port()}", 1, 0, "cuda")
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        yield
    finally:
        dist.destroy_process_group()


class QuantizerCollectives:
    """Counts the replay quantizer's `pmean` and `pmax` calls issued while a
    CUDA graph was capturing (`replay/quantize.py` binds both from
    `parallel/mesh.py`)."""

    def __enter__(self):
        import torch

        from actor_critic_tpu_torch.replay import quantize

        self.counts = {"pmean": 0, "pmax": 0}
        self._orig = {k: getattr(quantize, k) for k in self.counts}

        def counting(name):
            def fn(x, group):
                if torch.cuda.is_current_stream_capturing():
                    self.counts[name] += 1
                return self._orig[name](x, group)
            return fn

        for k in self.counts:
            setattr(quantize, k, counting(k))
        return self

    def __exit__(self, *exc):
        from actor_critic_tpu_torch.replay import quantize

        for k, fn in self._orig.items():
            setattr(quantize, k, fn)


def run_record(state, metrics) -> dict:
    """Every carried tensor of `state`, its generator's state and the
    metrics, by name."""
    from actor_critic_tpu_torch.algos.common import carried_tensors

    out = dict(carried_tensors(state), generator=state.generator.get_state())
    out.update({f"metric {k}": v for k, v in metrics.items()})
    return out


def record_diff(a: dict, b: dict) -> tuple[float, str, int, int]:
    """(max abs difference, where, elements not bitwise equal, tensors) of
    two records with the same names."""
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))
    diffs = {k: float((a[k].double() - b[k].double()).abs().max()) for k in a}
    mismatches = sum(int((a[k] != b[k]).sum()) for k in a)
    worst = max(diffs, key=diffs.get)
    return diffs[worst], worst, mismatches, len(a)


def run_dp_fused(preset_name: str) -> int:
    """The data-parallel fused step at a preset's full width over a one-rank
    NCCL group (`parallel.mesh.make_mesh`): `distribute_state` →
    `make_dp_train_step(make_train_step(group=...))` → `fused_train_loop`
    for DP_ITERATIONS iterations (two eager, a capture in "thread_local"
    mode, replays), three times from one seed: through the graph, eagerly,
    and the group-less step through the graph, from the same distributed
    state. Every carried tensor, the metrics and the generator's state:
    graph = eager and dp = group-less at 0.0 (at world 1 the all-reduces
    and the ÷1 are exact). The advantage kernel's launches N in N
    iterations each run; the all-reduces: the first call's replicated-state
    check (2), one step's worth inside the capture, none from the replays.
    Returns the kernel's launches through the graph."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda
    from actor_critic_tpu_torch.parallel import dp, mesh

    preset = PRESETS[preset_name]
    mod, cfg = train.ALGOS[preset.algo], preset.config
    env = train.make_env(preset.env, preset.env_kwargs)
    kernel = vtrace_cuda if getattr(cfg, "correction", "") == "vtrace" else gae_cuda
    specs = dp.impala_state_specs() if preset.algo == "impala" else dp.train_state_specs()
    m = mesh.make_mesh()
    group = m.group(mesh.DP_AXIS)
    n = DP_ITERATIONS
    runs = {}
    for label, grouped, capturable in (("graph", True, True), ("eager", True, False),
                                       ("no group", False, True)):
        state = dp.distribute_state(mod.init_state(env, cfg, seed=2, device="cuda"), m, specs)
        step = mod.make_train_step(env, cfg, group=group if grouped else None)
        if grouped:
            step = dp.make_dp_train_step(step, m, specs)
        kernel.reset_launch_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with AllReduceCounter() as counter:
            state, metrics = loop.fused_train_loop(
                mod.make_train_step, mod.init_state, env, cfg, n, state=state,
                capturable=capturable, train_step=step)
            torch.cuda.synchronize()
        runs[label] = (run_record(state, metrics), kernel.launch_count(), counter,
                       time.perf_counter() - t0, state.update_step)
    graph, launches, counter, graph_s, steps = runs["graph"]
    eager_diff = record_diff(graph, runs["eager"][0])
    alone_diff = record_diff(graph, runs["no group"][0])
    per_step = counter.captured
    name = kernel.__name__.rsplit(".", 1)[-1].removesuffix("_cuda")
    print(f"dp {preset_name} (world 1, NCCL; E={cfg.num_envs}, T={cfg.rollout_steps}), {n} "
          f"iterations ({loop.WARMUP_ITERATIONS} eager, a capture, replays): graph vs eager max "
          f"abs difference {eager_diff[0]:.3e} ({eager_diff[2]} elements differ over "
          f"{eager_diff[3]} tensors), dp vs the group-less step {alone_diff[0]:.3e} "
          f"({alone_diff[2]} differ); {name} launches {launches} in {n} iterations (eager "
          f"{runs['eager'][1]}, group-less {runs['no group'][1]}); all-reduces {counter.calls}, "
          f"{per_step} of them inside the capture (one step's), eager run "
          f"{runs['eager'][2].calls}; {graph_s:.2f} s (eager {runs['eager'][3]:.2f} s, "
          f"group-less {runs['no group'][3]:.2f} s)", flush=True)
    assert eager_diff[0] == 0.0 and alone_diff[0] == 0.0, (eager_diff, alone_diff)
    assert steps == n and launches == runs["eager"][1] == runs["no group"][1] == n, runs
    assert per_step > 0 and counter.calls == 2 + (loop.WARMUP_ITERATIONS + 1) * per_step, \
        (counter.calls, per_step)
    assert runs["eager"][2].calls == 2 + n * per_step, (runs["eager"][2].calls, per_step)
    assert runs["no group"][2].calls == 0
    return launches


def run_dp_offpolicy() -> None:
    """The data-parallel off-policy learners at full width on Pendulum over
    a one-rank NCCL group: `td3_walker2d`'s with the int8 ring and
    `sac_humanoid`'s (float32 ring), distributed with their layouts,
    DP_OFFPOLICY_ITERATIONS iterations through the graph and eagerly
    from one seed (warm-up cut to OFFPOLICY_GRAPH_WARMUP: the gate opens
    on a replay). Graph = eager at 0.0 (every carried tensor: the 1M ring
    and its stats, nets, targets, Adam states, log α, counts; the metrics,
    the generator); the quantizer's pmean and pmax captured in the step's
    graph (one each per `i8` leaf: obs, reward, next_obs), none for the
    float32 ring; the gradient all-reduces inside the capture."""
    import torch

    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.parallel import dp, mesh

    m = mesh.make_mesh()
    group = m.group(mesh.DP_AXIS)
    n = DP_OFFPOLICY_ITERATIONS
    for preset_name, overrides, specs, i8_leaves in (
            ("td3_walker2d", {"replay_dtype": "int8"}, dp.offpolicy_state_specs(), 3),
            ("sac_humanoid", {}, dp.sac_state_specs(), 0)):
        mod, cfg, env = offpolicy_setup(preset_name, warmup_steps=OFFPOLICY_GRAPH_WARMUP,
                                        **overrides)
        runs = {}
        for capturable in (True, False):
            state = dp.distribute_state(mod.init_state(env, cfg, seed=5, device="cuda"), m, specs)
            step = dp.make_dp_train_step(mod.make_train_step(env, cfg, group=group), m, specs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with AllReduceCounter() as counter, QuantizerCollectives() as quant:
                state, metrics = loop.fused_train_loop(
                    mod.make_train_step, mod.init_state, env, cfg, n, state=state,
                    capturable=capturable, train_step=step)
                torch.cuda.synchronize()
            runs[capturable] = (run_record(state, metrics), counter, quant.counts,
                                time.perf_counter() - t0, state)
        graph, counter, quant, graph_s, state = runs[True]
        diff = record_diff(graph, runs[False][0])
        ring = state.learner.replay
        print(f"dp {preset_name} learner on {OFFPOLICY_ENV} (world 1, NCCL; ring "
              f"{cfg.replay_dtype}, {ring.storage.obs.shape[0]} rows, batch {cfg.batch_size}, "
              f"{cfg.updates_per_iter} updates an iteration), {n} iterations: graph vs eager "
              f"max abs difference {diff[0]:.3e} ({diff[2]} elements differ over {diff[3]} "
              f"tensors); update_count {int(state.learner.update_count)}; quantizer collectives "
              f"inside the capture: pmean {quant['pmean']}, pmax {quant['pmax']}; all-reduces "
              f"{counter.calls}, {counter.captured} inside the capture; {graph_s:.2f} s (eager "
              f"{runs[False][3]:.2f} s)", flush=True)
        assert diff[0] == 0.0, diff
        assert quant == {"pmean": i8_leaves, "pmax": i8_leaves}, quant
        assert counter.captured >= 2 * cfg.updates_per_iter, counter.captured
        assert int(state.learner.update_count) > 0


def graph_replay_ms(fn, iters: int = 50) -> float:
    """Device ms of one call of `fn` as a replay of a CUDA graph captured
    from it ("thread_local" mode, beside NCCL's watchdog): its kernels back
    to back with no host gap between them, CUDA events over `iters`
    replays, after three eager calls on a side stream."""
    import torch

    from actor_critic_tpu_torch.algos import loop

    side, current = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with loop.capture(graph, capture_error_mode="thread_local"):
        fn()
    return cuda_ms(graph.replay, iters)


def run_sp_impala() -> dict[str, int]:
    """The sequence-parallel IMPALA learner at `impala_pong`'s full width
    (E=64, T=20, the Nature CNN) over a one-rank NCCL sp group
    (`seqpar.make_sp_mesh`), and `seqpar_gae` / `seqpar_vtrace` at a long
    T:

    - `make_sp_update` (eager) on a rollout against the unsharded
      `impala_loss` + RMSProp step from the same parameters, within
      SP_PARAM_TOL (elements that differ counted); V-trace launched once;
    - `make_sp_update` SP_ITERATIONS calls through its graph against as
      many eager: 0.0; V-trace SP_ITERATIONS in SP_ITERATIONS;
    - `make_sp_train_step` SP_ITERATIONS iterations through its graph
      against its eager step (0.0) and against `make_train_step`
      (SP_TRAIN_TOL);
    - `seqpar_gae` / `seqpar_vtrace` at [SEQPAR_T, SEQPAR_E] against the
      kernels (SEQPAR_TOL, differing elements counted), one launch of each
      kernel a call, and each call's device time against the kernel's
      (`graph_replay_ms`; the suffix products along both axes too).
    Returns the kernels' launches on these paths."""
    import copy

    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import impala, loop
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda
    from actor_critic_tpu_torch.parallel import seqpar

    preset = PRESETS["impala_pong"]
    cfg = preset.config
    env = train.make_env(preset.env, preset.env_kwargs)
    m = seqpar.make_sp_mesh()
    group = m.group(seqpar.SP_AXIS)
    state = impala.init_state(env, cfg, seed=3, device="cuda")
    traj = impala.rollout(env, cfg, state)
    boot = state.rollout.obs.clone()
    opt = impala.make_optimizer(cfg)

    def learner():
        net = copy.deepcopy(state.net)
        return net, opt.init(dict(net.named_parameters()))

    def params(net):
        return {k: p.detach().clone() for k, p in net.named_parameters()}

    net_u, opt_u = learner()
    loss, metrics_u = impala.impala_loss(net_u, traj, boot, cfg, env.spec.can_truncate)
    pu = dict(net_u.named_parameters())
    opt.step(pu, dict(zip(pu, torch.autograd.grad(loss, list(pu.values())))), opt_u)
    update = impala.make_sp_update(env, cfg, m)
    net_s, opt_s = learner()
    vtrace_cuda.reset_launch_count()
    metrics_s = update.eager(net_s, opt_s, traj, boot)
    one_call = vtrace_cuda.launch_count()
    want, got = params(net_u), params(net_s)
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    differ = sum(int((got[k] != want[k]).sum()) for k in want)
    total = sum(v.numel() for v in want.values())
    for k in want:
        torch.testing.assert_close(got[k], want[k], **SP_PARAM_TOL, msg=k)
    for k in ("loss", "mean_rho"):
        torch.testing.assert_close(metrics_s[k], metrics_u[k], rtol=1e-5, atol=0.0, msg=k)

    records = {}
    for label in ("graph", "eager"):
        net, opt_state = learner()
        fn = update if label == "graph" else update.eager
        vtrace_cuda.reset_launch_count()
        for _ in range(SP_ITERATIONS):
            metrics = fn(net, opt_state, traj, boot)
        torch.cuda.synchronize()
        records[label] = (dict(params(net), **{f"metric {k}": v.clone() for k, v in
                                               metrics.items()}), vtrace_cuda.launch_count())
    update_diff = record_diff(records["graph"][0], records["eager"][0])

    train_runs = {}
    for label, make in (("graph", lambda: impala.make_sp_train_step(env, cfg, m)),
                        ("eager", lambda: impala.make_sp_train_step(env, cfg, m).eager),
                        ("unsharded", lambda: impala.make_train_step(env, cfg))):
        s = impala.init_state(env, cfg, seed=4, device="cuda")
        step = make()
        vtrace_cuda.reset_launch_count()
        for _ in range(SP_ITERATIONS):
            s, metrics = step(s)
        torch.cuda.synchronize()
        train_runs[label] = (run_record(s, metrics), vtrace_cuda.launch_count())
    train_diff = record_diff(train_runs["graph"][0], train_runs["eager"][0])
    sp_rec, ref_rec = train_runs["graph"][0], train_runs["unsharded"][0]
    train_worst = max(float((sp_rec[k] - ref_rec[k]).abs().max()) for k in sp_rec
                      if k.startswith(("param ", "actor_net ")))
    train_differ = sum(int((sp_rec[k] != ref_rec[k]).sum()) for k in sp_rec
                       if k.startswith(("param ", "actor_net ")))
    for k in sp_rec:
        if k.startswith(("param ", "actor_net ")):
            torch.testing.assert_close(sp_rec[k], ref_rec[k], **SP_TRAIN_TOL, msg=k)

    gen = torch.Generator(device="cuda").manual_seed(11)
    T, E = SEQPAR_T, SEQPAR_E
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    r, v, b = rand(T, E), rand(T, E), rand(E)
    d = (torch.rand((T, E), generator=gen, device="cuda") < 0.01).float()
    tlp, blp = 0.3 * rand(T, E), 0.3 * rand(T, E)
    gae_cuda.reset_launch_count()
    vtrace_cuda.reset_launch_count()
    sp_adv, sp_ret = seqpar.seqpar_gae(r, v, d, b, GAMMA, LAM, group=group)
    sp_vt = seqpar.seqpar_vtrace(tlp, blp, r, v, d, b, GAMMA, 1.0, 1.0, 0.9, group=group)
    torch.cuda.synchronize()
    seqpar_launches = (gae_cuda.launch_count(), vtrace_cuda.launch_count())
    k_adv, k_ret = gae_cuda.gae(r, v, d, b, GAMMA, LAM)
    k_vt = vtrace_cuda.vtrace(tlp, blp, r, v, d, b, GAMMA, 1.0, 1.0, 0.9)
    scan_pairs = {"gae advantages": (sp_adv, k_adv), "gae returns": (sp_ret, k_ret),
                  "vtrace vs": (sp_vt.vs, k_vt.vs), "vtrace pg": (sp_vt.pg_advantages,
                                                                  k_vt.pg_advantages),
                  "vtrace rho": (sp_vt.clipped_rhos, k_vt.clipped_rhos)}
    scan_report = []
    for label, (a, k) in scan_pairs.items():
        torch.testing.assert_close(a, k, **SEQPAR_TOL, msg=label)
        scan_report.append(f"{label} {float((a - k).abs().max()):.3e} "
                           f"({int((a != k).sum())} of {a.numel()} differ)")
    timed = {
        "seqpar_gae": lambda: seqpar.seqpar_gae(r, v, d, b, GAMMA, LAM, group=group),
        "gae": lambda: gae_cuda.gae(r, v, d, b, GAMMA, LAM),
        "seqpar_vtrace": lambda: seqpar.seqpar_vtrace(tlp, blp, r, v, d, b, GAMMA, 1.0, 1.0,
                                                      0.9, group=group),
        "vtrace": lambda: vtrace_cuda.vtrace(tlp, blp, r, v, d, b, GAMMA, 1.0, 1.0, 0.9),
    }
    # The suffix products along the leading axis, the layout seqpar does not use.
    a = GAMMA * LAM * (1.0 - d)
    timed["suffix products, leading axis"] = \
        lambda: torch.flip(torch.cumprod(torch.flip(a, [0]), 0), [0])
    timed["suffix products, seqpar's"] = lambda: seqpar._suffix_products(a)
    torch.testing.assert_close(timed["suffix products, seqpar's"](),
                               timed["suffix products, leading axis"](), rtol=1e-6, atol=1e-6)
    replay_ms = {label: graph_replay_ms(fn) for label, fn in timed.items()}
    sp_gae_ms, gae_ms, sp_vt_ms, vt_ms = (cuda_ms(timed[k], 20) for k in
                                          ("seqpar_gae", "gae", "seqpar_vtrace", "vtrace"))

    print(f"sp impala_pong (world 1, NCCL; E={cfg.num_envs}, T={cfg.rollout_steps}): "
          f"make_sp_update against the unsharded update, one call: params max abs difference "
          f"{worst:.3e} ({differ} of {total} elements differ; tolerance rtol "
          f"{SP_PARAM_TOL['rtol']}, atol {SP_PARAM_TOL['atol']}), loss {float(metrics_s['loss']):.6f} "
          f"against {float(metrics_u['loss']):.6f}, V-trace launches {one_call} in 1 call; "
          f"{SP_ITERATIONS} calls through its graph against eager: {update_diff[0]:.3e} "
          f"({update_diff[2]} differ), V-trace {records['graph'][1]} in {SP_ITERATIONS}; "
          f"make_sp_train_step {SP_ITERATIONS} iterations through its graph against eager "
          f"{train_diff[0]:.3e} ({train_diff[2]} differ over {train_diff[3]} tensors), against "
          f"make_train_step params {train_worst:.3e} ({train_differ} differ; rtol "
          f"{SP_TRAIN_TOL['rtol']}, atol {SP_TRAIN_TOL['atol']}), V-trace "
          f"{train_runs['graph'][1]} in {SP_ITERATIONS}", flush=True)
    print(f"seqpar at [{T}, {E}] (world 1, NCCL) against the kernels: {'; '.join(scan_report)} "
          f"(tolerance rtol {SEQPAR_TOL['rtol']}, atol {SEQPAR_TOL['atol']}); launches in one "
          f"call each: GAE {seqpar_launches[0]}, V-trace {seqpar_launches[1]}; a call as a "
          f"CUDA graph replay (device time, CUDA events, mean of 50 replays): "
          f"{'; '.join(f'{k} {ms * 1e3:.1f} us' for k, ms in replay_ms.items())}; back to "
          f"back eagerly (CUDA events, mean of 20, the host's launches included): seqpar_gae "
          f"{sp_gae_ms:.4f} ms, gae {gae_ms:.4f} ms, seqpar_vtrace {sp_vt_ms:.4f} ms, vtrace "
          f"{vt_ms:.4f} ms", flush=True)
    assert one_call == 1, one_call
    assert update_diff[0] == 0.0 and records["graph"][1] == records["eager"][1] == SP_ITERATIONS
    assert train_diff[0] == 0.0 and train_runs["graph"][1] == SP_ITERATIONS, train_runs["graph"][1]
    assert seqpar_launches == (1, 1), seqpar_launches
    return {"gae": seqpar_launches[0],
            "vtrace": one_call + records["graph"][1] + train_runs["graph"][1] + seqpar_launches[1]}


# -- the runtime sanitizers on the card -----------------------------------

SANITIZER_DEVICE = "cuda"
RACESAN_SCHEDULES = 16     # the quick profile: 4 seeds each of queue, publisher, mailbox, batcher
RACESAN_RING_SEEDS = 4     # the device ring's seeds, its storage on the card
NUMSAN_SCHEDULES = 20      # the quick profile: 4 seeds each of its five exercisers
PADSAN_SCHEDULES = 16      # the quick profile: 4 seeds each of its four seams
# The kernel seam one round a seed, so each launch count belongs to one E:
# seeds 0-20 draw both kernels at every ragged E (V-trace at E=200 first at 20).
PADSAN_KERNEL_SEEDS = 21


def expect_raise(label: str, fn, error, match: str) -> str:
    """`fn()` must raise `error` with `match` in its message (a reverted mode
    caught); returns the message's first line."""
    try:
        fn()
    except error as e:
        assert match in str(e), (label, str(e))
        return str(e).splitlines()[0][:100]
    raise AssertionError(f"{label}: the reverted mode was NOT caught")


def run_racesan_on_card() -> None:
    """racesan (`actor_critic_tpu_torch/analysis/racesan.py`): its quick
    profile over the port's queue, publisher, mailbox and batcher, and the
    device trajectory ring with its storage on the card; then each reverted
    mode, every one caught."""
    from actor_critic_tpu_torch.analysis import racesan

    dev = SANITIZER_DEVICE
    out = racesan.quick_profile(schedules=RACESAN_SCHEDULES)
    assert out["races"] == 0 and all(out[k]["schedules"] >= 4
                                     for k in ("queue", "publisher", "mailbox", "batcher")), out
    ring = racesan.exercise_sweep(range(RACESAN_RING_SEEDS),
                                  lambda s: racesan.exercise_device_ring(s, device=dev))
    assert ring["races"] == 0 and ring["consumed"] > 0, ring
    caught = {
        "queue consumer=alias": expect_raise(
            "alias", lambda: racesan.exercise_queue(0, consumer="alias"), racesan.RacesanError,
            "corrupted"),
        "publisher buggy_producer": expect_raise(
            "producer", lambda: racesan.exercise_publisher(0, buggy_producer=True), ValueError,
            "read-only"),
        "mailbox buggy_depositor": expect_raise(
            "depositor", lambda: racesan.exercise_mailbox(0, buggy_depositor=True), ValueError,
            "read-only"),
        "batcher alias_submit": expect_raise(
            "submit", lambda: racesan.exercise_batcher(0, alias_submit=True), ValueError,
            "read-only"),
        "batcher buggy_swapper": expect_raise(
            "swapper", lambda: racesan.exercise_batcher(0, buggy_swapper=True), ValueError,
            "read-only"),
        "device ring buggy_writer": expect_raise(
            "writer", lambda: racesan.exercise_device_ring(1, buggy_writer=True, device=dev),
            racesan.RacesanError, "LEASED slot"),
    }
    released = None
    for seed in range(16):
        try:
            racesan.exercise_device_ring(seed, consumer="released", blocks_per_producer=4,
                                         depth=1, device=dev)
        except racesan.RacesanError:
            released = seed
            break
    assert released is not None, "no schedule exposed the release-before-read consumer"
    caught["device ring consumer=released"] = f"first caught at seed {released}"
    print(f"racesan on the card: quick profile {out['schedules']} schedules clean (queue "
          f"consumed {out['queue']['consumed']}, publisher reads {out['publisher']['reads']}, "
          f"mailbox takes {out['mailbox']['takes']}, batcher responses "
          f"{out['batcher']['responses']} and scrapes {out['batcher']['scrapes']}); device ring "
          f"on {dev}: {ring['schedules']} schedules clean, {ring['consumed']} blocks read back "
          f"from the card; reverted modes caught: {json.dumps(caught, ensure_ascii=False)}", flush=True)


def run_numsan_on_card() -> int:
    """numsan (`analysis/numsan.py`): its quick profile with the host PPO
    update, the bf16 update, the checkpoint and the codecs on the card, the
    GAE kernel's launches counted (one an update: 2 rounds a schedule of the
    float32 update, one a schedule of the bf16 update); then each revert
    mode, every one caught. Returns the GAE launches."""
    from actor_critic_tpu_torch.analysis import numsan
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    dev = SANITIZER_DEVICE
    gae_cuda.reset_launch_count()
    vtrace_cuda.reset_launch_count()
    out = numsan.quick_profile(schedules=NUMSAN_SCHEDULES, device=dev)
    launches = {"gae": gae_cuda.launch_count(), "vtrace": vtrace_cuda.launch_count()}
    updates = 2 * out["update"]["schedules"] + out["bf16_update"]["schedules"]
    assert out["violations"] == 0, out
    assert all(out[k]["schedules"] >= 4 for k in
               ("update", "bf16_update", "publish", "checkpoint", "codec")), out
    assert out["update"]["divergence_events"] > 0 and out["codec"]["saturations"] > 0, out
    assert launches == {"gae": updates, "vtrace": 0}, (launches, updates)
    caught = {}
    for name, fn in (("publish", lambda: numsan.exercise_publish(0, revert=True)),
                     ("checkpoint", lambda: numsan.exercise_checkpoint(0, revert=True,
                                                                        device=dev)),
                     ("bf16-update", lambda: numsan.exercise_bf16_update(0, revert=True,
                                                                          device=dev)),
                     ("codec-wrap", lambda: numsan.exercise_codec(0, revert=True, device=dev))):
        caught[name] = expect_raise(name, fn, numsan.NumSanError, "REVERTED")
    print(f"numsan on the card: quick profile {out['schedules']} schedules clean (divergence "
          f"events {out['update']['divergence_events']}, rejections "
          f"{out['publish']['rejections'] + out['bf16_update']['rejections']}, refusals "
          f"{out['checkpoint']['refusals'] + out['bf16_update']['refusals']}, codec saturations "
          f"{out['codec']['saturations']}); the update's GAE kernel launched {launches['gae']} "
          f"times (= {updates} updates, counted on the card); reverted modes caught: "
          f"{json.dumps(caught, ensure_ascii=False)}", flush=True)
    return launches["gae"]


def run_padsan_on_card() -> dict[str, dict[int, int]]:
    """padsan (`analysis/padsan.py`): its quick profile with every seam on the
    card; the kernel seam at seeds 0..PADSAN_KERNEL_SEEDS-1 with the GAE and
    V-trace launches counted a schedule (each kernel launched at every E,
    launches = the calls made); the serving buckets captured and replayed;
    then each revert mode, every one caught, and `chunked` refused. Returns
    the kernels' launches by E."""
    from actor_critic_tpu_torch.analysis import padsan
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    dev = SANITIZER_DEVICE
    out = padsan.quick_profile(schedules=PADSAN_SCHEDULES, device=dev)
    assert out["violations"] == 0, out
    assert all(out[k]["schedules"] >= 4 for k in ("pallas", "mixture", "serving",
                                                  "device_plane")), out
    by_e = {kernel: {e: 0 for e in padsan.KERNEL_ES} for kernel in ("gae", "vtrace")}
    for seed in range(PADSAN_KERNEL_SEEDS):
        gae_cuda.reset_launch_count()
        vtrace_cuda.reset_launch_count()
        ((_, op, e, _, _),) = padsan.exercise_kernels(seed, rounds=1, device=dev)["trace"]
        got = {"gae": gae_cuda.launch_count(), "vtrace": vtrace_cuda.launch_count()}
        kernel = "vtrace" if op == "vtrace" else "gae"
        # Two calls a round (the zero-fill run and the poison-fill run), each
        # one launch; the λ-returns are the GAE kernel's second output.
        made = {"gae": 0, "vtrace": 0, kernel: 2}
        assert got == made, (seed, op, e, got)
        by_e[kernel][e] += got[kernel]
    assert all(n >= 2 for counts in by_e.values() for n in counts.values()), by_e
    eng, _ = padsan.serving_fixture(dev)
    replayed = sorted({next(b for b in eng.buckets if b >= t[1])
                       for s in range(PADSAN_SCHEDULES // 4)
                       for t in padsan.exercise_serving(s, device=dev)["trace"]})
    assert eng.graphs_captured == len(eng.buckets), eng.graphs_captured
    caught = {}
    for scenario, modes in padsan.SCENARIO_REVERTS.items():
        for mode in modes:
            caught[f"{scenario} {mode}"] = expect_raise(
                scenario, lambda: padsan.EXERCISERS[scenario](0, revert=mode, device=dev),
                padsan.PadSanError, "REVERTED GUARD")
    assert padsan.main(["--scenario", "chunked", "--device", dev]) == 2
    print(f"padsan on the card: quick profile {out['schedules']} schedules clean ({out['programs']} "
          f"programs); the kernel seam at T={padsan.KERNEL_T} over seeds 0-"
          f"{PADSAN_KERNEL_SEEDS - 1} (one round each): launches counted on the card by E, GAE "
          f"{by_e['gae']} and V-trace {by_e['vtrace']} (= the calls made, 2 a schedule); serving: "
          f"{eng.graphs_captured} bucket graphs {list(eng.buckets)} captured and replayed by the "
          f"warm-up, buckets {replayed} replayed by the ragged acts; reverted modes caught: "
          f"{json.dumps(caught, ensure_ascii=False)}; chunked refused (no counterpart seam)", flush=True)
    return by_e


FLEETSAN_SCHEDULES = 20     # the quick profile: 10 fleet, 10 gateway schedules
FLEETSAN_REPLICA_SEEDS = 4  # the replica-kill-mid-swap sweep
# The chaos workers' pool: the card's machine has no gymnasium for the
# sleep-padded CartPole, so the C++ engine's.
FLEETSAN_ENV = "native:CartPole-v1"


def run_fleetsan_on_card() -> dict[str, int]:
    """fleetsan (`analysis/fleetsan.py`): the quick profile and the replica
    sweep (files and the port's mailbox, store and syncer objects), each
    reverted mode caught (the shared-tmp collision replayed from its seed),
    then `run_process_chaos` at world 2 with both gossip workers on the card:
    rank 1 SIGKILLed and restarted, its time to recover, its flight ring
    harvested into a dump before the restart, the survivor's mixes, and in
    each worker's process V-trace launches = its consumed blocks. Returns
    V-trace's launches by worker."""
    import os
    import shutil

    from actor_critic_tpu_torch.analysis import fleetsan
    from actor_critic_tpu_torch.telemetry import flight

    out = fleetsan.quick_profile(schedules=FLEETSAN_SCHEDULES)
    assert out["violations"] == 0 and out["fleet"]["kills"] > 0, out
    replica = fleetsan.exercise_sweep(range(FLEETSAN_REPLICA_SEEDS),
                                      lambda s: fleetsan.exercise_replica_fleet(s))
    assert replica["violations"] == 0 and replica["kills"] == FLEETSAN_REPLICA_SEEDS, replica
    collision = None
    for seed in range(16):  # the shared tmp collides within JAX's 16 seeds
        try:
            fleetsan.exercise_fleet(seed, rounds=8, writer="shared_tmp", faults=False)
        except fleetsan.FleetSanError:
            collision = seed
            break
    assert collision is not None, "16 seeds never collided the shared tempfile"
    caught = {
        "writer direct": expect_raise(
            "direct", lambda: fleetsan.exercise_fleet(0, rounds=6, writer="direct",
                                                      faults=False),
            fleetsan.FleetSanError, "unreadable"),
        f"writer shared_tmp (seed {collision}, replayed)": expect_raise(
            "shared_tmp", lambda: fleetsan.exercise_fleet(collision, rounds=8,
                                                          writer="shared_tmp", faults=False),
            fleetsan.FleetSanError, "collision"),
        "poller naive": expect_raise(
            "naive", lambda: fleetsan.exercise_gateway(0, poller="naive"),
            fleetsan.FleetSanError, "swapped BACK"),
    }
    tel = os.path.abspath(f"{SCRATCH}/fleetsan")
    shutil.rmtree(tel, ignore_errors=True)
    os.makedirs(tel)
    rec = fleetsan.run_process_chaos(world=2, duration_s=6.0, kill_after_s=2.5, timeout_s=120.0,
                                     telemetry_dir=tel, device=SANITIZER_DEVICE,
                                     env=FLEETSAN_ENV)
    assert rec["ok"] and rec["flight_records"] > 0, rec
    assert flight.find_dumps(os.path.join(tel, "host1")) == [rec["flight_dump"]], rec
    for r, n in rec["launches"].items():
        assert n == {"gae": 0, "vtrace": rec["consumed_blocks"][r]}, rec
    print(f"fleetsan on the card: quick profile {out['schedules']} schedules clean "
          f"({out['fleet']['kills']} kills, recover rounds max {out['fleet']['recover_rounds_max']}, "
          f"{out['gateway']['swaps']} gateway swaps); replica sweep {replica['schedules']} clean "
          f"({replica['swaps']} swaps, {replica['kills']} kills); reverted modes caught: "
          f"{json.dumps(caught, ensure_ascii=False)}; process chaos at world 2 on the card "
          f"({FLEETSAN_ENV}): rank 1 SIGKILLed {rec['killed_at_s']} s in, time to recover "
          f"{rec['time_to_recover_s']} s, {rec['flight_records']} flight records harvested into "
          f"{os.path.relpath(rec['flight_dump'])}, survivor gossip mixes "
          f"{rec['survivor_gossip_mixes']}, consumed blocks {rec['consumed_blocks']} (the "
          f"restarted rank's), V-trace launches {rec['launches']} (= consumed blocks, counted "
          f"in each worker)", flush=True)
    return {f"fleetsan gossip worker {r} (world 2, after the chaos)": n["vtrace"]
            for r, n in rec["launches"].items()}


def run_perfsan_on_card() -> dict[str, dict[str, int]]:
    """perfsan (`analysis/perfsan.py`): the quick profile against the
    manifest's `cuda` values (its programs on the card: graph replays,
    pinned staging, the sync-debug guard), every program's actuals printed;
    GAE and V-trace launches inside the PPO and mixture programs' measured
    blocks, counted on the card, = the blocks (4 iterations a mixture call);
    then each reverted mode, caught on its budget key. Returns the kernels'
    launches by program."""
    from actor_critic_tpu_torch.analysis import perfsan

    out = perfsan.quick_profile(device=SANITIZER_DEVICE)
    assert out["platform"] == SANITIZER_DEVICE and out["violations"] == 0, out
    for name, entry in out["programs"].items():
        a = entry["actuals"]
        print(f"perfsan {name}: {a['dispatches']} dispatch(es) {a['dispatch_names']}, "
              f"{a['transfers']} transfer(s), {a['transferred_bytes']} B, {a['recompiles']} "
              f"recompile(s) a block" + (f"; enqueue {entry['enqueue_actuals']}"
                                         if "enqueue_actuals" in entry else "")
              + (f"; launches {entry['launches']}" if "launches" in entry else ""), flush=True)
    made = {"ppo_update_host": {"gae": 0, "vtrace": 3}, "ppo_update_device": {"gae": 0, "vtrace": 3},
            "ppo_update_fused": {"gae": 3, "vtrace": 0}, "mixture_fleet_step": {"gae": 12, "vtrace": 0}}
    for name, n in made.items():
        assert out["programs"][name]["launches"] == n, (name, out["programs"][name])
    keys = {"host-gather": "max_transfers_per_block", "unfused": "max_dispatches_per_block",
            "uncommit": "max_recompiles"}
    caught = {mode: expect_raise(mode, lambda: perfsan.run_reverted(mode, device=SANITIZER_DEVICE),
                                 perfsan.PerfSanError, key) for mode, key in keys.items()}
    print(f"perfsan on the card: {len(out['programs'])} programs green against the manifest's cuda "
          f"values; kernel launches inside the measured blocks {made} (= blocks, 4 iterations a "
          f"mixture call); reverted modes caught on their keys: "
          f"{json.dumps(caught, ensure_ascii=False)}", flush=True)
    by = {"gae": {}, "vtrace": {}}
    for name, n in made.items():
        what = "3 measured calls of 4 iterations" if name == "mixture_fleet_step" else \
            "3 measured blocks"
        for kernel, count in n.items():
            if count:
                by[kernel][f"perfsan {name} ({what})"] = count
    return by


LINT_FIXTURES = "tests/torch_lint_fixtures"
LINT_CHILD = ("import sys, time, json; t0 = time.perf_counter(); "
              "from actor_critic_tpu_torch.analysis import core, torchlint; "
              "rc = torchlint.main(['--json']); "
              "print(json.dumps({'rc': rc, 'seconds': time.perf_counter() - t0, "
              "'checks': [c.name for c in core.registered_checks()]})); sys.exit(rc)")


def start_static_analyzer() -> tuple[subprocess.Popen, str]:
    """The port's static analyzer over its own tree
    (`python -m actor_critic_tpu_torch.analysis.torchlint --json`, the
    default scan), started in the background at the script's start: it
    reads source only, on the host's cores, and `run_static_analyzer`
    collects it. Its output goes to a file under SCRATCH."""
    import os

    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "torchlint.json")
    with open(path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", LINT_CHILD], stdout=f,
                                stderr=subprocess.STDOUT, text=True)
    return proc, path


def _fixture(stem: str):
    """A twin of `tests/torch_lint_fixtures/`, imported from its file."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), LINT_FIXTURES, f"{stem}.py")
    spec = importlib.util.spec_from_file_location(f"torchlint_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lint_grounding_child(which: str) -> None:
    """The static analyzer's capture checks grounded on the card (run in a
    child process: a failed capture may leave its CUDA context unusable).
    `which` "main": each ok twin of tracer-leak, prng-reuse and
    donation-aliasing captured with `torch.cuda.graph` and held against its
    eager run (0.0 expected), then donation-aliasing's flag twin (the
    rebound restore: graph != eager) and tracer-leak's (the sync inside the
    capture raises, or the graph replays the branch read then); "prng":
    prng-reuse's flag twin (a draw from an unregistered generator inside
    the capture raises, or every replay repeats its draws). Prints one JSON
    line."""
    import types

    import torch

    dev = "cuda"
    out: dict = {}

    def diff(a, b) -> float:
        return float((a.double() - b.double()).abs().max())

    if which == "prng":
        flag = _fixture("prng_reuse_flag")
        gen = torch.Generator(device=dev).manual_seed(7)
        x = torch.zeros(4096, device=dev)
        try:
            graph, y = flag.noisy_capture(gen, x)
        except RuntimeError as e:
            out["prng_flag"] = {"raised": str(e).splitlines()[0][:160]}
        else:
            graph.replay()
            a = y.clone()
            graph.replay()
            torch.cuda.synchronize()
            out["prng_flag"] = {"repeats": bool(torch.equal(a, y))}
        print(json.dumps(out), flush=True)
        return

    # tracer-leak, ok twin: torch.where keeps the choice on the card.
    ok = _fixture("tracer_leak_ok")
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(256, generator=g, device=dev)
    graph, y = ok.captured_relu(x)
    worst = 0.0
    base = torch.rand(256, generator=g, device=dev) + 0.1
    for inp in (base, -base):  # both branches of the choice
        x.copy_(inp)
        graph.replay()
        worst = max(worst, diff(y, ok.relu_branch(inp)))
    out["tracer_ok"] = worst
    # prng-reuse, ok twin: the registered generator advances every replay.
    ok = _fixture("prng_reuse_ok")
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.zeros(4096, device=dev)
    graph, y = ok.noisy_capture(gen, x)
    state = gen.get_state()
    graph.replay()
    first = y.clone()
    gen.set_state(state)
    eager = x + torch.randn(x.shape, generator=gen, device=dev)
    graph.replay()
    out["prng_ok"] = diff(first, eager)
    out["prng_ok_advances"] = not bool(torch.equal(first, y))

    # donation-aliasing: a graph captured over state.params.
    def captured_state():
        s = types.SimpleNamespace(params=torch.randn(512, generator=g, device=dev),
                                  out=torch.zeros(512, device=dev))
        gr = torch.cuda.CUDAGraph()
        with torch.cuda.graph(gr):
            s.out.copy_(s.params * 2.0)
        return s, gr

    class Ckpt:
        def __init__(self):
            self.params = torch.randn(512, generator=g, device=dev)

        def restore(self, _state):
            return {"params": self.params.clone()}

    for twin in ("ok", "flag"):
        s, gr = captured_state()
        ckpt = Ckpt()
        _fixture(f"donation_aliasing_{twin}").resume_and_step(ckpt, gr, s)
        torch.cuda.synchronize()
        out[f"donation_{twin}"] = diff(s.out, ckpt.params * 2.0)
    # tracer-leak, flag twin, last: a sync inside the capture.
    flag = _fixture("tracer_leak_flag")
    x = torch.randn(256, generator=g, device=dev).abs()
    try:
        graph, y = flag.captured_relu(x)
    except RuntimeError as e:
        out["tracer_flag"] = {"raised": str(e).splitlines()[0][:160]}
    else:
        inp = -(torch.rand(256, generator=g, device=dev) + 0.1)
        x.copy_(inp)
        graph.replay()
        out["tracer_flag"] = {"baked": diff(y, flag.relu_branch(inp))}
    print(json.dumps(out), flush=True)


def run_static_analyzer(lint: tuple[subprocess.Popen, str]) -> None:
    """The port's static analyzer: its run over the port's tree (started at
    the script's start) exits 0 with no finding the baseline does not
    cover, its checks and seconds printed; then three capture checks
    grounded on the card, each twin captured with `torch.cuda.graph` in a
    child process (two children, at once): tracer-leak's and prng-reuse's
    flag twins raise (or bake a branch / repeat their draws), the rebound
    restore of donation-aliasing's flag twin makes graph != eager, and
    each ok twin gives graph = eager at 0.0. A failure of a child fails the
    phase."""
    import os

    proc, path = lint
    rc = proc.wait(timeout=600)
    text = open(path).read()
    lines = text.strip().splitlines()
    meta = json.loads(lines[-1])
    report = json.loads("\n".join(lines[:-1]))
    assert rc == 0 and meta["rc"] == 0 and report["counts"]["new"] == 0, text[-4000:]
    assert report["counts"]["stale"] == 0, report["stale_baseline_entries"]
    print(f"static analyzer: python -m actor_critic_tpu_torch.analysis.torchlint over "
          f"actor_critic_tpu_torch/ and chip_smoke.py, {len(meta['checks'])} checks "
          f"({', '.join(meta['checks'])}): exit 0, {report['counts']['new']} new, "
          f"{report['counts']['baselined']} baselined findings; {meta['seconds']:.2f} s of its "
          f"own (host clock, in the background beside the earlier phases)", flush=True)

    here = os.path.dirname(os.path.abspath(__file__))
    children = {w: subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.lint_grounding_child({w!r})"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for w in ("main", "prng")}
    got: dict = {}
    for w, child in children.items():
        o, e = child.communicate(timeout=300)
        assert child.returncode == 0, f"grounding child {w!r} failed (exit {child.returncode}):" \
                                      f"\n{o[-2000:]}\n{e[-4000:]}"
        got.update(json.loads(o.strip().splitlines()[-1]))
    assert got["tracer_ok"] == 0.0 and got["prng_ok"] == 0.0 and got["donation_ok"] == 0.0, got
    assert got["prng_ok_advances"], got
    assert got["donation_flag"] > 0.0, got
    tracer, prng = got["tracer_flag"], got["prng_flag"]
    assert "raised" in tracer or tracer["baked"] > 0.0, tracer
    assert "raised" in prng or prng["repeats"], prng
    print(f"static analyzer on the card: tracer-leak flag twin "
          f"{'raised: ' + tracer['raised'] if 'raised' in tracer else 'baked the branch read at the capture (max diff %.3g)' % tracer['baked']}; "
          f"prng-reuse flag twin "
          f"{'raised: ' + prng['raised'] if 'raised' in prng else 'repeated its draws on every replay'}; "
          f"donation-aliasing flag twin graph != eager (max diff {got['donation_flag']:.3g}); "
          f"the ok twins graph = eager at {got['tracer_ok']}, {got['prng_ok']}, "
          f"{got['donation_ok']} (the registered generator advancing between replays)",
          flush=True)


def adopt_orphans() -> None:
    """Make this process the reaper of its orphaned descendants
    (`PR_SET_CHILD_SUBREAPER`): a grandchild whose parent died first is
    re-parented here, not to init, so that `stop_descendants` finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:  # PR_SET_CHILD_SUBREAPER
        print(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed (errno {ctypes.get_errno()}): "
              "an orphaned grandchild escapes the final cleanup", file=sys.stderr, flush=True)


def descendants() -> dict[int, str]:
    """{pid: command line} of every live (not zombie) process below this
    one, read from /proc."""
    import os

    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # The command name may hold spaces and parentheses: the fields
        # after its last ")" are the state and the parent's pid.
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(entry))
    out, todo = {}, list(children.get(os.getpid(), ()))
    while todo:
        pid = todo.pop()
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out[pid] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        todo += children.get(pid, ())
    return out


def stop_descendants() -> dict[int, str]:
    """SIGKILL every process still running below this one; returns them."""
    import os
    import signal

    left = descendants()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return left


class FrozenHeap:
    """The collector's work inside `harness_heap_frozen`: the explicit
    collections' ms (`collect`) and, apart from them, every collection over
    1 ms (generation, ms)."""

    def __init__(self):
        self.collects: list[float] = []
        self.pauses: list[tuple[int, float]] = []
        self._t: Optional[float] = None
        self._explicit = False

    def watch(self, when: str, info: dict) -> None:
        if when == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            ms = (time.perf_counter() - self._t) * 1e3
            self._t = None
            if not self._explicit and ms > 1.0:
                self.pauses.append((info["generation"], round(ms, 3)))

    def collect(self) -> float:
        """A full collection now; its ms."""
        import gc

        self._explicit = True
        t0 = time.perf_counter()
        try:
            gc.collect()
        finally:
            self._explicit = False
        ms = (time.perf_counter() - t0) * 1e3
        self.collects.append(round(ms, 3))
        return ms


@contextlib.contextmanager
def harness_heap_frozen(label: str):
    """The harness's own heap, gathered over the phases before, out of the
    collector's reach for the block (`gc.freeze`, after a full collection):
    a collection over it, or one that destroys an earlier in-process run's
    graphs and rings, stalls whatever runs in this process, and a timed
    in-process run would read that stall as its own wall, where a trainer's
    own process has neither. Yields a `FrozenHeap`, whose `collect()` the
    block calls before each in-process run; objects made inside the block
    are collected as usual. Prints the collections, also when the block
    raises."""
    import gc

    heap = FrozenHeap()
    gc.callbacks.append(heap.watch)
    try:
        heap.collect()
        frozen = len(gc.get_objects())
        gc.freeze()
        try:
            yield heap
        finally:
            gc.unfreeze()
    finally:
        gc.callbacks.remove(heap.watch)
        print(f"{label}: the harness heap frozen, {frozen} objects after a full collection of "
              f"{heap.collects[0]:.3f} ms; a full collection before each in-process run: "
              f"{heap.collects[1:]} ms; other collections over 1 ms inside (generation, ms): "
              f"{heap.pauses or 'none'}", flush=True)


def phase(label: str, fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, its host seconds printed after it as `phase
    <label>: <s> s` (the script's time budget is read off these lines)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    adopt_orphans()
    import faulthandler

    faulthandler.dump_traceback_later(STACKS_AFTER_S)
    from actor_critic_tpu_torch import _build, resolve_device

    resolve_device("cuda")  # the port's entry point: pins the precision
    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)

    t0 = time.perf_counter()
    _build.build("gae", "vtrace")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, text) in _build.build_log.items():
        print(f"nvcc {name}.cu ({secs:.2f} s):\n{text.strip()}", flush=True)

    lint = start_static_analyzer()
    host_envs = probe_host_envs()
    cache_runs = start_build_cache()
    floor_ms = launch_floor_ms()
    print(f"launch floor: {floor_ms * 1e3:.3f} us on the device (torch.profiler, "
          f"a one-element zero_())", flush=True)
    entries = [check_gae(floor_ms), check_vtrace()]
    for e in entries:
        e["launch_floor_ms"] = floor_ms
        print(f"{e['name']}: kernel {e['ms'] / floor_ms:.2f}x the launch floor, "
              f"{e['ms'] / e['bound_ms']:.2f}x its bound", flush=True)
    phase("TF32", check_tf32)
    phase("update on the card", check_update_on_card)
    phase("IMPALA update on the card", check_impala_update_on_card)
    phase("bf16 update on the card", check_update_on_card, True)
    phase("bf16 IMPALA update on the card", check_impala_update_on_card, True)
    # a2c_cartpole's graph check runs with the telemetry sampler ticking
    # through its capture (graph = eager at 0.0 all the same).
    phase("graph vs eager a2c_cartpole", sampled, "graph_vs_eager_a2c_cartpole",
          check_graph_equals_eager, "a2c_cartpole")
    for preset_name in ("ppo_cartpole", "a2c_mixture", "impala_pong", "a3c_pong"):
        phase(f"graph vs eager {preset_name}", check_graph_equals_eager, preset_name)
    for preset_name in OFFPOLICY_PRESETS:
        phase(f"graph vs eager {preset_name}", check_offpolicy_graph_equals_eager, preset_name)
    phase("eval graphs", check_eval_graphs)
    for preset_name in BF16_GRAPH_PRESETS:
        phase(f"graph vs eager {preset_name} bf16", check_graph_equals_eager, preset_name, True)
    phase("graph vs eager sac_humanoid bf16", check_offpolicy_graph_equals_eager, "sac_humanoid",
          True)
    # Each kernel's launches on its own main path.
    launches = {"gae": phase("a2c_cartpole", run_a2c_cartpole)["gae"],
                "vtrace": phase("impala_pong", run_impala_pong)["vtrace"]}
    phase("ppo_cartpole", run_ppo_cartpole)
    phase("a3c_pong", run_a3c_pong)
    phase("a2c_mixture", run_a2c_mixture)
    phase("a2c_mixture curriculum", run_a2c_mixture_curriculum)
    phase("resume a2c_cartpole", sampled, "resume_a2c_cartpole", run_resume, "a2c_cartpole", [])
    phase("resume impala_pong", run_resume, "impala_pong", [])
    phase("resume a2c_mixture", run_resume, "a2c_mixture",
          ["--eval-every", str(RESUME_AT), "--curriculum=-1e9:0,0,0,1"])
    phase("chunk", run_chunk)
    phase("warm-up a2c_cartpole", run_warmup_a2c)
    for preset_name in OFFPOLICY_PRESETS:
        phase(preset_name, run_offpolicy_main, preset_name)
    phase("off-policy learning", run_offpolicy_learning)
    phase("off-policy resume and chunk", run_offpolicy_resume_and_chunk)
    phase("humanoid update loop", check_humanoid_update_loop)
    host_gae = phase("host ppo_halfcheetah", run_host_ppo, host_envs["ppo_halfcheetah"])
    for preset_name in OFFPOLICY_PRESETS:
        phase(f"host {preset_name}", run_host_offpolicy, preset_name, host_envs[preset_name])
    phase("host resume", run_host_resume, "td3_walker2d", host_envs["td3_walker2d"])
    phase("warm-up host ppo_halfcheetah", run_warmup_host_ppo, host_envs["ppo_halfcheetah"])
    phase("build cache", run_build_cache, cache_runs)
    print(f"host envs the presets ran on: {host_envs}; GAE launches on the host PPO path "
          f"{host_gae}", flush=True)
    phase("host ppo_halfcheetah bf16 contract", check_host_ppo_contract,
          host_envs["ppo_halfcheetah"], True)
    bf16_by_path = phase("bf16 main paths", run_bf16_main_paths, host_envs["ppo_halfcheetah"])
    phase("capture beside enqueues", check_capture_beside_enqueues)
    phase("async strict lockstep", check_async_strict_lockstep, host_envs["ppo_halfcheetah"])
    async_vtrace = phase("async ppo_halfcheetah", run_async_ppo, host_envs["ppo_halfcheetah"])
    phase("async flags", run_async_flags, host_envs["ppo_halfcheetah"])
    for preset_name in OFFPOLICY_PRESETS:
        phase(f"async {preset_name}", run_async_offpolicy, preset_name, host_envs[preset_name])
    phase("async resume", run_async_resume, host_envs["ppo_halfcheetah"])
    phase("serving graphs", check_serving_graphs)
    phase("serving graphs bf16", check_serving_graphs, BF16_SERVE_PRESETS, True)
    phase("serve CLI", run_serve_cli)
    phase("serve CLI warm-up", run_serve_warmup)
    serve_vtrace = phase("serve while training", run_serve_while_training,
                         host_envs["ppo_halfcheetah"], ASYNC_RATES[("device", "fp32")])
    sync_vtrace = phase("multihost sync world 1", run_multihost_sync,
                        host_envs["ppo_halfcheetah"])
    gossip_gae = phase("multihost gossip world 2", run_multihost_gossip,
                       host_envs["ppo_halfcheetah"])
    phase("multihost sync world 2", run_multihost_sync_world2, host_envs["ppo_halfcheetah"])
    phase("serving fleet", run_serving_fleet, host_envs["ppo_halfcheetah"])
    with nccl_world1():
        dp_gae = phase("dp a2c_cartpole", run_dp_fused, "a2c_cartpole")
        dp_vtrace = phase("dp impala_pong", run_dp_fused, "impala_pong")
        phase("dp off-policy", run_dp_offpolicy)
        sp_launches = phase("sp impala_pong", run_sp_impala)
    phase("racesan on the card", run_racesan_on_card)
    numsan_gae = phase("numsan on the card", run_numsan_on_card)
    padsan_by_e = phase("padsan on the card", run_padsan_on_card)
    fleetsan_vtrace = phase("fleetsan on the card", run_fleetsan_on_card)
    perfsan_by = phase("perfsan on the card", run_perfsan_on_card)
    phase("static analyzer", run_static_analyzer, lint)
    with harness_heap_frozen("telemetry a2c_cartpole") as heap:
        report = phase("telemetry a2c_cartpole", run_telemetry_a2c, heap)
    phase("telemetry host and async", run_telemetry_host_async, host_envs["ppo_halfcheetah"])
    phase("stall on the card, telemetry serve beside it", run_stall_on_card, run_telemetry_serve)
    phase("run report", wait_run_report, report)
    phase("IMPALA learns", check_impala_learns)
    # One step each way for the steps of ~21,000–24,000 launches
    # (PROFILE_PRESETS): the profiler's bookkeeping of them takes longer than
    # the steps. Each preset in float32, then in bf16.
    profiles, replays = {}, {}
    for preset_name, n, env_spec in PROFILE_PRESETS:
        graphs = {}
        for bf16 in (False, True):
            profiles[(preset_name, bf16)], graphs[bf16] = phase(
                f"profile {preset_name}{' bf16' if bf16 else ''}", profile_step, preset_name,
                n=n, env_spec=env_spec, bf16=bf16)
        replays[preset_name] = replays_in_turns(graphs)
    compare_profiles(profiles, replays)
    by_path = {"gae": {"a2c_cartpole": launches["gae"], "host ppo_halfcheetah": host_gae,
                       **{f"multihost gossip ppo_halfcheetah (world 2, rank {r}, correction "
                          f"none)": n for r, n in gossip_gae.items()},
                       **bf16_by_path["gae"],
                       "dp a2c_cartpole (world 1, NCCL)": dp_gae,
                       "sp seqpar_gae [4096, 64] (world 1, NCCL)": sp_launches["gae"],
                       "numsan host PPO update (float32 and bf16)": numsan_gae,
                       **{f"padsan kernel seam E={e}, T=100 (GAE and λ-returns)": n
                          for e, n in padsan_by_e["gae"].items() if n},
                       **perfsan_by["gae"]},
               "vtrace": {"impala_pong": launches["vtrace"],
                          "async ppo_halfcheetah (host plane)": async_vtrace,
                          "serve-while-training ppo_halfcheetah (device plane)": serve_vtrace,
                          "multihost sync ppo_halfcheetah (world 1, NCCL)": sync_vtrace,
                          **bf16_by_path["vtrace"],
                          "dp impala_pong (world 1, NCCL)": dp_vtrace,
                          "sp impala_pong update, train step and seqpar_vtrace (world 1, NCCL)":
                              sp_launches["vtrace"],
                          **{f"padsan kernel seam E={e}, T=100": n
                             for e, n in padsan_by_e["vtrace"].items() if n},
                          **fleetsan_vtrace, **perfsan_by["vtrace"]}}
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["launches_by_path"] = by_path[e["name"]]
        assert all(v > 0 for v in by_path[e["name"]].values()), \
            f"kernel {e['name']} was not launched on a main path: {by_path[e['name']]}"

    faulthandler.cancel_dump_traceback_later()
    left = stop_descendants()
    print(f"processes left running at the end, killed: {left or 'none'}", flush=True)
    print(f"script: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        left = stop_descendants()
        if left:
            print(f"chip_smoke: processes left running at the end, killed: {left}",
                  file=sys.stderr, flush=True)
    sys.exit(rc)
