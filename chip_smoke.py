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
   paths' shapes and at boundary shapes (ragged strips, chunk boundaries
   in T, bases off 16 bytes), with its tolerance, and its time beside the
   plain version's, the card's bound and the launch floor; then one A2C
   update and one IMPALA update on the card against the same update on
   the CPU;
4. graph equals eager: for `a2c_cartpole`, `ppo_cartpole`, `a2c_mixture`,
   `impala_pong` and `a3c_pong` at full width, a few iterations through
   the loop's CUDA-graph path against the same iterations run eagerly from
   the same seed, every carried tensor compared (for the mixture: every
   member slot, the types, the curriculum weights and stage; for IMPALA:
   the actors' copy and RMSProp's moments) and the generator's state; the
   same for the off-policy learners of `ddpg_walker2d`, `td3_walker2d` and
   `sac_humanoid` on `jax:pendulum` with the warm-up cut to 128 env steps
   (8 iterations: the 1M ring, its stats, targets, every Adam state, log α;
   the update gate must first open on a replayed iteration); then
   each eval as replays of captured blocks against the eager loop from one
   generator state (`a2c_cartpole`'s and `impala_pong`'s greedy evals,
   `a2c_mixture`'s greedy eval and its four typed evals through one set of
   graphs), returns and generator states equal, times printed;
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
     `jax:pendulum`, each for 200 iterations across its preset's
     10,000-step warm-up (the gate opens at iteration 157, inside the
     replays), update count read back from the final checkpoint; SAC
     learning Pendulum (best greedy eval >= -250 in 2,000 iterations) and
     TD3 the point mass (> -1.0) through the graph; `td3_walker2d` with
     `--replay-dtype mixed` 8 straight against 4 + `--resume` 4, and
     `sac_humanoid` `--chunk 4` against `--chunk 1`, at 0.0; and SAC's 64
     updates at Humanoid-v5's shapes (obs 348, action 17) over a full 1M
     ring in fp32 and mixed as one captured graph (ms an update, launches,
     peak memory);
   then IMPALA's learning check on the two-state MDP, and where a train
   step's time goes for `a2c_cartpole`, `ppo_cartpole`, `a2c_mixture`,
   `impala_pong` and `sac_humanoid` on `jax:pendulum` (eager and as graph
   replays, in the same call; host clock and torch.profiler, V-trace's own
   time inside the graph);
   - the host env path, on each preset's MuJoCo env or the engine's
     Pendulum (as the probe found): `ppo_halfcheetah` at full width (E=8,
     T=256, 10 × 32 minibatches) through `train.main`, the update one
     CUDA graph from iteration 3, GAE launched once an iteration and
     counted on the card, ms an iteration and the split into collect,
     wait, dispatch (host clock), upload and update (device); the
     off-policy presets at full width for 170 iterations past their
     10,000-step warm-up (the ingest and 64 updates one graph, the
     update count read back), ms an iteration and updates/s after the
     gate; for each of the four a second run under `HostContract`: the
     update's graph equal to its eager run on one block at 0.0, every
     uploaded block equal to its host block and every mirror snapshot
     equal to the parameters the update read, bitwise, with overlap on;
     and `td3_walker2d`'s host checkpoint round trip at 0.0 (learner,
     pool stats, generator, env steps) with the ring and without;
6. a `{"kernels": [...]}` line, then the card's name and power limit;
7. last line: `{"ok": true, "device": {"platform": "gpu", ...}}`.

Exits non-zero, printing no result, where no CUDA device is present.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import time

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
# Checkpoints and metrics of the drives, inside the checkout (gitignored).
SCRATCH = "build/chip_smoke"
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
    for T, E in ((64, 4096), (128, 256), (32, 1024), (20, 64), (256, 8)):
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

    T, E = 20, 64  # the preset's shape
    args = vtrace_inputs(T, E, seed=100)
    timing = time_against_bound(
        f"vtrace [{T},{E}]", "vtrace_kernel", lambda: vtrace_cuda.vtrace(*args, GAMMA),
        lambda: returns.vtrace(*args, GAMMA),
        bytes_moved=(8 * T * E + E) * 4,  # 5 inputs + 3 outputs [T,E], bootstrap [E]
        flops=21 * T * E)  # 20 float operations and one exp per element
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
def full_float32():
    """Float32 matrix products and cuDNN convolutions in full float32 (no
    TF32) inside the block; the flags as they were afterwards."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def update_on_card_vs_cpu(mod, env, cfg, cpu, traj, param_atol: float, metric_keys,
                          metric_atol: float, metric_rtol: float) -> tuple[float, dict, dict]:
    """One `mod.update` on the card against the same update on the CPU
    (the kernels' plain versions there), from a copy of the CPU train state
    `cpu` and the rollout `traj`, with float32 products and convolutions in
    full float32. Holds the parameters at `param_atol` + rtol 1e-6 and the
    metrics `metric_keys` at their tolerances; returns (largest parameter
    difference, CPU metrics, card metrics)."""
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
    with full_float32():
        m_cpu = mod.update(env, cfg, mod.make_optimizer(cfg), cpu, traj)
        m_gpu = mod.update(env, cfg, mod.make_optimizer(cfg), gpu,
                           Transition(*(x.cuda() for x in traj)))
        torch.cuda.synchronize()
    worst = 0.0
    for (k, pc), (_, pg) in zip(cpu.net.named_parameters(), gpu.net.named_parameters()):
        torch.testing.assert_close(pg.detach().cpu(), pc.detach(), atol=param_atol, rtol=1e-6,
                                   msg=lambda m, k=k: f"update on card, {k}: {m}")
        worst = max(worst, float((pg.detach().cpu() - pc.detach()).abs().max()))
    for k in metric_keys:
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], atol=metric_atol, rtol=metric_rtol,
                                   msg=lambda m, k=k: f"update on card, metric {k}: {m}")
    return worst, m_cpu, m_gpu


def check_update_on_card() -> None:
    """One A2C update on the card against the same update on the CPU (plain
    GAE there), from the same state and rollout at a small size: the slice
    as a whole, kernel included, gives the CPU's answer. Tolerance on the
    parameters atol 1e-5·lr + rtol 1e-6 (see tests/test_torch_a2c.py), on
    the loss metrics rtol 1e-5 (sums taken in another order)."""
    from actor_critic_tpu_torch.algos import a2c
    from actor_critic_tpu_torch.envs import make_cartpole

    cfg = a2c.A2CConfig(num_envs=64, rollout_steps=16, lr=1e-3, anneal_iters=10,
                        lr_final=0.0, entropy_coef_final=0.0)
    env = make_cartpole()
    cpu = a2c.init_state(env, cfg, seed=3, device="cpu")
    traj = a2c.rollout(env, cfg, cpu)
    worst, _, _ = update_on_card_vs_cpu(
        a2c, env, cfg, cpu, traj, param_atol=1e-5 * cfg.lr,
        metric_keys=("loss", "pg_loss", "v_loss", "entropy", "mean_finished_return"),
        metric_atol=0.0, metric_rtol=1e-5)
    print(f"update on card vs CPU (E=64, T=16): max abs parameter difference {worst:.3e}",
          flush=True)


def check_impala_update_on_card() -> None:
    """One IMPALA update on the card against the same update on the CPU
    (plain V-trace there), from the same state and a stale-actor rollout at
    a small pixel size (42 px, E=8, T=4), TF32 off. Tolerances: loss
    metrics rtol 1e-4, parameters atol 1e-4·lr + rtol 1e-6. cuDNN sums
    the convolutions in another order than the CPU (and may transform
    them, Winograd or FFT), so grads agree to ~1e-5 relative, not to the
    bit; RMSProp moves a parameter by at most ~3.2·lr·|g|, which bounds
    the parameter difference by ~3.2·lr·|Δg|."""
    import torch

    from actor_critic_tpu_torch.algos import impala
    from actor_critic_tpu_torch.envs import make_pong

    cfg = impala.ImpalaConfig(num_envs=8, rollout_steps=4, lr=1e-3, actor_refresh_every=2)
    env = make_pong(size=42)
    cpu = impala.init_state(env, cfg, seed=3, device="cpu")
    # The learner's policy head sharpened after the actors' copy was taken,
    # so that the compared update's ratios are well away from 1.
    with torch.no_grad():
        cpu.net.policy.weight.mul_(1000.0)
    traj = impala.rollout(env, cfg, cpu)
    worst, m_cpu, m_gpu = update_on_card_vs_cpu(
        impala, env, cfg, cpu, traj, param_atol=1e-4 * cfg.lr,
        metric_keys=("loss", "pg_loss", "v_loss", "entropy", "mean_rho"),
        metric_atol=1e-6, metric_rtol=1e-4)
    assert 0.0 < float(m_cpu["mean_rho"]) < 0.99, m_cpu["mean_rho"]
    print(f"impala update on card vs CPU (42 px, E=8, T=4, TF32 off): max abs parameter "
          f"difference {worst:.3e}, mean_rho {float(m_gpu['mean_rho']):.6f} "
          f"(CPU {float(m_cpu['mean_rho']):.6f})", flush=True)


def check_graph_equals_eager(preset_name: str) -> None:
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
    different. Both sides run with the same TF32 flags (the defaults)."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.algos.common import carried_tensors
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    preset = PRESETS[preset_name]
    mod, cfg = train.ALGOS[preset.algo], preset.config
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
        f"graph vs eager, {preset_name} (E={cfg.num_envs}, T={cfg.rollout_steps}), {n} iterations "
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
    launches). Prints the first and last rows, every `show_every`-th, the
    summary, and the lines that are not JSON (the curriculum's, the
    resume's), but not the run's config line."""
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    buf = io.StringIO()
    if "--metrics" not in argv:
        argv = argv + ["--metrics", f"{SCRATCH}/metrics.jsonl"]
    gae_cuda.reset_launch_count()
    vtrace_cuda.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    launches = {"gae": gae_cuda.launch_count(), "vtrace": vtrace_cuda.launch_count()}
    assert rc == 0, f"train.main returned {rc}"
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
    print(f"main path a3c_pong (CUDA graph from iteration 3): {n} iterations, "
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
    `train.main`, CHUNK_ITERATIONS iterations: two eager, two replays of the
    one-step graph (the short chunk that realigns), then two replays of the
    4-step graph. The final checkpoints agree at 0.0 and GAE runs once an
    iteration in both."""
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
OFFPOLICY_GRAPH_ITERATIONS = 8   # 2 eager, a capture, replays; the gate opens at 4
OFFPOLICY_GRAPH_WARMUP = 128     # env steps: iterations 1-2; the 256-row batch is in at 4
OFFPOLICY_MAIN_ITERATIONS = 200  # the presets' own 10,000-step warm-up ends at 157
SAC_LEARN_ITERATIONS, SAC_LEARN_EVAL_EVERY = 2000, 500
HUMANOID_OBS, HUMANOID_ACT = 348, 17  # Humanoid-v5 (gymnasium 1.2.2)


def offpolicy_setup(preset_name: str, **overrides):
    """(module, config, env) of an off-policy preset's learner on
    `jax:pendulum`, `overrides` applied to its config."""
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS[preset_name]
    cfg = dataclasses.replace(preset.config, **overrides)
    return train.ALGOS[preset.algo], cfg, train.make_env(OFFPOLICY_ENV, {})


def check_offpolicy_graph_equals_eager(preset_name: str) -> None:
    """The loop's CUDA-graph path against eager execution for an off-policy
    preset's learner on Pendulum at full width, with the warm-up cut to 128
    env steps: OFFPOLICY_GRAPH_ITERATIONS iterations each way from one seed.
    Every carried tensor (the 1M-slot ring, its cursor, count and stats,
    both nets, the targets, every Adam state, log α, the counts), the last
    metrics and the generator's state agree at 1e-6 (expected 0.0). The
    update count is read after every iteration: its first rise must fall on
    a replayed iteration (the gate opens on the device, not at capture);
    for TD3 the actor's Adam count is half the critic's."""
    import torch

    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.algos.common import carried_tensors

    mod, cfg, env = offpolicy_setup(preset_name, warmup_steps=OFFPOLICY_GRAPH_WARMUP)
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
        f"graph vs eager, {preset_name} on {OFFPOLICY_ENV} (E={cfg.num_envs}, K=J="
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


def run_offpolicy_main(preset_name: str) -> None:
    """An off-policy preset's learner at full width through `train.main`
    (`--preset <name> --env jax:pendulum`) for OFFPOLICY_MAIN_ITERATIONS
    iterations, across the preset's own 10,000-step warm-up, the step
    replayed as a CUDA graph from iteration 3; the final checkpoint gives
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
         "--save-every", "0"], show_every=50)
    check_rows(logged, n, keys=("critic_loss", "actor_loss", "q_mean"))
    assert launches == {"gae": 0, "vtrace": 0}, launches
    saved = final_checkpoint(d, n)["tensors"]
    updates, size = int(saved["learner.update_count"]), int(saved["learner.replay size"])
    env_steps = int(saved["env_steps"])
    _, cfg, _ = offpolicy_setup(preset_name)
    opened = -(-cfg.warmup_steps // (cfg.steps_per_iter * cfg.num_envs))  # iteration 157
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
        f"main path {preset_name} on {OFFPOLICY_ENV} (CUDA graph from iteration 3): {n} "
        f"iterations of {spi} env steps and {cfg.updates_per_iter} updates; eager iteration 1 "
        f"{rows[1]['wall_s'] * 1e3:.1f} ms, iteration 2 {per(1, 2) * 1e3:.1f} ms; "
        f"{before * 1e3:.3f} ms/iteration over the replays before the gate opens (3-{opened - 1}),"
        f" {after * 1e3:.3f} after it ({opened + 1}-{n}): {spi / after:.0f} env-steps/s, "
        f"{cfg.updates_per_iter / after:.0f} updates/s; update_count {updates} (the gate opened "
        f"at iteration {opened}), ring size {size}; critic_loss {rows[n]['critic_loss']:.4f}, "
        f"greedy eval {ev:.3f}", flush=True)


def run_offpolicy_learning() -> None:
    """Learning on the card through the CUDA graph: SAC on Pendulum at
    tests/test_sac.py::test_sac_learns_jax_pendulum_fused's config (E=8,
    K=J=8, hidden (128, 128), batch 128, warm-up 1,000; 2,000 iterations, a
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
    from actor_critic_tpu_torch.algos import sac
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
        with torch.cuda.graph(graph):
            metrics = update_loop(learner, do_update, g)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        count0 = int(learner.update_count)
        ms = cuda_ms(graph.replay, iters=10, warmup=2)
        kernels, wall = profile_kernels(graph.replay, iters=3)
        busy_us = sum(us for _, us in kernels.values()) / 3
        launches = sum(c for c, _ in kernels.values()) / 3
        assert int(learner.update_count) == count0 + 15 * cfg.updates_per_iter
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


def profile_step(preset_name: str, n: int = 3, env_spec: str = "") -> None:
    """Where a full-width train step of a preset goes, in one call (on
    `env_spec` instead of the preset's env where one is given): for an
    on-policy trainer, host-clock rollout and update times of `n` eager
    steps; then the step run eagerly and, for a capturable trainer, as
    replays of the loop's CUDA graph, each with its host-clock time per
    step over `n` steps (synchronised) and its device busy time, busy share
    and kernel launches per step from torch.profiler over `n` more (top
    kernels for the eager step). The busy share is the busy time over the
    unprofiled host-clock time."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS[preset_name]
    mod, cfg = train.ALGOS[preset.algo], preset.config
    env = train.make_env(env_spec or preset.env, {} if env_spec else preset.env_kwargs)
    state = mod.init_state(env, cfg, seed=1, device="cuda")
    step = mod.make_train_step(env, cfg)
    side = torch.cuda.Stream()
    for _ in range(loop.WARMUP_ITERATIONS):
        loop.eager_step(step, state, side)
    torch.cuda.synchronize()
    if hasattr(mod, "rollout"):
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
            f"{preset_name} train step at E={cfg.num_envs}, T={cfg.rollout_steps} "
            f"(host clock, synchronised, eager): rollout {t_roll / n * 1e3:.3f} ms, "
            f"update {t_upd / n * 1e3:.3f} ms",
            flush=True,
        )
    modes = [("eager", lambda: step(state))]
    if mod.CAPTURABLE:
        captured = loop.CapturedStep(step, state)
        modes.append(("graph", captured.replay))
    for label, fn in modes:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        kernels, wall = profile_kernels(fn, iters=n)
        busy_us = sum(us for _, us in kernels.values())
        launches = sum(c for c, _ in kernels.values())
        if busy_us > 0:
            print(
                f"{preset_name} {label}: {host_ms:.3f} ms/step (host clock, synchronised); "
                f"profiled {n} steps: wall {wall / n * 1e3:.3f} ms/step under the profiler, "
                f"device busy {busy_us / n / 1e3:.3f} ms/step "
                f"({busy_us / n / 1e3 / host_ms:.1%} of the unprofiled step), "
                f"{launches / n:.0f} kernel launches/step",
                flush=True,
            )
        else:
            print(f"{preset_name} {label}: {host_ms:.3f} ms/step (host clock, synchronised); "
                  f"device time not measured (the profiler recorded none)", flush=True)
        for name, (count, us) in kernels.items():
            for kernel in ("gae_kernel", "vtrace_kernel"):
                if kernel in name:
                    print(f"{preset_name} {label}: {kernel} {us / count:.3f} us a launch on the "
                          f"device (torch.profiler, {count} launches)", flush=True)
        if label == "eager":
            for name, (count, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
                print(f"  {us / n:10.1f} us/step {count // n:6d} launches/step  {name[:100]}",
                      flush=True)


# -- the host env path ----------------------------------------------------

HOST_MUJOCO_ENVS = {"ppo_halfcheetah": "HalfCheetah-v5", "ddpg_walker2d": "Walker2d-v5",
                    "td3_walker2d": "Walker2d-v5", "sac_humanoid": "Humanoid-v5"}
HOST_FALLBACK_ENV = "native:Pendulum-v1"  # the C++ engine, where MuJoCo is missing
HOST_PPO_ITERATIONS = 12     # two eager, a capture, then replays
HOST_LOG_EVERY = 4           # the main paths log (and so wait for the card) every 4th / 10th
HOST_OFFPOLICY_LOG_EVERY = 10  # iteration, so the iterations between overlap host and card
HOST_CHECK_ITERATIONS = 6    # the graph-vs-eager and upload checks: iterations 1-6
HOST_CHECK_AT = 4            # a replayed iteration
HOST_OFFPOLICY_ITERATIONS = 170  # the presets' 10,000-step warm-up ends at iteration 157
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
    native.build()
    native.load()
    print(f"probe: native env engine built in {time.perf_counter() - t0:.2f} s (g++ "
          f"{' '.join(native.CXX_FLAGS)}) into {native.LIB.relative_to(native.BUILD_DIR.parent.parent)}",
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
        import torch

        from actor_critic_tpu_torch.algos import loop

        self.blocks.append(({k: v.copy() for k, v in run.buffers.block().items()},
                            {k: v.clone() for k, v in run.buffers.static.items()}))
        module = self.module_of(run)
        self.params_after[it] = {k: p.detach().clone() for k, p in module.named_parameters()}
        if it > 1:
            tree = run.snapshot.params()
            self.snapshots[it] = {k: v.copy() for k, v in flat_tree(tree).items()}
        if it == self.check_at:
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
            self.graph_vs_eager = dict(worst=max(diffs.values()), tensors=len(diffs),
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
                    self.graph_vs_eager.update(launch_ms=(t1 - t0) * 1e3,
                                               replay_ms=(time.perf_counter() - t0) * 1e3)
                else:
                    kernels, _ = profile_kernels(run.update.captured.replay, iters=1)
                    self.graph_vs_eager.update(
                        busy_ms=sum(us for _, us in kernels.values()) / 1e3,
                        launches=sum(c for c, _ in kernels.values()))
            with torch.no_grad():
                for k, t in carried.items():
                    t.copy_(start[k])
            gen.set_state(gen_start)

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
    replayed as one CUDA graph from iteration 3; then the same trainer under
    a `HostContract` (graph vs eager, the upload and the snapshot). Returns
    GAE's launches on the main path (one an iteration)."""
    import math

    import torch

    from actor_critic_tpu_torch.algos import ppo

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
          f"graph from iteration 3, logged every {HOST_LOG_EVERY}): {n} iterations, GAE launches "
          f"{launches['gae']}; eager iteration 1 {logged[0]['wall_s'] * 1e3:.1f} ms; "
          f"{per_iter_s * 1e3:.3f} ms/iteration over the replays {HOST_LOG_EVERY + 1}-{n} "
          f"({steps / per_iter_s:.0f} env-steps/s); split of iterations {after}, ..., {n} "
          f"{host_split(logged, after)}; greedy eval {logged[-1]['eval_return']:.2f}", flush=True)

    pool, cfg = host_pool("ppo_halfcheetah", env)
    contract = HostContract(lambda run: run.device_state["params"], HOST_CHECK_AT)
    try:
        ppo.train_host(pool, cfg, HOST_CHECK_ITERATIONS, seed=1, log_every=0, device="cuda",
                       iteration_hook=contract)
    finally:
        pool.close()
    torch.cuda.synchronize()
    contract.check(f"ppo_halfcheetah on {env}")
    return launches["gae"]


def run_host_offpolicy(preset_name: str, env: str) -> None:
    """An off-policy preset at its full width (E=1, K=J=64, batch 256,
    hidden (256, 256), a 1M ring) on `env` through `train.main` for
    HOST_OFFPOLICY_ITERATIONS iterations, past the 10,000-step warm-up (the
    gate opens at iteration 157, inside the replays), losses finite, the
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
         "--no-save-replay"], show_every=50)
    check_rows(logged, n, keys=("critic_loss", "actor_loss", "q_mean"))
    assert launches == {"gae": 0, "vtrace": 0}, launches
    saved = final_checkpoint(d, n)["tensors"]
    updates = int(saved["device_state.learner.update_count"])
    pool, cfg = host_pool(preset_name, env)
    pool.close()
    opened = -(-cfg.warmup_steps // (cfg.steps_per_iter * cfg.num_envs))  # iteration 157
    assert updates == (n - opened + 1) * cfg.updates_per_iter, (updates, opened)
    assert int(saved["device_state.env_steps"]) == n * cfg.steps_per_iter * cfg.num_envs
    ev = logged[-1]["eval_return"]
    assert math.isfinite(ev), logged[-1]
    rows = {r["iter"]: r for r in logged}
    per = lambda a, b: (rows[b]["wall_s"] - rows[a]["wall_s"]) / (b - a)
    every = HOST_OFFPOLICY_LOG_EVERY
    shut = (every, opened // every * every)       # logged replays with the gate shut: 10-150
    open_ = (-(-opened // every) * every, n)      # and open: 160-170
    before, after = per(*shut), per(*open_)
    spi = cfg.steps_per_iter * cfg.num_envs
    print(f"main path {preset_name} on {env} (E={cfg.num_envs}, K=J={cfg.steps_per_iter}, "
          f"ingest and updates a CUDA graph from iteration 3, logged every {every}): {n} "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from actor_critic_tpu_torch import _build

    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)

    t0 = time.perf_counter()
    _build.build("gae", "vtrace")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, text) in _build.build_log.items():
        print(f"nvcc {name}.cu ({secs:.2f} s):\n{text.strip()}", flush=True)

    host_envs = probe_host_envs()
    floor_ms = launch_floor_ms()
    print(f"launch floor: {floor_ms * 1e3:.3f} us on the device (torch.profiler, "
          f"a one-element zero_())", flush=True)
    entries = [check_gae(floor_ms), check_vtrace()]
    for e in entries:
        e["launch_floor_ms"] = floor_ms
        print(f"{e['name']}: kernel {e['ms'] / floor_ms:.2f}x the launch floor, "
              f"{e['ms'] / e['bound_ms']:.2f}x its bound", flush=True)
    check_update_on_card()
    check_impala_update_on_card()
    for preset_name in ("a2c_cartpole", "ppo_cartpole", "a2c_mixture", "impala_pong", "a3c_pong"):
        check_graph_equals_eager(preset_name)
    for preset_name in OFFPOLICY_PRESETS:
        check_offpolicy_graph_equals_eager(preset_name)
    check_eval_graphs()
    # Each kernel's launches on its own main path.
    launches = {"gae": run_a2c_cartpole()["gae"], "vtrace": run_impala_pong()["vtrace"]}
    run_ppo_cartpole()
    run_a3c_pong()
    run_a2c_mixture()
    run_a2c_mixture_curriculum()
    run_resume("a2c_cartpole", [])
    run_resume("impala_pong", [])
    run_resume("a2c_mixture", ["--eval-every", str(RESUME_AT), "--curriculum=-1e9:0,0,0,1"])
    run_chunk()
    for preset_name in OFFPOLICY_PRESETS:
        run_offpolicy_main(preset_name)
    run_offpolicy_learning()
    run_offpolicy_resume_and_chunk()
    check_humanoid_update_loop()
    host_gae = run_host_ppo(host_envs["ppo_halfcheetah"])
    for preset_name in OFFPOLICY_PRESETS:
        run_host_offpolicy(preset_name, host_envs[preset_name])
    run_host_resume("td3_walker2d", host_envs["td3_walker2d"])
    print(f"host envs the presets ran on: {host_envs}; GAE launches on the host PPO path "
          f"{host_gae}", flush=True)
    check_impala_learns()
    profile_step("a2c_cartpole")
    # One step each way for the steps of ~21,000–24,000 launches: the
    # profiler's bookkeeping of them takes longer than the steps.
    profile_step("ppo_cartpole", n=1)
    profile_step("a2c_mixture", n=1)
    profile_step("impala_pong")
    profile_step("sac_humanoid", n=1, env_spec=OFFPOLICY_ENV)
    for e in entries:
        e["launches"] = launches[e["name"]]
        assert e["launches"] > 0, f"kernel {e['name']} was not launched on the main path"

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
    sys.exit(main())
