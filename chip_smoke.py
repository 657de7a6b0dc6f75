#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (from nvidia-smi);
2. build: every CUDA kernel of the main paths (GAE and V-trace), from
   `actor_critic_tpu_torch/csrc`, one nvcc each, all started together;
3. kernels: the launch floor (the device time of a one-element zero_());
   each kernel against its plain PyTorch version on the card, at its main
   paths' shapes and at boundary shapes (ragged strips, chunk boundaries
   in T, bases off 16 bytes), with its tolerance, and its time beside the
   plain version's, the card's bound and the launch floor; then one A2C
   update and one IMPALA update on the card against the same update on
   the CPU;
4. graph equals eager: for `a2c_cartpole` and `ppo_cartpole` at full
   width, a few iterations through the loop's CUDA-graph path against the
   same iterations run eagerly from the same seed;
5. main paths, each through `actor_critic_tpu_torch.train.main` with every
   launch count reset just before and read just after:
   - `a2c_cartpole` at full width (E=4096, T=64), GAE on its path, the
     step replayed as a CUDA graph;
   - `ppo_cartpole` at full width (E=256, T=128, 4 epochs × 8
     minibatches), GAE on its path, the step replayed as a CUDA graph;
     it must solve CartPole (best greedy eval >= 400) in 30 iterations;
   - `impala_pong` at full width (E=64, T=20, 84×84×2 frames, Nature
     CNN), V-trace on its path, eager;
   - `a3c_pong`, the same trainer through GAE, for a few iterations;
   then IMPALA's learning check on the two-state MDP, and where a train
   step's time goes for `a2c_cartpole` and `ppo_cartpole` (eager and as
   graph replays, in the same call) and `impala_pong` (host clock and
   torch.profiler);
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
GRAPH_CHECK_ITERATIONS = 5  # the loop's eager warm-up, a capture, then replays
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


def check_gae() -> dict:
    """GAE kernel vs `ops.returns.gae` on the card; returns its kernels-line entry."""
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
    # (two chunks of 64 rows, double-buffered) and a3c_pong's.
    timings = []
    for T, E in ((64, 4096), (128, 256), (20, 64)):
        args = gae_inputs(T, E, seed=100)
        timings.append(time_against_bound(
            f"gae [{T},{E}]", "gae_kernel", lambda: gae_cuda.gae(*args, GAMMA, LAM),
            lambda: returns.gae(*args, GAMMA, LAM),
            bytes_moved=(5 * T * E + E) * 4,  # 3 inputs + 2 outputs [T,E], bootstrap [E]
            flops=8 * T * E))  # sub, 2 mul, add, sub; 2 mul, add; add per element
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
    counter (in place, so that replays write it too). Holds the parameters,
    Adam moments and count, rollout obs, env state, episode accounting, step
    counter, actions and last metrics of the two at 1e-6 (expected 0.0: the
    same kernels on the same inputs, the same random numbers), the GAE
    kernel's launches (counted on the card) equal to the iterations on both
    sides, and the actions of consecutive replays different."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.ops import gae_cuda

    preset = PRESETS[preset_name]
    mod, cfg = train.ALGOS[preset.algo], preset.config
    env = train.ENVS[preset.env](**preset.env_kwargs)
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

        gae_cuda.reset_launch_count()
        t0 = time.perf_counter()
        state, metrics = loop.fused_train_loop(
            make_recording_step, mod.init_state, env, cfg, n, state=state, capturable=capturable)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tensors = {f"param {k}": p.detach() for k, p in state.net.named_parameters()}
        tensors.update({f"mu {k}": v for k, v in state.opt_state.mu.items()})
        tensors.update({f"nu {k}": v for k, v in state.opt_state.nu.items()})
        tensors["adam count"] = state.opt_state.count
        tensors["rollout obs"] = state.rollout.obs
        tensors.update({f"env {k}": v for k, v in state.rollout.env_state._asdict().items()})
        tensors.update(ep_return=state.ep_return, ep_length=state.ep_length,
                       avg_return=state.avg_return, step_counter=state.step_counter, actions=drawn)
        tensors.update({f"metric {k}": v for k, v in metrics.items()})
        runs[capturable] = (tensors, (state.update_step, int(state.opt_state.count)),
                            gae_cuda.launch_count(), seconds)

    (eager, eager_counts, eager_launches, eager_s), (graph, graph_counts, graph_launches, graph_s) = (
        runs[False], runs[True])
    assert sorted(eager) == sorted(graph)
    diffs = {k: float((graph[k].double() - eager[k].double()).abs().max()) for k in eager}
    worst = max(diffs.values())
    drawn = graph["actions"]
    changed = [float((drawn[i] != drawn[i + 1]).float().mean())
               for i in range(loop.WARMUP_ITERATIONS, n - 1)]
    print(
        f"graph vs eager, {preset_name} (E={cfg.num_envs}, T={cfg.rollout_steps}), {n} iterations "
        f"({loop.WARMUP_ITERATIONS} eager warm-up, then replays): max abs difference {worst:.3e} "
        f"over {len(diffs)} tensors (worst: {max(diffs, key=diffs.get)}); update_step, Adam count "
        f"{graph_counts} (eager {eager_counts}); GAE launches {graph_launches} (eager "
        f"{eager_launches}); share of actions changed between consecutive replays "
        f"{', '.join(f'{c:.3f}' for c in changed)}; {graph_s:.2f} s (eager {eager_s:.2f} s, "
        f"capture included)",
        flush=True,
    )
    assert worst <= 1e-6, {k: d for k, d in diffs.items() if d > 1e-6}
    assert graph_counts == eager_counts and graph_counts[0] == n, (graph_counts, eager_counts)
    assert graph_launches == eager_launches == n, (graph_launches, eager_launches)
    assert all(c > 0 for c in changed), changed


def drive(argv: list[str], show_every: int) -> tuple[list[dict], dict, dict[str, int]]:
    """Run `train.main(argv)` with every kernel's launch count reset just
    before and read just after; returns (logged rows, summary row,
    launches). Prints the first and last rows, every `show_every`-th and
    the summary."""
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.ops import gae_cuda, vtrace_cuda

    buf = io.StringIO()
    gae_cuda.reset_launch_count()
    vtrace_cuda.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    launches = {"gae": gae_cuda.launch_count(), "vtrace": vtrace_cuda.launch_count()}
    assert rc == 0, f"train.main returned {rc}"
    rows = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    logged, summary = [r for r in rows if "iter" in r], rows[-1]
    for r in logged:
        if r["iter"] in (1, logged[-1]["iter"]) or r["iter"] % show_every == 0:
            print(json.dumps(r), flush=True)
    print(json.dumps(summary), flush=True)
    return logged, summary, launches


def check_rows(logged: list[dict], iterations: int) -> None:
    """Every iteration 1..`iterations` logged or the first and last; finite
    losses on every logged row."""
    import math

    assert logged[0]["iter"] == 1 and logged[-1]["iter"] == iterations, (logged[0], logged[-1])
    for r in logged:
        for k in ("loss", "pg_loss", "v_loss", "entropy"):
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
    the CLI's main(), every iteration logged; returns each kernel's
    launches during that run."""
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
        f"main path impala_pong: {n} iterations of {steps_per_iter:.0f} env steps, "
        f"{per_iter_s * 1e3:.3f} ms/iteration after the first, "
        f"{steps_per_iter / per_iter_s:.0f} env-steps/s; {episodes:.0f} episodes finished, "
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
    print(f"main path a3c_pong: {n} iterations, {per_iter_s * 1e3:.3f} ms/iteration after "
          f"the first; launches {launches}", flush=True)
    return launches


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


def profile_step(preset_name: str) -> None:
    """Where a full-width train step of a preset goes, in one call:
    host-clock rollout and update times of eager steps; then the step run
    eagerly and, for a capturable trainer, as replays of the loop's CUDA
    graph, each with its host-clock time per step (synchronised) and its
    device busy time, busy share and kernel launches per step from
    torch.profiler (top kernels for the eager step)."""
    import torch

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.algos import loop
    from actor_critic_tpu_torch.config import PRESETS

    preset = PRESETS[preset_name]
    mod, cfg = train.ALGOS[preset.algo], preset.config
    env = train.ENVS[preset.env](**preset.env_kwargs)
    state = mod.init_state(env, cfg, seed=1, device="cuda")
    opt = mod.make_optimizer(cfg)
    step = mod.make_train_step(env, cfg)
    side = torch.cuda.Stream()
    for _ in range(loop.WARMUP_ITERATIONS):
        loop.eager_step(step, state, side)
    torch.cuda.synchronize()
    n = 3
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
                f"device busy {busy_us / n / 1e3:.3f} ms/step ({busy_us / 1e6 / wall:.1%}), "
                f"{launches / n:.0f} kernel launches/step",
                flush=True,
            )
        else:
            print(f"{preset_name} {label}: {host_ms:.3f} ms/step (host clock, synchronised); "
                  f"device time not measured (the profiler recorded none)", flush=True)
        if label == "eager":
            for name, (count, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
                print(f"  {us / n:10.1f} us/step {count // n:6d} launches/step  {name[:100]}",
                      flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from actor_critic_tpu_torch import _build

    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)

    t0 = time.perf_counter()
    _build.build("gae", "vtrace")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, text) in _build.build_log.items():
        print(f"nvcc {name}.cu ({secs:.2f} s):\n{text.strip()}", flush=True)

    floor_ms = launch_floor_ms()
    print(f"launch floor: {floor_ms * 1e3:.3f} us on the device (torch.profiler, "
          f"a one-element zero_())", flush=True)
    entries = [check_gae(), check_vtrace()]
    for e in entries:
        e["launch_floor_ms"] = floor_ms
        print(f"{e['name']}: kernel {e['ms'] / floor_ms:.2f}x the launch floor, "
              f"{e['ms'] / e['bound_ms']:.2f}x its bound", flush=True)
    check_update_on_card()
    check_impala_update_on_card()
    check_graph_equals_eager("a2c_cartpole")
    check_graph_equals_eager("ppo_cartpole")
    # Each kernel's launches on its own main path.
    launches = {"gae": run_a2c_cartpole()["gae"], "vtrace": run_impala_pong()["vtrace"]}
    run_ppo_cartpole()
    run_a3c_pong()
    check_impala_learns()
    profile_step("a2c_cartpole")
    profile_step("ppo_cartpole")
    profile_step("impala_pong")
    for e in entries:
        e["launches"] = launches[e["name"]]
        assert e["launches"] > 0, f"kernel {e['name']} was not launched on the main path"

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
