#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (from nvidia-smi);
2. build: every CUDA kernel of the main path, from `actor_critic_tpu_torch/csrc`;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shape and at boundary shapes, with its tolerance, and
   its time beside the plain version's and the card's bound; then one A2C
   update on the card against the same update on the CPU;
4. main path: the `a2c_cartpole` preset at full width (E=4096, T=64)
   through `actor_critic_tpu_torch.train.main` for a few iterations, with
   the launch counts reset just before and read just after; then where a
   train step's time goes (host clock and torch.profiler);
5. a `{"kernels": [...]}` line, then the card's name and power limit;
6. last line: `{"ok": true, "device": {"platform": "gpu", ...}}`.

Exits non-zero, printing no result, where no CUDA device is present.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

MAIN_PATH_ITERATIONS = 50
# Kernel vs plain version: the same tolerance as the JAX package's kernel
# tests (tests/test_pallas_scan.py). The kernel rounds every operation in
# the plain version's order, so on the card the two should agree exactly.
ATOL = RTOL = 1e-6
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


def gae_inputs(T: int, E: int, seed: int, done_at_t0: bool = False):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rewards = torch.randn((T, E), generator=g, device="cuda")
    values = torch.randn((T, E), generator=g, device="cuda")
    dones = (torch.rand((T, E), generator=g, device="cuda") < 0.1).float()
    if done_at_t0:
        dones.zero_()
        dones[0] = 1.0
    bootstrap = torch.randn((E,), generator=g, device="cuda")
    return rewards, values, dones, bootstrap


def check_gae() -> dict:
    """GAE kernel vs `ops.returns.gae` on the card; returns its kernels-line entry."""
    import torch

    from actor_critic_tpu_torch.ops import gae_cuda, returns

    cases = [
        ("preset", 64, 4096, False),
        ("T17-E512", 17, 512, False),
        ("E7", 17, 7, False),
        ("E96", 17, 96, False),
        ("E200", 17, 200, False),
        ("T1", 1, 512, False),
        ("done-at-t0", 4, 512, True),
        ("multi-block", 64, 4096 + 37, False),
    ]
    max_err = 0.0
    for i, (name, T, E, d0) in enumerate(cases):
        args = gae_inputs(T, E, seed=i, done_at_t0=d0)
        adv, ret = gae_cuda.gae(*args, GAMMA, LAM)
        adv_p, ret_p = returns.gae(*args, GAMMA, LAM)
        torch.cuda.synchronize()
        for got, want in ((adv, adv_p), (ret, ret_p)):
            assert got.shape == (T, E) and bool(torch.isfinite(got).all()), name
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL, msg=lambda m: f"gae {name}: {m}")
        err = max(float((adv - adv_p).abs().max()), float((ret - ret_p).abs().max()))
        max_err = max(max_err, err)
        print(f"gae {name:12s} T={T:3d} E={E:5d} max_abs_err={err:.3e}", flush=True)

    T, E = 64, 4096
    args = gae_inputs(T, E, seed=100)
    event_ms = cuda_ms(lambda: gae_cuda.gae(*args, GAMMA, LAM), iters=500)
    plain_ms = cuda_ms(lambda: returns.gae(*args, GAMMA, LAM), iters=20)
    # Back-to-back calls timed by events include the wrapper's host time
    # when the host is the slower side; the profiler gives the kernel's own
    # device time (events are the fall back where it records none).
    prof, _ = profile_kernels(lambda: gae_cuda.gae(*args, GAMMA, LAM), iters=100)
    gae_rows = [(n, us) for k, (n, us) in prof.items() if "gae_kernel" in k]
    ms = gae_rows[0][1] / gae_rows[0][0] / 1e3 if gae_rows else event_ms
    bytes_moved = (5 * T * E + E) * 4  # 3 inputs + 2 outputs [T,E], bootstrap [E]
    flops = 8 * T * E  # sub, 2 mul, add, sub; 2 mul, add; add per element
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S else "operations"
    print(
        f"gae [64,4096]: kernel {ms * 1e3:.2f} us on the device "
        f"({'torch.profiler' if gae_rows else 'not measured by the profiler; CUDA events'}), "
        f"{event_ms * 1e3:.2f} us a call back to back (CUDA events), plain {plain_ms * 1e3:.2f} us, "
        f"bound {bound_s * 1e6:.2f} us ({bound_by}: {bytes_moved} B, {flops} flop)",
        flush=True,
    )
    return {
        "name": "gae",
        "route": "cuda",
        "source": "actor_critic_tpu_torch/csrc/gae.cu",
        "replaces": "actor_critic_tpu/ops/pallas_scan.py:107",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        # No single PyTorch call computes GAE.
        "library_ms": None,
    }


def check_update_on_card() -> None:
    """One A2C update on the card against the same update on the CPU (plain
    GAE there), from the same state and rollout at a small size: the slice
    as a whole, kernel included, gives the CPU's answer. Float32 matrix
    products stay in full float32 (TF32 off); tolerance on the parameters
    atol 1e-5·lr + rtol 1e-6 (see tests/test_torch_a2c.py), on the loss
    metrics rtol 1e-5 (sums taken in another order)."""
    import copy

    import torch

    from actor_critic_tpu_torch.algos import a2c
    from actor_critic_tpu_torch.algos.common import RolloutState, Transition
    from actor_critic_tpu_torch.envs import make_cartpole

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = a2c.A2CConfig(num_envs=64, rollout_steps=16, lr=1e-3, anneal_iters=10,
                        lr_final=0.0, entropy_coef_final=0.0)
    env = make_cartpole()
    cpu = a2c.init_state(env, cfg, seed=3, device="cpu")
    traj = a2c.rollout(env, cfg, cpu)
    gpu = copy.deepcopy(cpu)
    gpu.net = gpu.net.cuda()
    gpu.opt_state.mu = {k: v.cuda() for k, v in gpu.opt_state.mu.items()}
    gpu.opt_state.nu = {k: v.cuda() for k, v in gpu.opt_state.nu.items()}
    gpu.rollout = RolloutState(env_state=None, obs=gpu.rollout.obs.cuda())
    gpu.ep_return, gpu.ep_length, gpu.avg_return = (
        gpu.ep_return.cuda(), gpu.ep_length.cuda(), gpu.avg_return.cuda())
    m_cpu = a2c.update(env, cfg, a2c.make_optimizer(cfg), cpu, traj)
    m_gpu = a2c.update(env, cfg, a2c.make_optimizer(cfg), gpu,
                       Transition(*(x.cuda() for x in traj)))
    torch.cuda.synchronize()
    worst = 0.0
    for (k, pc), (_, pg) in zip(cpu.net.named_parameters(), gpu.net.named_parameters()):
        torch.testing.assert_close(pg.detach().cpu(), pc.detach(), atol=1e-5 * cfg.lr, rtol=1e-6,
                                   msg=lambda m, k=k: f"update on card, {k}: {m}")
        worst = max(worst, float((pg.detach().cpu() - pc.detach()).abs().max()))
    for k in ("loss", "pg_loss", "v_loss", "entropy", "mean_finished_return"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], atol=0.0, rtol=1e-5,
                                   msg=lambda m, k=k: f"update on card, metric {k}: {m}")
    print(f"update on card vs CPU (E=64, T=16): max abs parameter difference {worst:.3e}",
          flush=True)


def run_main_path() -> dict[str, int]:
    """Train the a2c_cartpole preset at full width through the CLI's main();
    returns each kernel's launches during that run."""
    import math

    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.ops import gae_cuda

    argv = ["--preset", "a2c_cartpole", "--iterations", str(MAIN_PATH_ITERATIONS),
            "--log-every", "10", "--eval-every", str(MAIN_PATH_ITERATIONS), "--seed", "0"]
    buf = io.StringIO()
    gae_cuda.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    launches = {"gae": gae_cuda.launch_count()}
    out = buf.getvalue()
    print(out, end="", flush=True)
    assert rc == 0, f"train.main returned {rc}"
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    logged, summary = [r for r in rows if "iter" in r], rows[-1]
    first, last = logged[0], logged[-1]
    assert first["iter"] == 1 and last["iter"] == MAIN_PATH_ITERATIONS, (first, last)
    for r in logged:
        for k in ("loss", "pg_loss", "v_loss", "entropy"):
            assert r[k] is not None and math.isfinite(r[k]), (r["iter"], k, r[k])
    assert launches["gae"] == MAIN_PATH_ITERATIONS, launches
    assert last["mean_finished_return"] > first["mean_finished_return"], (
        first["mean_finished_return"], last["mean_finished_return"])
    assert last.get("eval_return") is not None, last
    per_iter_s = (last["wall_s"] - first["wall_s"]) / (last["iter"] - first["iter"])
    steps_per_iter = summary["env_steps"] / summary["iterations"]
    print(
        f"main path: {MAIN_PATH_ITERATIONS} iterations of {steps_per_iter:.0f} env steps, "
        f"{per_iter_s * 1e3:.3f} ms/iteration after the first, "
        f"{steps_per_iter / per_iter_s:.0f} env-steps/s; mean_finished_return "
        f"{first['mean_finished_return']:.3f} -> {last['mean_finished_return']:.3f}, "
        f"greedy eval {last['eval_return']:.3f}; launches {launches}",
        flush=True,
    )
    return launches


def profile_main_path() -> None:
    """Where a full-width train step's time goes: host-clock rollout and
    update times, then device busy share and the top kernels from
    torch.profiler over a few steps."""
    import torch

    from actor_critic_tpu_torch.algos import a2c
    from actor_critic_tpu_torch.config import PRESETS
    from actor_critic_tpu_torch.envs import make_cartpole

    cfg = PRESETS["a2c_cartpole"].config
    env = make_cartpole()
    state = a2c.init_state(env, cfg, seed=1, device="cuda")
    opt = a2c.make_optimizer(cfg)
    step = a2c.make_train_step(env, cfg)
    for _ in range(2):
        step(state)
    torch.cuda.synchronize()
    n = 3
    t_roll = t_upd = 0.0
    for _ in range(n):
        t0 = time.perf_counter()
        traj = a2c.rollout(env, cfg, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a2c.update(env, cfg, opt, state, traj)
        torch.cuda.synchronize()
        t_roll += t1 - t0
        t_upd += time.perf_counter() - t1
    kernels, wall = profile_kernels(lambda: step(state), iters=n)
    busy_us = sum(us for _, us in kernels.values())
    launches = sum(c for c, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    print(
        f"train step at E={cfg.num_envs}, T={cfg.rollout_steps} (host clock, synchronised): "
        f"rollout {t_roll / n * 1e3:.3f} ms, update {t_upd / n * 1e3:.3f} ms",
        flush=True,
    )
    if busy_us > 0:
        print(
            f"profiled {n} steps: wall {wall / n * 1e3:.3f} ms/step under the profiler, "
            f"device busy {busy_us / n / 1e3:.3f} ms/step ({busy_us / 1e6 / wall:.1%}), "
            f"{launches / n:.0f} kernel launches/step",
            flush=True,
        )
        for name, (count, us) in top:
            print(f"  {us / n:10.1f} us/step {count // n:6d} launches/step  {name[:100]}", flush=True)
    else:
        print("profiled steps: device time not measured (the profiler recorded none)", flush=True)


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
    _build.build("gae")
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, text) in _build.build_log.items():
        print(f"nvcc {name}.cu ({secs:.2f} s):\n{text.strip()}", flush=True)

    entries = [check_gae()]
    check_update_on_card()
    launches = run_main_path()
    profile_main_path()
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
