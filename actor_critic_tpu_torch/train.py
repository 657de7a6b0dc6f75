"""Training CLI of the port.

    python -m actor_critic_tpu_torch.train --preset a2c_cartpole|impala_pong|... \
        [--iterations N] [--seed S] [--eval-every K] [--log-every K] \
        [--device cuda|cpu]

Prints one JSON row per logged iteration (the first and last always, every
`--log-every`, and every eval iteration), then one JSON summary line, as
the JAX package's `train.py` does. Runs on the card unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from actor_critic_tpu_torch import resolve_device
from actor_critic_tpu_torch.algos import a2c, impala
from actor_critic_tpu_torch.algos.loop import fused_train_loop
from actor_critic_tpu_torch.config import PRESETS
from actor_critic_tpu_torch.envs import make_cartpole, make_pong

ENVS = {"cartpole": make_cartpole, "pong": make_pong}
ALGOS = {"a2c": a2c, "impala": impala, "a3c": impala}


def _json_row(row: dict) -> str:
    # NaN/Inf → null: every line stays strict JSON.
    return json.dumps({
        k: (v if math.isfinite(v) else None) if isinstance(v, float) else v
        for k, v in row.items()
    })


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a preset of the PyTorch port.")
    p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    preset = PRESETS[args.preset]
    mod = ALGOS[preset.algo]
    env = ENVS[preset.env](**preset.env_kwargs)
    cfg = preset.config
    iterations = args.iterations or preset.iterations
    steps_per_iter = cfg.num_envs * cfg.rollout_steps

    state = mod.init_state(env, cfg, args.seed, device)
    eval_fn = mod.make_eval_fn(env, cfg) if args.eval_every > 0 else None
    eval_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    t0 = time.perf_counter()

    def log_fn(it: int, metrics: dict) -> None:
        # wall_s is stamped before the eval, so it times training alone.
        row = {"iter": it, **metrics, "env_steps": it * steps_per_iter,
               "wall_s": time.perf_counter() - t0}
        if eval_fn is not None and (it % args.eval_every == 0 or it == iterations):
            row["eval_return"] = float(eval_fn(state, eval_gen))
        print(_json_row(row), flush=True)

    _, metrics = fused_train_loop(
        mod.make_train_step, mod.init_state, env, cfg, iterations,
        seed=args.seed, device=device, state=state,
        log_every=args.log_every, log_fn=log_fn, eval_every=args.eval_every,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(_json_row({
        "algo": preset.algo,
        "env": preset.env,
        "device": str(device),
        "iterations": iterations,
        "env_steps": iterations * steps_per_iter,
        "wall_s": time.perf_counter() - t0,
        **{k: float(v) for k, v in metrics.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
