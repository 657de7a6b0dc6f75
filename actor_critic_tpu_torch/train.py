"""Training CLI of the port.

    python -m actor_critic_tpu_torch.train --preset a2c_cartpole|ppo_cartpole|impala_pong|a2c_mixture|... \
        [--iterations N] [--seed S] [--eval-every K] [--log-every K] \
        [--env-set KEY=VALUE ...] [--curriculum SPEC] [--device cuda|cpu]

Prints one JSON row per logged iteration (the first and last always, every
`--log-every`, and every eval iteration), then one JSON summary line, as
the JAX package's `train.py` does. Runs on the card unless `--device cpu`
is given; there A2C and PPO run each iteration after the first two as one
CUDA graph (`algos/loop.py`).

A `mixture:<members>` env (`a2c_mixture`) is the scenario-mixture fleet
(`envs/mixture.py`); `--env-set` reaches its maker (randomize,
action_bins, redraw_types, ...). Its eval rows add the per-type eval
matrix (`eval_return_<member>`), the fleet's share of each type
(`fleet_share_<member>`) and the stage its state carries (`fleet_stage`),
both read from the device. `--curriculum SPEC` re-weights the fleet's
type draw as the eval return crosses the spec's thresholds (grammar:
`envs/mixture.py::parse_curriculum`); it needs a mixture env and
`--eval-every`, turns on `redraw_types` unless `--env-set` says
otherwise, and adds `curriculum_stage` to the eval rows. A stage's new
weights are written into the fleet state before the next iteration.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import sys
import time

import torch

from actor_critic_tpu_torch import resolve_device
from actor_critic_tpu_torch.algos import a2c, impala, ppo
from actor_critic_tpu_torch.algos.loop import fused_train_loop
from actor_critic_tpu_torch.config import PRESETS
from actor_critic_tpu_torch.envs import make_cartpole, make_mixture, make_pong
from actor_critic_tpu_torch.envs import mixture
from actor_critic_tpu_torch.envs.env import TorchEnv

ENVS = {"cartpole": make_cartpole, "pong": make_pong}
ALGOS = {"a2c": a2c, "ppo": ppo, "impala": impala, "a3c": impala}


def _json_row(row: dict) -> str:
    # NaN/Inf → null: every line stays strict JSON.
    return json.dumps({
        k: (v if math.isfinite(v) else None) if isinstance(v, float) else v
        for k, v in row.items()
    })


def coerce_env_value(raw: str):
    """An `--env-set` value: bools and None by keyword, then int, then
    float, else the string (the JAX CLI's rule)."""
    low = raw.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("none", "null"):
        return None
    for typ in (int, float):
        try:
            return typ(raw)
        except ValueError:
            pass
    return raw


def parse_env_set(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs:
        key, sep, value = pair.partition("=")
        if not sep:
            raise SystemExit(f"--env-set expects key=value, got {pair!r}")
        out[key.strip()] = coerce_env_value(value.strip())
    return out


def make_env(spec: str, env_kwargs: dict) -> TorchEnv:
    """The env a preset names: a name of `ENVS`, or `mixture:<members>`
    (the member list, with optional draw weights, is the spec). Unknown
    kwargs and bad values exit with the maker's valid keywords."""
    kind, _, members = spec.partition(":")
    maker, args = (make_mixture, (members,)) if kind == "mixture" else (ENVS[spec], ())
    valid = set(inspect.signature(maker).parameters) - {"members"}
    unknown = sorted(set(env_kwargs) - valid)
    if unknown:
        raise SystemExit(
            f"bad --env-set for {spec}: unknown kwargs {unknown}; valid: {sorted(valid)}")
    try:
        return maker(*args, **env_kwargs)
    except ValueError as e:
        raise SystemExit(f"bad env {spec!r}: {e}") from e


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train a preset of the PyTorch port.")
    p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument(
        "--env-set", action="append", default=[], metavar="KEY=VALUE",
        help="env-maker kwarg (repeatable), merged over the preset's env_kwargs")
    p.add_argument(
        "--curriculum", default="", metavar="SPEC",
        help="mixture envs, with --eval-every: re-weight the type draw as the "
        "eval return crosses thresholds, 'THR:w0,w1,..;THR:w0,w1,..' (weights in "
        "member order); turns on redraw_types")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def check_curriculum(args: argparse.Namespace, env_spec: str) -> None:
    """Every doomed `--curriculum` exits here, before any env or device
    work: it re-weights a mixture fleet's type draw, and advances on the
    eval cadence."""
    if not env_spec.startswith("mixture:"):
        raise SystemExit(
            "--curriculum re-weights a mixture fleet's type draw (a mixture:<members> "
            f"env); it has no effect on {env_spec!r}")
    if args.eval_every <= 0:
        raise SystemExit("--curriculum advances on learner eval progress — pass --eval-every N")
    try:
        names = tuple(n for n, _ in mixture.parse_mixture_spec(env_spec.partition(":")[2]))
        mixture.parse_curriculum(args.curriculum, names)
    except ValueError as e:
        raise SystemExit(f"bad --curriculum: {e}") from e


def main(argv=None) -> int:
    args = parse_args(argv)
    preset = PRESETS[args.preset]
    env_kwargs = {**preset.env_kwargs, **parse_env_set(args.env_set)}
    if args.curriculum:
        check_curriculum(args, preset.env)
        # The weights act on type redraws; an explicit
        # --env-set redraw_types=false wins.
        env_kwargs.setdefault("redraw_types", True)
    device = resolve_device(args.device)
    mod = ALGOS[preset.algo]
    env = make_env(preset.env, env_kwargs)
    cfg = preset.config
    iterations = args.iterations or preset.iterations
    steps_per_iter = cfg.num_envs * cfg.rollout_steps

    state = mod.init_state(env, cfg, args.seed, device)
    eval_fn = mod.make_eval_fn(env, cfg) if args.eval_every > 0 else None
    is_mixture = isinstance(env, mixture.MixtureEnv)
    typed_eval = mixture.make_typed_eval(env) if eval_fn is not None and is_mixture else None
    curriculum = (mixture.CurriculumController(
        mixture.parse_curriculum(args.curriculum, env.member_names))
        if args.curriculum else None)
    pending: list[tuple[int, tuple[float, ...]]] = []  # a stage's weights, to install
    eval_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    eval_s = 0.0  # time spent in evals so far, left out of wall_s

    def log_fn(it: int, metrics: dict) -> None:
        nonlocal eval_s
        # wall_s is stamped before this row's eval and leaves out the
        # earlier ones, so it times training alone.
        row = {"iter": it, **metrics, "env_steps": it * steps_per_iter,
               "wall_s": time.perf_counter() - t0 - eval_s}
        if eval_fn is not None and (it % args.eval_every == 0 or it == iterations):
            t_eval = time.perf_counter()
            row["eval_return"] = float(eval_fn(state, eval_gen))
            if typed_eval is not None:
                for t, name in enumerate(env.member_names):
                    row[f"eval_return_{name}"] = round(float(typed_eval(state, eval_gen, t)), 3)
            if is_mixture:
                fleet = state.rollout.env_state
                shares = mixture.type_shares(fleet, env.n_types)
                row.update({f"fleet_share_{name}": s for name, s in zip(env.member_names, shares)})
                row["fleet_stage"] = mixture.fleet_stage(fleet)
            if curriculum is not None:
                advanced = curriculum.update(row["eval_return"])
                if advanced is not None:
                    pending[:] = [advanced]
                    print(f"curriculum: eval {row['eval_return']:.1f} -> stage {advanced[0]}, "
                          f"weights {list(advanced[1])}", flush=True)
                row["curriculum_stage"] = curriculum.stage
            eval_s += time.perf_counter() - t_eval
        print(_json_row(row), flush=True)

    def install_weights(it: int, state) -> None:
        if pending:
            stage, weights = pending.pop()
            mixture.set_fleet_weights(state.rollout.env_state, weights, stage)

    _, metrics = fused_train_loop(
        mod.make_train_step, mod.init_state, env, cfg, iterations,
        seed=args.seed, device=device, state=state,
        log_every=args.log_every, log_fn=log_fn, eval_every=args.eval_every,
        capturable=mod.CAPTURABLE,
        state_hook=install_weights if curriculum is not None else None,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(_json_row({
        "algo": preset.algo,
        "env": preset.env,
        "device": str(device),
        "iterations": iterations,
        "env_steps": iterations * steps_per_iter,
        "wall_s": time.perf_counter() - t0 - eval_s,
        **{k: float(v) for k, v in metrics.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
