"""Training CLI of the port (counterpart of the JAX package's `train.py`,
its fused path):

    python -m actor_critic_tpu_torch.train --preset a2c_cartpole
    python -m actor_critic_tpu_torch.train --preset ppo_cartpole --set lr=1e-4 --iterations 200
    python -m actor_critic_tpu_torch.train --algo a2c --env jax:pendulum --set num_envs=16
    python -m actor_critic_tpu_torch.train --preset impala_pong --ckpt-dir runs/pong --resume
    python -m actor_critic_tpu_torch.train --preset a2c_cartpole --chunk 4
    python -m actor_critic_tpu_torch.train --list-presets

The flags keep the JAX CLI's spelling and meaning: `--preset`, or `--algo`
and `--env` (`jax:<name>` for the makers of `ENVS`, a bare name as the
presets spell it, or `mixture:<members>`) with `--set KEY=VALUE` config
overrides and `--env-set KEY=VALUE` env-maker kwargs; `--metrics PATH`
(JSONL rows, also echoed to stdout unless `--quiet`; the summary line is
always printed); `--log-every`, `--eval-every`; `--chunk K` (K iterations
per dispatch: one CUDA graph of K steps on the card, K eager steps on the
CPU; the log, eval and save cadences snap up to multiples of K, and say
so); `--ckpt-dir`, `--save-every`, `--resume` (checkpoints of every
carried tensor and the generator, `utils/checkpoint.py`; a resume
continues bit for bit); `--scale-actions/--no-scale-actions` (Pendulum's
action convention, guarded on resume with the `env_convention.json`
sidecar); `--curriculum SPEC` (a mixture env with `--eval-every`:
re-weights the fleet's type draw as the eval return crosses the spec's
thresholds, grammar `envs/mixture.py::parse_curriculum`; turns on
`redraw_types` unless `--env-set` says otherwise; the stage rides the
checkpoint). `--device cpu` runs on the CPU; by default the run is on the
card, where each iteration after the first two is a CUDA-graph replay
(`algos/loop.py`) and each eval a replay of captured blocks
(`algos/common.py::BlockedEval`).

A mixture env's eval rows add the per-type eval matrix
(`eval_return_<member>`), the fleet's share of each type
(`fleet_share_<member>`) and the stage its state carries (`fleet_stage`),
both read from the device, and with a curriculum `curriculum_stage`.
Every eval starts the eval generator from `seed + 1`, as the JAX CLI
evaluates with one fixed key, so a resumed run evaluates as the straight
one. Each row's `wall_s` leaves the evals out.

Not ported yet, and refused with a message that says so: `--algo
ddpg|td3|sac`, `host:`/`native:` envs, and the flags of the paths that
come later (`UNPORTED_FLAGS`).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import sys
import time
import warnings

import torch

from actor_critic_tpu_torch import resolve_device
from actor_critic_tpu_torch.algos import a2c, impala, ppo
from actor_critic_tpu_torch.algos.loop import fused_train_loop
from actor_critic_tpu_torch.config import (
    PRESETS,
    UNPORTED_ALGOS,
    parse_env_set_args,
    parse_set_args,
    resolve,
)
from actor_critic_tpu_torch.envs import (
    make_bandit,
    make_cartpole,
    make_mixture,
    make_pendulum,
    make_point_mass,
    make_pong,
    make_two_state_mdp,
    mixture,
)
from actor_critic_tpu_torch.envs.env import TorchEnv
from actor_critic_tpu_torch.utils.cadence import finite_or_none
from actor_critic_tpu_torch.utils.checkpoint import Checkpointer
from actor_critic_tpu_torch.utils.logging import JsonlLogger

# The JAX CLI's `jax:` makers, by name.
ENVS = {
    "cartpole": make_cartpole,
    "pendulum": make_pendulum,
    "pong": make_pong,
    "two_state": make_two_state_mdp,
    "point_mass": make_point_mass,
    "bandit": make_bandit,
}
ALGOS = {"a2c": a2c, "ppo": ppo, "impala": impala, "a3c": impala}
# The JAX CLI's flags whose paths are not ported yet, with the path each
# belongs to (ROADMAP.md Queue 1). Each is refused with that message.
UNPORTED_FLAGS = {
    "--replay-dtype": "the off-policy trainers and the replay ring",
    "--no-save-replay": "the off-policy trainers and the replay ring",
    "--workers": "the host env path",
    "--eval-envs": "the host env path",
    "--eval-steps": "the host env path",
    "--no-overlap": "the host env path",
    "--async-actors": "the async actor-learner",
    "--updates-per-block": "the async actor-learner",
    "--max-staleness": "the async actor-learner",
    "--queue-depth": "the async actor-learner",
    "--async-correction": "the async actor-learner",
    "--data-plane": "the async actor-learner's device data plane",
    "--data-plane-codec": "the async actor-learner's device data plane",
    "--update-dtype": "bf16 compute",
    "--distributed": "multi-GPU",
    "--coordinator": "multi-GPU",
    "--num-processes": "multi-GPU",
    "--process-id": "multi-GPU",
    "--gossip": "multi-GPU",
    "--gossip-every": "multi-GPU",
    "--gossip-weight": "multi-GPU",
    "--mailbox-dir": "multi-GPU",
    "--serve-port": "serving",
    "--serve-buckets": "serving",
    "--telemetry-dir": "telemetry",
    "--telemetry-port": "telemetry",
    "--telemetry-bind": "telemetry",
    "--telemetry-sample-s": "telemetry",
    "--stall-timeout": "the stall watchdog",
    "--compile-cache-dir": "the compile cache",
    "--warmup": "the compile cache's warm-up",
    "--no-warmup": "the compile cache's warm-up",
}


def env_name(spec: str) -> str:
    """A `jax:` spec's maker name; the presets' bare names are the same."""
    return spec.removeprefix("jax:")


def make_env(spec: str, env_kwargs: dict, scale_actions=None) -> TorchEnv:
    """The env `spec` names: `jax:<name>` or `<name>` for a maker of `ENVS`,
    or `mixture:<members>` (the member list, with optional draw weights).
    `scale_actions` (the tri-state CLI flag) sets Pendulum's action
    convention. Unknown kwargs and bad values exit with the maker's valid
    keywords; `host:` and `native:` specs exit as not ported yet."""
    kind, sep, name = spec.partition(":")
    env_kwargs = dict(env_kwargs)
    if kind in ("host", "native"):
        raise SystemExit(
            f"{kind}:<id> envs are not ported yet (the host env path comes in a later "
            f"slice); the port runs jax:<name> ({', '.join(sorted(ENVS))}) and mixture:<members>")
    if kind == "mixture":
        maker, args = make_mixture, (name,)
    elif not sep or kind == "jax":
        name = env_name(spec)
        if name not in ENVS:
            raise SystemExit(f"unknown jax env {name!r}; valid: {sorted(ENVS)}")
        maker, args = ENVS[name], ()
        if name == "pendulum":
            env_kwargs["scale_actions"] = effective_scale_actions(spec, scale_actions, env_kwargs)
    else:
        raise SystemExit(
            f"env must be jax:<name>, mixture:<members>, host:<gym id>, or native:<id>, "
            f"got {spec!r}")
    valid = set(inspect.signature(maker).parameters) - {"members"}
    unknown = sorted(set(env_kwargs) - valid)
    if unknown:
        raise SystemExit(
            f"bad --env-set for {spec}: unknown kwargs {unknown}; valid: {sorted(valid)}")
    try:
        return maker(*args, **env_kwargs)
    except ValueError as e:
        raise SystemExit(f"bad env {spec!r}: {e}") from e


def effective_scale_actions(env_spec: str, scale_actions, env_kwargs=None):
    """The action convention the env will use (the JAX CLI's rule):
    Pendulum scales unless told otherwise, the CLI flag first, then an
    `--env-set scale_actions=...`; None for envs with no such choice."""
    if env_name(env_spec) == "pendulum":
        if scale_actions is not None:
            return bool(scale_actions)
        kw = (env_kwargs or {}).get("scale_actions")
        return True if kw is None else bool(kw)
    return None


def check_env_convention(ckpt_dir, env_spec: str, scale_actions, resume: bool,
                         env_kwargs=None) -> None:
    """The resume guard (the JAX CLI's): record the run's env, its
    effective action convention and its env kwargs in
    `<ckpt_dir>/env_convention.json`, and warn when a resume changes any of
    them (the restored policy would go on in another env). A fresh run
    overwrites the sidecar; a directory without one is tolerated."""
    if not ckpt_dir:
        return
    env_kwargs = dict(env_kwargs or {})
    resolved = effective_scale_actions(env_spec, scale_actions, env_kwargs)
    env_kwargs.pop("scale_actions", None)
    path = os.path.join(ckpt_dir, "env_convention.json")
    if resume and os.path.exists(path):
        with open(path) as f:
            saved = json.load(f)
        saved_kwargs = saved.get("env_kwargs")
        saved_resolved = effective_scale_actions(
            saved.get("env", env_spec), saved.get("scale_actions"), saved_kwargs)
        if saved_kwargs is not None:
            saved_kwargs = dict(saved_kwargs)
            saved_kwargs.pop("scale_actions", None)
        saved_env = saved.get("env")
        if saved_env is not None and saved_env != env_spec:
            warnings.warn(
                f"--resume into {env_spec!r} but this checkpoint dir belongs to a "
                f"{saved_env!r} run — the restored policy trained on a different "
                "environment. Use a fresh --ckpt-dir or the original env.", stacklevel=2)
            return
        if saved_resolved != resolved:
            warnings.warn(
                f"--resume with scale_actions={resolved!r} but this run started with "
                f"{saved_resolved!r} — the restored policy trained under the other action "
                "convention. Relaunch with the original flag.", stacklevel=2)
        if saved_kwargs is not None and saved_kwargs != env_kwargs:
            warnings.warn(
                f"--resume with env_kwargs={env_kwargs!r} but this run started with "
                f"{saved_kwargs!r} — the restored policy would continue in a different "
                "environment. Relaunch with the original --env-set/preset.", stacklevel=2)
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"env": env_spec, "scale_actions": resolved, "env_kwargs": env_kwargs}, f)


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (it belongs to "
                     f"{UNPORTED_FLAGS[option_string]}, which comes in a later slice)")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", help="named preset (see --list-presets)")
    p.add_argument("--algo", help="a2c|ppo|impala|a3c (ddpg|td3|sac: not ported yet)")
    p.add_argument("--env", help="jax:<name> or mixture:<members>")
    p.add_argument("--iterations", type=int, help="train-step iterations")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override (repeatable), e.g. --set lr=1e-4 --set hidden=64,64")
    p.add_argument("--env-set", action="append", default=[], metavar="KEY=VALUE",
                   help="env-maker kwarg (repeatable), merged over the preset's env_kwargs")
    p.add_argument(
        "--curriculum", default="", metavar="SPEC",
        help="mixture envs, with --eval-every: re-weight the type draw as the "
        "eval return crosses thresholds, 'THR:w0,w1,..;THR:w0,w1,..' (weights in "
        "member order); turns on redraw_types")
    p.add_argument("--metrics", default="metrics.jsonl", help="JSONL output path")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--chunk", type=int, default=1,
                   help="train iterations per dispatch (one CUDA graph of K steps on the "
                   "card); log/eval/save cadences snap up to multiples of this")
    p.add_argument("--eval-every", type=int, default=0,
                   help="greedy-eval cadence in iterations (0 = off)")
    p.add_argument("--quiet", action="store_true", help="no stdout metric echo")
    p.add_argument(
        "--scale-actions", action=argparse.BooleanOptionalAction, default=None,
        help="continuous envs: map policy actions from [-1,1] onto the env's bounds "
        "instead of clipping (default: the env's own convention; jax:pendulum scales)")
    p.add_argument("--ckpt-dir", help="checkpoint directory")
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--resume", action="store_true", help="resume from --ckpt-dir")
    p.add_argument("--list-presets", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for flag in UNPORTED_FLAGS:
        p.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)
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


def snap_cadences(args: argparse.Namespace) -> None:
    """With `--chunk K`, the cadences fire only at chunk boundaries: snap
    `log_every`, `eval_every` and `save_every` up to multiples of K, and say
    so."""
    k = args.chunk
    for name in ("log_every", "eval_every", "save_every"):
        old = getattr(args, name)
        if old > 0 and old % k:
            new = (old + k - 1) // k * k
            print(f"--chunk {k}: {name} {old} -> {new}", flush=True)
            setattr(args, name, new)


def run_fused(env: TorchEnv, preset, args: argparse.Namespace, logger: JsonlLogger,
              device: torch.device) -> dict:
    """Train `preset` on `env` through `fused_train_loop`, with the evals,
    the curriculum and the checkpoints the flags ask for; returns the last
    metrics."""
    mod, cfg = ALGOS[preset.algo], preset.config
    steps_per_iter = cfg.num_envs * cfg.rollout_steps
    state = mod.init_state(env, cfg, args.seed, device)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and args.resume and ckpt.latest_step() is not None:
        print(f"resumed from iteration {ckpt.latest_step()}", flush=True)
    eval_fn = mod.make_eval_fn(env, cfg) if args.eval_every > 0 else None
    is_mixture = isinstance(env, mixture.MixtureEnv)
    typed_eval = mixture.make_typed_eval(env) if eval_fn is not None and is_mixture else None
    type_ids = torch.arange(env.n_types, device=device) if typed_eval is not None else None
    curriculum = (mixture.CurriculumController(
        mixture.parse_curriculum(args.curriculum, env.member_names))
        if args.curriculum else None)
    pending: list[tuple[int, tuple[float, ...]]] = []  # a stage's weights, to install
    eval_gen = torch.Generator(device=device)
    t0 = time.perf_counter()
    eval_s = 0.0  # time spent in evals so far, left out of wall_s

    def log_fn(it: int, metrics: dict) -> None:
        nonlocal eval_s
        # wall_s is stamped before this row's eval and leaves out the
        # earlier ones, so it times training alone.
        row = {**metrics, "env_steps": it * steps_per_iter,
               "wall_s": time.perf_counter() - t0 - eval_s}
        if eval_fn is not None and (it % args.eval_every == 0 or it == args.iterations):
            t_eval = time.perf_counter()
            eval_gen.manual_seed(args.seed + 1)
            row["eval_return"] = float(eval_fn(state, eval_gen))
            if typed_eval is not None:
                for t, name in enumerate(env.member_names):
                    r = float(typed_eval(state, eval_gen, type_ids[t]))
                    row[f"eval_return_{name}"] = round(r, 3)
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
        logger.log(it, row)

    synced = [False]

    def install_weights(it: int, state) -> None:
        if not synced[0]:
            # First call, after a possible restore: the controller takes up
            # the stage the fleet carries, so a resumed run goes on with the
            # schedule and does not re-fire a threshold it has crossed.
            curriculum.sync(mixture.fleet_stage(state.rollout.env_state))
            synced[0] = True
        if pending:
            stage, weights = pending.pop()
            mixture.set_fleet_weights(state.rollout.env_state, weights, stage)

    _, metrics = fused_train_loop(
        mod.make_train_step, mod.init_state, env, cfg, args.iterations,
        seed=args.seed, device=device, state=state,
        log_every=args.log_every, log_fn=log_fn, eval_every=args.eval_every,
        capturable=mod.CAPTURABLE,
        state_hook=install_weights if curriculum is not None else None,
        chunk=args.chunk, ckpt=ckpt, save_every=args.save_every, resume=args.resume,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {**metrics, "wall_s": time.perf_counter() - t0 - eval_s}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list_presets:
        for name, pre in PRESETS.items():
            print(f"{name:18s} {pre.algo:7s} {pre.env:40s} {pre.description}")
        return 0
    if args.algo in UNPORTED_ALGOS:
        raise SystemExit(f"--algo {args.algo} is not ported yet (the off-policy trainers come "
                         f"in a later slice); ported: {sorted(ALGOS)}")
    try:
        preset = resolve(args.preset, args.algo, args.env, parse_set_args(args.set),
                         env_overrides=parse_env_set_args(args.env_set))
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e)) from e
    if args.iterations is None:
        args.iterations = preset.iterations
    if args.chunk < 1:
        raise SystemExit(f"--chunk must be >= 1, got {args.chunk}")
    if args.curriculum:
        check_curriculum(args, preset.env)
        # The weights act on type redraws; an explicit
        # --env-set redraw_types=false wins.
        preset.env_kwargs.setdefault("redraw_types", True)
    device = resolve_device(args.device)
    print(f"algo={preset.algo} env={preset.env} iterations={args.iterations} "
          f"config={dataclasses.asdict(preset.config)} env_kwargs={preset.env_kwargs}",
          flush=True)
    env = make_env(preset.env, preset.env_kwargs, args.scale_actions)
    check_env_convention(args.ckpt_dir, preset.env, args.scale_actions, args.resume,
                         env_kwargs=preset.env_kwargs)
    if args.chunk > 1:
        snap_cadences(args)
    with JsonlLogger(args.metrics, echo=not args.quiet) as logger:
        final = run_fused(env, preset, args, logger, device)
    cfg = preset.config
    print(json.dumps({
        "algo": preset.algo,
        "env": preset.env,
        "device": str(device),
        "iterations": args.iterations,
        "env_steps": args.iterations * cfg.num_envs * cfg.rollout_steps,
        **{k: finite_or_none(v) for k, v in final.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
