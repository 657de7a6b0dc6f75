"""Training CLI of the port (counterpart of the JAX package's `train.py`,
its fused path):

    python -m actor_critic_tpu_torch.train --preset a2c_cartpole
    python -m actor_critic_tpu_torch.train --preset ppo_cartpole --set lr=1e-4 --iterations 200
    python -m actor_critic_tpu_torch.train --algo a2c --env jax:pendulum --set num_envs=16
    python -m actor_critic_tpu_torch.train --preset impala_pong --ckpt-dir runs/pong --resume
    python -m actor_critic_tpu_torch.train --preset a2c_cartpole --chunk 4
    python -m actor_critic_tpu_torch.train --algo sac --env jax:pendulum
    python -m actor_critic_tpu_torch.train --preset td3_walker2d --env jax:pendulum \
        --replay-dtype mixed
    python -m actor_critic_tpu_torch.train --preset impala_pong --update-dtype bf16
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
checkpoint); `--replay-dtype fp32|mixed|int8` (the off-policy trainers'
ring codecs, `replay/quantize.py`; the same as `--set replay_dtype=...`,
refused for an algorithm with no ring); `--update-dtype fp32|bf16` (the
networks' compute precision, the same as `--set bf16_compute=...`: bf16
matmuls, convolutions and activations with float32 master parameters,
optimizer state and loss reductions, on every path, the served policy
of `--serve-port` included; the host path's numpy mirrors act in
float32, as JAX's do). `--device cpu` runs on the CPU;
by default the run is on the card, where each iteration after the first
two is a CUDA-graph replay
(`algos/loop.py`) and each eval a replay of captured blocks
(`algos/common.py::BlockedEval`).

A mixture env's eval rows add the per-type eval matrix
(`eval_return_<member>`), the fleet's share of each type
(`fleet_share_<member>`) and the stage its state carries (`fleet_stage`),
both read from the device, and with a curriculum `curriculum_stage`.
Every eval starts the eval generator from `seed + 1`, as the JAX CLI
evaluates with one fixed key, so a resumed run evaluates as the straight
one. Each row's `wall_s` leaves the evals out.

The host env path: `--env host:<gym id>` steps a gymnasium (MuJoCo) pool
in numpy on the host, `--env native:<id>` the C++ engine's batch
(CartPole-v1, Pendulum-v1, MountainCarContinuous-v0, Acrobot-v1; built with
g++ at first use into `build/native/`), and the device learns from one
uploaded [K, E] block an iteration, the update replayed as one CUDA graph
on the card (`algos/host_loop.py`). PPO, DDPG/TD3 and SAC have host
trainers, so the four MuJoCo presets run as they are
(`--preset ppo_halfcheetah`, `ddpg_walker2d`, `td3_walker2d`,
`sac_humanoid`), or on a stated env (`--preset sac_humanoid --env
native:Pendulum-v1`, `--env jax:pendulum`): a preset keeps its config when
only the env changes. On-policy pools normalize obs and reward, off-policy
pools neither. Their flags: `--eval-envs`, `--eval-steps` (the frozen-stats
eval pool), `--no-overlap` (act on the device every env step instead of
through the numpy mirror with parameters one update stale) and
`--no-save-replay` (checkpoints without the ring).

The async actor-learner (`--async-actors A`, on a host or native env with
PPO, DDPG/TD3 or SAC): A actor threads, each with its own pool of
num_envs / A envs, collect through the numpy mirrors and push blocks into
a bounded queue, and the learner takes them as they come, each update one
CUDA graph on the card (`algos/traj_queue.py`, `ppo.train_host_async`,
`host_loop.off_policy_train_host_async`); `--iterations` counts consumed
blocks. Its flags: `--updates-per-block`, `--max-staleness`,
`--queue-depth`, `--async-correction vtrace|none` (PPO) and
`--data-plane host|device` with `--data-plane-codec fp32|f16|int8` (the
device ring of `data_plane/`). PPO's async runs checkpoint and resume
(every actor pool's stats, and the ring's on the device plane).
`--serve-port P` (with `--async-actors`) serves the learner while it
trains: a policy-serving gateway (`serving/`) on port P (0 = OS-assigned,
printed) whose 'learner' policy registers at version 0 with every act
bucket (`--serve-buckets`) captured before training starts, and is
hot-swapped to version it + 1 at block it's publish and to blocks + 1
with the final parameters; `python -m actor_critic_tpu_torch.serve`
serves checkpoints on their own.

Telemetry (`telemetry/`, JAX's flags): `--telemetry-dir DIR` writes
`spans.jsonl` (Chrome-trace phase spans), `resources.jsonl` (RSS, the
card's live and peak bytes, the recompile counter, which counts CUDA-graph
captures and kernel builds, and the registered gauges, every
`--telemetry-sample-s` seconds) and `events.jsonl` (health, lifecycle and
`compile` events) there, with the crash flight recorder's ring beside
them; `scripts/run_report.py DIR` renders them. `--telemetry-port P`
(with `--telemetry-dir`; 0 = OS-assigned, printed) serves `/metrics`,
`/healthz` and `/profile?iters=N` (a `torch.profiler` window of the next N
dispatches) on `--telemetry-bind` (loopback only); SIGUSR2 also arms a
window. `--stall-timeout S` arms the stall watchdog: no progress for S
seconds exits 42 with a diagnosis naming the open span, for a retry loop
that resumes; with `--chunk` and `--ckpt-dir` the loop ratchets the
timeout up to 3 x each clean chunk's wall and keeps the wall in
`chunk_wall.json`.

The warm-up and the build cache (`utils/compile_cache.py`, JAX's flags):
`--warmup` (the default; `--no-warmup` turns it off) plans the run's
registered entries as soon as the preset is resolved (the plan is
printed), builds the kernel libraries its path launches and the C++
engine of a `native:` pool on a background thread while the pools, the
restore and the state are set up, and captures every CUDA graph of the
run (the train step, the host or async update, the eval blocks) before
its first call, with the state bitwise as it was: the loop's first
iteration is already a replay. `--compile-cache-dir DIR` is where the
libraries are built and found (`auto`, the default: the checkout's
`build/`; `none`: a fresh temporary directory, removed at exit, for a cold
start); the directory is printed.

The multi-process actor-learner (`--distributed`, with `--async-actors`
and PPO on a host or native env; `parallel/multihost.py`): this process is
one rank of a fleet. Sync mode (`--coordinator HOST:PORT --num-processes N
--process-id R`, correction vtrace) joins the ranks' process group (NCCL on
the card, one card a rank; gloo with `--device cpu`) and runs the
data-parallel V-trace update, its all-reduces inside the update's CUDA
graph, with a per-block consistency check of the version counter and the
parameters' fingerprint (rows add `version_sum`, `version_ok`,
`fingerprint_ok`). `--gossip` runs independent learners that mix
parameters with a ring-scheduled peer through `--mailbox-dir` every
`--gossip-every` blocks at `--gossip-weight` (rows add `gossip_peer`,
`gossip_lag`). Every rank writes its own `--metrics` (`<root>.host<R><ext>`)
and `--telemetry-dir` (`<dir>/host<R>/`), and its trace lane is
`host<R>`. `python -m actor_critic_tpu_torch.parallel.launch` spawns a
local fleet.

`--workers W` shards a `host:<gym id>` pool's envs over W worker processes
(`envs/shard_pool.py`; with `--async-actors A` each actor's pool takes
W // A), with the trajectories of `--workers 1`; a fused env ignores it,
`native:` refuses it.
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

from actor_critic_tpu_torch import resolve_device, telemetry
from actor_critic_tpu_torch.algos import a2c, ddpg, impala, ppo, sac
from actor_critic_tpu_torch.algos.loop import fused_train_loop
from actor_critic_tpu_torch.config import (
    PRESETS,
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
from actor_critic_tpu_torch.envs.host_pool import HostEnvPool
from actor_critic_tpu_torch.telemetry import sampler
from actor_critic_tpu_torch.utils import compile_cache
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
ALGOS = {"a2c": a2c, "ppo": ppo, "ddpg": ddpg, "td3": ddpg, "sac": sac,
         "impala": impala, "a3c": impala}
# The JAX CLI's flags whose paths are not ported yet, with the ROADMAP
# Queue 1 item each belongs to: none is left.
UNPORTED_FLAGS: dict[str, str] = {}


def env_name(spec: str) -> str:
    """A `jax:` spec's maker name; the presets' bare names are the same."""
    return spec.removeprefix("jax:")


def make_env(spec: str, env_kwargs: dict, scale_actions=None) -> TorchEnv:
    """The env `spec` names: `jax:<name>` or `<name>` for a maker of `ENVS`,
    or `mixture:<members>` (the member list, with optional draw weights).
    `scale_actions` (the tri-state CLI flag) sets Pendulum's action
    convention. Unknown kwargs and bad values exit with the maker's valid
    keywords. `host:` and `native:` specs are pools (`make_host_pool`)."""
    kind, sep, name = spec.partition(":")
    env_kwargs = dict(env_kwargs)
    if is_host_spec(spec):
        raise ValueError(f"{spec!r} is a host pool: make_host_pool builds it")
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


def is_host_spec(spec: str) -> bool:
    """Whether `spec` names a host pool (`host:<gym id>`, `native:<id>`)."""
    return spec.startswith(("host:", "native:"))


def make_host_pool(spec: str, algo: str, cfg, seed: int, scale_actions=None,
                   env_kwargs=None, workers: int = 1) -> HostEnvPool:
    """The pool `spec` names (the JAX CLI's `build_env`, host branch):
    `host:<gym id>` a gymnasium pool, `native:<id>` the C++ engine's. An
    on-policy trainer (PPO) gets obs and reward normalization; the
    off-policy ones neither, since the pool normalizes with running stats
    and replayed transitions would be scaled differently as they drift,
    and TD targets want the raw reward scale. Host pools clip actions
    unless `scale_actions`. `env_kwargs` go to gym.make; the native engine
    takes none. `workers > 1` shards a gym pool over that many processes."""
    kind, _, name = spec.partition(":")
    env_kwargs = dict(env_kwargs or {})
    if kind == "native" and env_kwargs:
        raise SystemExit(f"--env-set is not supported for native:{name} (the C++ engine "
                         "replicates gymnasium defaults exactly)")
    if kind == "native" and workers > 1:
        raise SystemExit("--workers applies to host:<id> pools only (the native engine "
                         "already steps the whole batch in one C call)")
    on_policy = algo == "ppo"
    try:
        return HostEnvPool(
            name, num_envs=cfg.num_envs, seed=seed, normalize_obs=on_policy,
            normalize_reward=on_policy, backend="gym" if kind == "host" else "native",
            scale_actions=bool(scale_actions), env_kwargs=env_kwargs, workers=workers)
    except TypeError as e:
        # gym.make raises TypeError on unknown constructor kwargs.
        if env_kwargs and "keyword" in str(e):
            raise SystemExit(f"bad --env-set for {spec}: {e}") from e
        raise
    except ValueError as e:
        raise SystemExit(f"bad env {spec!r}: {e}") from e


def effective_scale_actions(env_spec: str, scale_actions, env_kwargs=None):
    """The action convention the env will use (the JAX CLI's rule):
    Pendulum scales unless told otherwise, the CLI flag first, then an
    `--env-set scale_actions=...`; host pools clip unless the flag says
    scale; None for envs with no such choice."""
    if is_host_spec(env_spec):
        return bool(scale_actions)
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


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", help="named preset (see --list-presets)")
    p.add_argument("--algo", help="a2c|ppo|ddpg|td3|sac|impala|a3c")
    p.add_argument("--env", help="jax:<name>, mixture:<members>, host:<gym id> or native:<id>")
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
    p.add_argument("--eval-envs", type=int, default=4,
                   help="host trainers: env count of the frozen-stats eval pool")
    p.add_argument("--eval-steps", type=int, default=1000,
                   help="host trainers: max steps per eval sweep (first episode only)")
    p.add_argument("--no-overlap", action="store_true",
                   help="host trainers: act on the device every env step instead of through "
                   "the numpy mirror with parameters one update stale (the A/B baseline)")
    p.add_argument("--no-save-replay", action="store_true",
                   help="host off-policy trainers: checkpoints leave the replay ring out (a "
                   "resumed run refills an empty ring); the codecs' stats are kept")
    p.add_argument(
        "--update-dtype", choices=("fp32", "bf16"), default=None,
        help="the networks' compute precision: 'bf16' runs the torso and head matmuls, "
        "convolutions and activations in bfloat16, with parameters, optimizer state and "
        "every loss reduction kept float32 (the heads cast their outputs up before the "
        "loss); default fp32. The same as --set bf16_compute=true")
    p.add_argument("--quiet", action="store_true", help="no stdout metric echo")
    p.add_argument(
        "--scale-actions", action=argparse.BooleanOptionalAction, default=None,
        help="continuous envs: map policy actions from [-1,1] onto the env's bounds "
        "instead of clipping (default: the env's own convention; jax:pendulum scales)")
    p.add_argument(
        "--compile-cache-dir", default="auto", metavar="DIR",
        help="the build cache (utils/compile_cache.py): where the CUDA kernel libraries and the "
        "native env engine are built and found, each named by a hash of its sources and flags. "
        "'auto' (default) is the checkout's build/, shared by every run; 'none' builds into a "
        "fresh temporary directory removed at exit (a cold start)")
    p.add_argument(
        "--warmup", action=argparse.BooleanOptionalAction, default=True,
        help="warm up every registered entry point of the run before its first call "
        "(utils/compile_cache.py): the kernel and engine builds on a background thread while "
        "the pools, the restore and the state are set up, then each CUDA graph's eager warm-up "
        "(the state put back bitwise) and capture, so the first iteration is already a replay")
    p.add_argument("--ckpt-dir", help="checkpoint directory")
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--resume", action="store_true", help="resume from --ckpt-dir")
    p.add_argument(
        "--replay-dtype", choices=("fp32", "mixed", "int8"), default=None,
        help="off-policy algos (ddpg/td3/sac): the replay ring's storage codecs "
        "(replay/quantize.py): 'mixed' stores obs and rewards as int8 behind running "
        "mean/scale standardization with fp32 actions, 'int8' also the bounded "
        "actions; default fp32. The same as --set replay_dtype=...; never change it "
        "on a resumed run")
    p.add_argument(
        "--workers", type=int, default=1,
        help="host pools: worker processes the env batch shards across "
        "(envs/shard_pool.py; shared-memory step exchange, per-shard seeding identical to "
        "the in-process pool). 1 = in-process SyncVectorEnv")
    p.add_argument(
        "--async-actors", type=int, default=0, metavar="A",
        help="host trainers (ppo/ddpg/td3/sac): decouple collection from the learner "
        "(algos/traj_queue.py): A actor threads each drive their own pool of num_envs/A "
        "envs and push [K, E/A] blocks into a bounded queue; the learner takes them as they "
        "come (PPO corrects the behaviour staleness per --async-correction). 0 (default) = "
        "the lockstep host loop")
    p.add_argument(
        "--updates-per-block", type=int, default=1, metavar="M",
        help="async PPO: updates (epoch/minibatch passes) the learner takes from each "
        "consumed block (IMPACT-style reuse)")
    p.add_argument(
        "--max-staleness", type=int, default=None, metavar="S",
        help="async mode: drop blocks whose behaviour version lags the learner by more than "
        "S when consumed; -1 = unbounded. Default: 8 for PPO, unbounded for ddpg/td3/sac "
        "(replay absorbs staleness)")
    p.add_argument(
        "--queue-depth", type=int, default=4, metavar="D",
        help="async mode: queue capacity in blocks (a full queue recycles its oldest "
        "pending block's slot)")
    p.add_argument(
        "--async-correction", choices=("vtrace", "none"), default="vtrace",
        help="async PPO: the staleness correction: 'vtrace' (clipped importance-weighted "
        "targets under the learner's parameters, the V-trace kernel on the card) or 'none' "
        "(GAE under the recorded behaviour values, A3C-style)")
    p.add_argument(
        "--data-plane", choices=("host", "device"), default="host",
        help="async mode: where blocks wait between actor and learner (data_plane/): "
        "'host' (a numpy queue; the learner copies each consumed block to the card) or "
        "'device' (actors enqueue encoded blocks into a ring on the card; the learner's "
        "update gathers and decodes its slot). Never change it on a resumed run")
    p.add_argument(
        "--data-plane-codec", choices=("fp32", "f16", "int8"), default="fp32",
        help="device data plane: the per-key block codec (data_plane/codecs.py): fp32 = "
        "raw (bitwise the host plane), f16 halves the observation bytes, int8 "
        "standardizes obs and rewards to calibrated int8 and packs the flags; actions, "
        "log-probs and values always stay raw")
    p.add_argument(
        "--distributed", action="store_true",
        help="multi-process learner (parallel/multihost.py): this process is one rank of a "
        "fleet: its actor fleet (--async-actors, host PPO only) feeds a local queue and the "
        "learner all-reduces each minibatch's gradients across the ranks' process group (NCCL "
        "on the card, one card a rank; gloo with --device cpu), or gossips parameters with "
        "--gossip. Requires --coordinator + --num-processes + --process-id (or --gossip with a "
        "shared --mailbox-dir). For a local fleet use python -m "
        "actor_critic_tpu_torch.parallel.launch")
    p.add_argument(
        "--coordinator", metavar="HOST:PORT", default="",
        help="the process group's coordinator address (rank 0's host, any free port). Needed "
        "for the sync all-reduce mode; optional under --gossip (peer-to-peer exchange never "
        "enters a collective)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="fleet size under --distributed")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's rank under --distributed")
    p.add_argument(
        "--gossip", action="store_true",
        help="distributed mode: exchange parameters peer-to-peer on a rotating ring schedule "
        "(no global barrier: a straggler degrades fleet throughput instead of stalling it) "
        "instead of the synchronous all-reduce learner")
    p.add_argument("--gossip-every", type=int, default=1, metavar="N",
                   help="consumed blocks between gossip exchanges")
    p.add_argument("--gossip-weight", type=float, default=0.5, metavar="W",
                   help="peer mixing weight in [0, 1]: params <- (1-W) own + W peer")
    p.add_argument("--mailbox-dir", default="",
                   help="shared directory for the gossip param mailbox (required for --gossip "
                   "with more than one process)")
    p.add_argument(
        "--serve-port", type=int, default=None, metavar="PORT",
        help="async mode: serve-while-training — bind a policy-serving gateway (serving/) on "
        "PORT (0 = OS-assigned, printed) whose 'learner' policy hot-swaps to every published "
        "learner snapshot: /v1/act answers with the current training params, version = "
        "blocks consumed + 1; the final parameters install as version blocks + 1")
    p.add_argument(
        "--serve-buckets", default="1,4,16", metavar="B,B,..",
        help="--serve-port: act bucket sizes of the gateway, each one CUDA graph on the card "
        "(default 1,4,16; captured before training starts)")
    p.add_argument(
        "--telemetry-dir",
        help="run telemetry: write spans.jsonl (Chrome-trace phase events; render with "
        "scripts/run_report.py --trace or open in Perfetto), resources.jsonl (RSS, the card's "
        "memory, recompiles: CUDA-graph captures and kernel builds) and events.jsonl (health, "
        "lifecycle and compile events) under this directory. Phase instrumentation is always "
        "on and near-free; this flag only adds the file sinks and the resource sampler thread")
    p.add_argument(
        "--telemetry-port", type=int, default=None, metavar="PORT",
        help="live run introspection: serve GET /metrics (Prometheus text), /healthz "
        "(watchdog staleness and open span; 503 when stalled) and /profile?iters=N (arm an "
        "on-demand torch.profiler window) on --telemetry-bind:PORT from a daemon thread. 0 "
        "picks an ephemeral port (printed at startup). Requires --telemetry-dir (profile "
        "windows land there). SIGUSR2 also arms a window")
    p.add_argument(
        "--telemetry-bind", default="127.0.0.1", metavar="HOST",
        help="bind address for the --telemetry-port exporter (default 127.0.0.1). "
        "Non-loopback binds expose unauthenticated run internals, so they are refused unless "
        "--distributed (where the fleet aggregator scrapes peers over the network)")
    p.add_argument(
        "--telemetry-sample-s", type=float, default=5.0, metavar="SECS",
        help="cadence of the telemetry resource sampler thread (resources.jsonl rows; "
        "default 5 s). Only meaningful with --telemetry-dir")
    p.add_argument(
        "--stall-timeout", type=float, default=0,
        help="seconds without training progress before the process exits 42 (device presumed "
        "wedged) so a retry loop can --resume; 0 = off. Pair with --ckpt-dir/--save-every")
    p.add_argument("--list-presets", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.telemetry_port is not None and not args.telemetry_dir:
        raise SystemExit(
            "--telemetry-port requires --telemetry-dir (the exporter serves the session's "
            "sinks and /profile captures land in that directory)")
    if args.telemetry_sample_s <= 0:
        raise SystemExit("--telemetry-sample-s must be > 0")
    from actor_critic_tpu_torch.telemetry.exporter import validate_bind

    try:
        validate_bind(args.telemetry_bind, distributed=args.distributed)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return args


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


def steps_per_iteration(algo: str, cfg) -> int:
    """Env steps an iteration takes: T·E on-policy, K·E off-policy."""
    if hasattr(cfg, "rollout_steps"):
        return cfg.rollout_steps * cfg.num_envs
    return cfg.steps_per_iter * cfg.num_envs


def run_fused(env: TorchEnv, preset, args: argparse.Namespace, logger: JsonlLogger,
              device: torch.device) -> dict:
    """Train `preset` on `env` through `fused_train_loop`, with the evals,
    the curriculum and the checkpoints the flags ask for; returns the last
    metrics."""
    mod, cfg = ALGOS[preset.algo], preset.config
    steps_per_iter = steps_per_iteration(preset.algo, cfg)
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
    module = mod.__name__.rpartition(".")[2]
    if eval_fn is not None:
        compile_cache.capture_part(f"{module}.make_eval_fn", lambda: eval_fn.warm(state, eval_gen))
    if typed_eval is not None:
        compile_cache.capture_part("mixture.make_typed_eval",
                                   lambda: typed_eval.warm(state, eval_gen))
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
            with telemetry.span("eval", it=it):
                eval_gen.manual_seed(args.seed + 1)
                row["eval_return"] = float(eval_fn(state, eval_gen))
                if typed_eval is not None:
                    for t, name in enumerate(env.member_names):
                        r = float(typed_eval(state, eval_gen, type_ids[t]))
                        row[f"eval_return_{name}"] = round(r, 3)
                        eval_matrix.update(mixture.eval_matrix_row(name, r))
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
        telemetry.observe(it, row)
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

    # The per-type eval matrix rides the sampler (resources.jsonl, /metrics).
    eval_matrix: dict[str, float] = {}
    gauge = (sampler.register_gauge("mixture_eval", lambda: dict(eval_matrix))
             if typed_eval is not None else None)
    try:
        _, metrics = fused_train_loop(
            mod.make_train_step, mod.init_state, env, cfg, args.iterations,
            seed=args.seed, device=device, state=state,
            log_every=args.log_every, log_fn=log_fn, eval_every=args.eval_every,
            capturable=mod.CAPTURABLE,
            state_hook=install_weights if curriculum is not None else None,
            chunk=args.chunk, ckpt=ckpt, save_every=args.save_every, resume=args.resume,
        )
    finally:
        if gauge is not None:
            sampler.unregister_gauge(gauge)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {**metrics, "wall_s": time.perf_counter() - t0 - eval_s}


def run_host(pool: HostEnvPool, preset, args: argparse.Namespace, logger: JsonlLogger,
             device: torch.device) -> dict:
    """Train `preset` on the host pool through its host trainer
    (`ppo.train_host`, `ddpg.train_host`, `sac.train_host`), with the
    evals and the checkpoints the flags ask for; returns the last metrics.
    Each row's `wall_s` leaves the evals out."""
    trainers = {"ppo": ppo, "ddpg": ddpg, "td3": ddpg, "sac": sac}
    if preset.algo not in trainers:
        raise SystemExit(f"{preset.algo} has no host trainer (the fused trainer needs a pure "
                         "env); pick env jax:<name>")
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and args.resume and ckpt.latest_step() is not None:
        print(f"resumed from iteration {ckpt.latest_step()}", flush=True)
    last: dict = {}
    t0 = time.perf_counter()
    eval_s = 0.0

    def log_fn(it: int, metrics: dict) -> None:
        nonlocal eval_s
        eval_s += metrics.get("eval_s", 0.0)
        row = {**metrics, "wall_s": time.perf_counter() - t0 - eval_s}
        telemetry.observe(it, row)
        last.clear()
        last.update(row)
        logger.log(it, row)

    kwargs = dict(
        num_iterations=args.iterations, seed=args.seed, log_every=args.log_every,
        log_fn=log_fn, eval_every=args.eval_every, eval_envs=args.eval_envs,
        eval_steps=args.eval_steps, ckpt=ckpt, save_every=args.save_every,
        resume=args.resume, overlap=not args.no_overlap, device=device)
    if preset.algo != "ppo":
        kwargs["save_replay"] = not args.no_save_replay
    trainers[preset.algo].train_host(pool, preset.config, **kwargs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if not last and ckpt is not None:
        # The run was already complete: the metrics saved with the
        # checkpoint, without the checkpoint's own bookkeeping keys.
        last = {k: v for k, v in ckpt.restore_metrics().items() if not k.startswith("_")}
    return last


def build_actor_pools(preset, args: argparse.Namespace, actors: int) -> list[HostEnvPool]:
    """One host pool per async actor (the JAX CLI's): num_envs / A envs
    each, seeds strided by (rank·A + i)·100003 (a pool seeds its envs
    seed..seed+E, so adjacent offsets would repeat trajectories; under
    `--distributed` every rank builds its fleet from the same `--seed`, and
    without the rank's stride two ranks would replay the same trajectories),
    PPO's pools normalizing obs and reward, the off-policy ones neither."""
    kind, _, name = preset.env.partition(":")
    if not is_host_spec(preset.env):
        raise SystemExit(
            "--async-actors decouples HOST collection from the learner; jax:* envs fuse "
            "rollouts into the update and have nothing to decouple")
    if preset.algo not in ("ppo", "ddpg", "td3", "sac"):
        raise SystemExit(f"--async-actors drives the host trainers (ppo/ddpg/td3/sac); "
                         f"{preset.algo} has no host loop to decouple")
    cfg = preset.config
    if actors > cfg.num_envs or cfg.num_envs % actors != 0:
        raise SystemExit(
            f"num_envs={cfg.num_envs} must split evenly across --async-actors={actors} (one "
            "fixed [K, E/A] block shape keeps the learner on one update graph)")
    sub = dataclasses.replace(cfg, num_envs=cfg.num_envs // actors)
    rank = args.process_id if getattr(args, "distributed", False) else 0
    workers_each = max(1, getattr(args, "workers", 1) // actors)
    return [make_host_pool(preset.env, preset.algo, sub, args.seed + (rank * actors + i) * 100003,
                           args.scale_actions, preset.env_kwargs, workers_each)
            for i in range(actors)]


def resolve_staleness(args: argparse.Namespace, algo: str):
    """--max-staleness: S >= 0 is a bound, -1 unbounded, absent the
    algorithm's default (8 for PPO, unbounded off-policy)."""
    if args.max_staleness is None:
        return 8 if algo == "ppo" else None
    return args.max_staleness if args.max_staleness >= 0 else None


def run_host_async(pools: list[HostEnvPool], preset, args: argparse.Namespace,
                   logger: JsonlLogger, device: torch.device) -> dict:
    """Train `preset` with `len(pools)` actor threads through its async
    learner (`ppo.train_host_async`, `ddpg/sac.train_host_async`); returns
    the last metrics. `iterations` counts consumed blocks. On the CPU the
    learner's ops run on one intra-op thread: with the actor threads beside
    them, torch's thread pool oversubscribes the cores (a PPO update took
    100× longer)."""
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        return _run_host_async(pools, preset, args, logger, device)
    finally:
        torch.set_num_threads(threads)


def start_serving_sidecar(preset, spec, args: argparse.Namespace, device: torch.device):
    """Serve-while-training: a policy-serving gateway whose one 'learner'
    policy tracks the training run. Built before training starts, so every
    act bucket is captured (one CUDA graph each on the card) while nothing
    else runs; the publish hook then only hot-swaps parameters. Versions:
    the init placeholder registers at 0, block `it`'s publish swaps to
    `it + 1`, the final parameters to blocks + 1, so /v1/act's `version` is
    strictly monotone. The gateway's flushes wait on the learner's gate
    (while an update runs eagerly or is captured: with the warm-up, once,
    before the actors start), as its actors do.
    Returns `(gateway, learner_kwargs)`: `publish_hook` and `gate` for the
    async learner; the caller closes the gateway."""
    import threading

    from actor_critic_tpu_torch import serving

    buckets = tuple(int(b) for b in args.serve_buckets.split(",") if b.strip())
    gate = threading.Event()
    gate.set()
    engine = serving.PolicyEngine(spec, preset.config, algo=preset.algo, buckets=buckets,
                                  seed=args.seed, device=device, gate=gate)
    store = serving.PolicyStore()
    template = serving.init_params(spec, preset.config, preset.algo, seed=args.seed)
    store.register("learner", engine, template, default=True)
    n_warm = engine.warm(store.get("learner").params)
    gateway = serving.ServeGateway(store, port=args.serve_port, session=telemetry.current())
    print(f"serving learner on {gateway.url} (warm: {n_warm} act buckets)", flush=True)

    def publish_hook(it: int, np_params) -> None:
        # The publisher's frozen copy; swap numguards it and uploads it into
        # tensors of the version's own.
        store.swap("learner", np_params, version=it + 1)

    return gateway, {"publish_hook": publish_hook, "gate": gate}


def _run_host_async(pools, preset, args, logger, device) -> dict:
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and args.resume and ckpt.latest_step() is not None:
        print(f"resumed from block {ckpt.latest_step()}", flush=True)
    last: dict = {}
    t0 = time.perf_counter()
    eval_s = 0.0

    def log_fn(it: int, metrics: dict) -> None:
        nonlocal eval_s
        eval_s += metrics.get("eval_s", 0.0)
        row = {**metrics, "wall_s": time.perf_counter() - t0 - eval_s}
        telemetry.observe(it, row)
        last.clear()
        last.update(row)
        logger.log(it, row)

    kwargs = dict(
        num_iterations=args.iterations, seed=args.seed, log_every=args.log_every,
        log_fn=log_fn, eval_every=args.eval_every, eval_envs=args.eval_envs,
        eval_steps=args.eval_steps, queue_depth=args.queue_depth,
        max_staleness=resolve_staleness(args, preset.algo), data_plane=args.data_plane,
        plane_codec=args.data_plane_codec, device=device)
    gateway = None
    if args.serve_port is not None:
        gateway, sidecar = start_serving_sidecar(preset, pools[0].spec, args, device)
        kwargs.update(sidecar)
    try:
        if preset.algo == "ppo":
            ppo.train_host_async(pools, preset.config, updates_per_block=args.updates_per_block,
                                 correction=args.async_correction, ckpt=ckpt,
                                 save_every=args.save_every, resume=args.resume, **kwargs)
        else:
            # Replay absorbs behaviour staleness: no correction knob, and the
            # staleness bound is off unless asked for.
            ALGOS[preset.algo].train_host_async(pools, preset.config, **kwargs)
    finally:
        if gateway is not None:
            gateway.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if not last and ckpt is not None:
        last = {k: v for k, v in ckpt.restore_metrics().items() if not k.startswith("_")}
    return last


def run_multihost(pools: list[HostEnvPool], preset, args: argparse.Namespace,
                  logger: JsonlLogger, device: torch.device) -> dict:
    """One rank of the multi-process actor-learner (JAX's `run_multihost`):
    the local actor fleet feeds the local queue; the learner joins the
    fleet's all-reduce (sync) or gossips parameters (`--gossip`). Returns
    the last row with the run's summary as `multihost_<key>` entries. On
    the CPU the learner's ops run on one intra-op thread, as
    `run_host_async`'s, under a 0.1 ms GIL switch interval: at the default
    5 ms every learner op and gloo collective waits up to that long for an
    actor's numpy loop (three blocks took minutes)."""
    from actor_critic_tpu_torch.parallel import multihost

    rank = args.process_id
    multihost.host_lane(rank)
    last: dict = {}
    t0 = time.perf_counter()

    def log_fn(it: int, metrics: dict) -> None:
        row = {**metrics, "wall_s": time.perf_counter() - t0}
        telemetry.observe(it, row)
        last.clear()
        last.update(row)
        logger.log(it, row)

    threads, interval = torch.get_num_threads(), sys.getswitchinterval()
    if device.type == "cpu":
        torch.set_num_threads(1)
        sys.setswitchinterval(1e-4)
    try:
        _, _, summary = multihost.train_multihost(
            pools, preset.config, args.iterations, rank=rank, world=args.num_processes,
            mode="gossip" if args.gossip else "sync", seed=args.seed, log_every=args.log_every,
            log_fn=log_fn, queue_depth=args.queue_depth,
            max_staleness=resolve_staleness(args, "ppo"),
            updates_per_block=args.updates_per_block, correction=args.async_correction,
            gossip=multihost.GossipConfig(every=args.gossip_every, weight=args.gossip_weight),
            mailbox_dir=args.mailbox_dir or None, device=device)
    finally:
        torch.set_num_threads(threads)
        sys.setswitchinterval(interval)
    last.update({f"multihost_{k}": v for k, v in summary.items()
                 if isinstance(v, (int, float, bool))})
    return last


def check_distributed_flags(args: argparse.Namespace, algo: str) -> None:
    """The JAX CLI's refusals of `--distributed`, in JAX's words (the
    data-plane and sidecar ones name the port's own tools), before the
    coordinator handshake and any env or device work: a misconfigured fleet
    member waiting in the process group's rendezvous is far worse than an
    exit."""
    if not args.distributed:
        return
    if args.data_plane == "device":
        raise SystemExit(
            "--data-plane device is single-host for now: the --distributed learners stage "
            "their blocks from the host queue — drop --distributed or use --data-plane host")
    if args.serve_port is not None:
        raise SystemExit(
            "--serve-port is single-host (the resident gateway swaps from THIS process's "
            "publish hook); a fleet serves through python -m actor_critic_tpu_torch.serve "
            "--distributed + python -m actor_critic_tpu_torch.serve_fleet instead")
    if args.async_actors <= 0:
        raise SystemExit(
            "--distributed drives the async actor–learner stack: each host runs its own actor "
            "fleet — pass --async-actors N (host PPO)")
    if algo != "ppo":
        raise SystemExit(
            "--distributed drives the PPO multi-host learner (parallel/multihost.py); the "
            "off-policy async drivers are single-host — drop --distributed or use --algo ppo")
    if not args.gossip and not args.coordinator:
        raise SystemExit(
            "--distributed sync mode needs --coordinator HOST:PORT (+ --num-processes/"
            "--process-id); or pass --gossip for the peer-to-peer mode")
    if not args.gossip and args.async_correction != "vtrace":
        raise SystemExit(
            "--distributed sync mode shard_maps the V-trace-corrected update; "
            "--async-correction none is not supported there (gossip mode and single-host async "
            "accept it)")
    if args.gossip and args.num_processes > 1 and not args.mailbox_dir:
        raise SystemExit("--gossip with more than one host needs a shared --mailbox-dir")
    if args.ckpt_dir or args.resume:
        raise SystemExit(
            "--async-actors checkpointing is wired for single-host PPO only (the save tree "
            "carries every actor pool's normalizer state — ppo.train_host_async); off-policy "
            "async and --distributed runs don't support --ckpt-dir/--resume yet")


def rank_paths(args: argparse.Namespace) -> None:
    """Every rank of a fleet runs the same command line: its `--metrics`
    becomes `<root>.host<rank><ext>` and its `--telemetry-dir`
    `<dir>/host<rank>`, so N ranks never append into one file."""
    rank = args.process_id
    if args.telemetry_dir:
        args.telemetry_dir = os.path.join(args.telemetry_dir, f"host{rank}")
    root, ext = os.path.splitext(args.metrics)
    args.metrics = f"{root}.host{rank}{ext}"


def check_async_flags(args: argparse.Namespace, algo: str) -> None:
    """The JAX CLI's refusals of the async flags, before any env or device
    work."""
    if args.data_plane == "device" and args.async_actors <= 0:
        raise SystemExit(
            "--data-plane device relocates the async actor–learner hand-off onto the card — "
            "pass --async-actors N (the lockstep pipeline has no trajectory queue to relocate)")
    if args.async_actors < 0:
        raise SystemExit(f"--async-actors must be >= 0, got {args.async_actors}")
    if args.async_actors > 0:
        if (args.ckpt_dir or args.resume) and algo != "ppo":
            raise SystemExit(
                "--async-actors checkpointing is wired for PPO only (the save tree carries "
                "every actor pool's normalizer state — ppo.train_host_async); off-policy async "
                "runs don't support --ckpt-dir/--resume yet")
        if args.updates_per_block < 1:
            raise SystemExit(f"--updates-per-block must be >= 1, got {args.updates_per_block}")
        if args.queue_depth < 1:
            raise SystemExit(f"--queue-depth must be >= 1, got {args.queue_depth}")
        if args.no_overlap:
            print("--no-overlap is meaningless with --async-actors (actors always act through "
                  "the numpy mirror); ignored", flush=True)
    if args.serve_port is not None and args.async_actors <= 0:
        # Serve-while-training rides the async publish cadence: the lockstep
        # and fused paths have no PolicyPublisher to hook.
        raise SystemExit("--serve-port hooks the async learner's per-block publish "
                         "(PolicyPublisher) — pass --async-actors N")


def start_telemetry(preset, args: argparse.Namespace):
    """The `--telemetry-dir` session, installed as the current one (None
    without the flag): its exporter on `--telemetry-port` (URL printed) and
    SIGUSR2 arming a profiler window."""
    if not args.telemetry_dir:
        return None
    from actor_critic_tpu_torch.telemetry.profiler import install_sigusr2

    session = telemetry.TelemetrySession(
        args.telemetry_dir,
        run_info={"algo": preset.algo, "env": preset.env, "iterations": args.iterations,
                  "seed": args.seed, "config": dataclasses.asdict(preset.config)},
        resource_interval_s=args.telemetry_sample_s, serve_port=args.telemetry_port,
        serve_host=args.telemetry_bind)
    telemetry.set_current(session)
    if session.exporter is not None:
        print(f"telemetry exporter: {session.exporter.url}/metrics /healthz /profile?iters=N",
              flush=True)
    install_sigusr2()
    return session


def start_watchdog(args: argparse.Namespace):
    """The `--stall-timeout` watchdog, armed (None without the flag)."""
    if args.stall_timeout <= 0:
        return None
    from actor_critic_tpu_torch.utils.watchdog import StallWatchdog

    if args.chunk > 1:
        # One heartbeat per chunk: a timeout shorter than a chunk's wall
        # would read normal progress as a stall.
        print(f"watchdog with --chunk {args.chunk}: --stall-timeout {args.stall_timeout:g}s "
              "must exceed one chunk's wall time or the run will be killed mid-chunk",
              flush=True)
    return StallWatchdog(args.stall_timeout).start()


def start_warmup(preset, args: argparse.Namespace, env, device: torch.device):
    """Plan the run's warm-up (`utils/compile_cache.py`), print the plan and
    start its builds on the runner's thread; None with `--no-warmup`. `env`
    is the fused env (None for a host pool, which does not exist yet: no
    host planner needs it)."""
    if not args.warmup:
        return None
    host = env is None
    ctx = compile_cache.WarmupContext(
        algo=preset.algo, fused=not host, spec=None if host else env.spec,
        cfg=preset.config, env=env, chunk=1 if host else args.chunk,
        iterations=args.iterations, eval_every=args.eval_every, eval_envs=args.eval_envs,
        overlap=not args.no_overlap, resume=args.resume, async_actors=args.async_actors,
        async_correction=args.async_correction, data_plane=args.data_plane,
        plane_codec=args.data_plane_codec, queue_depth=args.queue_depth,
        device=device.type, native=preset.env.startswith("native:"))
    plan = compile_cache.plan_warmup(ctx)
    print(f"warmup: {len(plan)} entry point(s) building in the background, captured before "
          f"their first call: {', '.join(n for n, _ in plan)}", flush=True)
    return compile_cache.WarmupRunner(plan).start()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list_presets:
        for name, pre in PRESETS.items():
            print(f"{name:18s} {pre.algo:7s} {pre.env:40s} {pre.description}")
        return 0
    try:
        preset = resolve(args.preset, args.algo, args.env, parse_set_args(args.set),
                         env_overrides=parse_env_set_args(args.env_set))
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e)) from e
    if args.replay_dtype is not None:
        if not hasattr(preset.config, "replay_dtype"):
            raise SystemExit(
                f"--replay-dtype applies to the off-policy algos (ddpg/td3/sac) with a "
                f"replay ring on the device; {preset.algo} has no replay storage")
        preset = dataclasses.replace(
            preset, config=dataclasses.replace(preset.config, replay_dtype=args.replay_dtype))
    if args.update_dtype is not None:
        if not hasattr(preset.config, "bf16_compute"):
            raise SystemExit(
                f"--update-dtype has no effect on {preset.algo}: its config carries no "
                "bf16_compute switch")
        preset = dataclasses.replace(preset, config=dataclasses.replace(
            preset.config, bf16_compute=args.update_dtype == "bf16"))
    if args.iterations is None:
        args.iterations = preset.iterations
    if args.chunk < 1:
        raise SystemExit(f"--chunk must be >= 1, got {args.chunk}")
    if args.curriculum:
        check_curriculum(args, preset.env)
        # The weights act on type redraws; an explicit
        # --env-set redraw_types=false wins.
        preset.env_kwargs.setdefault("redraw_types", True)
    check_distributed_flags(args, preset.algo)
    check_async_flags(args, preset.algo)
    if args.distributed:
        rank_paths(args)
    # Only the sync learner joins a process group: gossip ranks never enter
    # a collective (their rank is --process-id, a --coordinator is unused),
    # so they may share one card.
    grouped = args.distributed and not args.gossip
    if grouped:
        from actor_critic_tpu_torch.parallel.multihost import distributed_init

        # Before the warm-up's thread or any pool touches the card: the rank's
        # card is made current first.
        device = distributed_init(args.coordinator, args.num_processes, args.process_id,
                                  args.device)
    else:
        device = resolve_device(args.device)
    try:
        return _main(args, preset, device)
    finally:
        if grouped:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args: argparse.Namespace, preset, device: torch.device) -> int:
    print(f"algo={preset.algo} env={preset.env} iterations={args.iterations} "
          f"config={dataclasses.asdict(preset.config)} env_kwargs={preset.env_kwargs}",
          flush=True)
    host = is_host_spec(preset.env)
    fused_env = None if host else make_env(preset.env, preset.env_kwargs, args.scale_actions)
    cache_dir = compile_cache.resolve_cache_dir(args.compile_cache_dir, args.ckpt_dir)
    with compile_cache.temporary_cache(cache_dir or compile_cache.fresh_cache_dir()) as cache:
        print(f"compile cache: {cache}", flush=True)
        # The session first: the warm-up's builds and captures are its events.
        session = start_telemetry(preset, args)
        try:
            with compile_cache.running(start_warmup(preset, args, fused_env, device)):
                final = _run(preset, args, host, fused_env, device)
        finally:
            if session is not None:
                session.close()
    cfg = preset.config
    print(json.dumps({
        "algo": preset.algo,
        "env": preset.env,
        "device": str(device),
        "iterations": args.iterations,
        # Consumed env steps: an async learner's block is 1/A of an iteration's.
        "env_steps": args.iterations * steps_per_iteration(preset.algo, cfg)
        // max(args.async_actors, 1),
        **{k: finite_or_none(v) for k, v in final.items()},
    }), flush=True)
    return 0


def _run(preset, args: argparse.Namespace, host: bool, fused_env, device: torch.device) -> dict:
    """The run itself: the pools (a host run's) and the watchdog, then the
    trainer of the path; returns the last metrics."""
    pools = build_actor_pools(preset, args, args.async_actors) if args.async_actors else None
    try:
        if pools is not None:
            env = pools[0]
        elif host:
            env = make_host_pool(preset.env, preset.algo, preset.config, args.seed,
                                 args.scale_actions, preset.env_kwargs, args.workers)
        else:
            env = fused_env
            if args.workers > 1:
                print("--workers applies to host pools only; ignored for jax:* envs (their "
                      "rollouts are fused on-device)", flush=True)
        try:
            check_env_convention(args.ckpt_dir, preset.env, args.scale_actions, args.resume,
                                 env_kwargs=preset.env_kwargs)
            if args.chunk > 1 and host:
                print(f"--chunk applies to fused envs only; ignored for {preset.env}",
                      flush=True)
            elif args.chunk > 1:
                snap_cadences(args)
            watchdog = start_watchdog(args)
            try:
                with JsonlLogger(args.metrics, echo=not args.quiet) as logger:
                    if pools is not None and args.distributed:
                        final = run_multihost(pools, preset, args, logger, device)
                    elif pools is not None:
                        final = run_host_async(pools, preset, args, logger, device)
                    elif host:
                        final = run_host(env, preset, args, logger, device)
                    else:
                        final = run_fused(env, preset, args, logger, device)
            finally:
                if watchdog is not None:
                    watchdog.stop()
        finally:
            for pool in pools or ([env] if host else []):
                pool.close()
    except NotImplementedError as e:
        raise SystemExit(str(e)) from e
    return final


if __name__ == "__main__":
    sys.exit(main())
