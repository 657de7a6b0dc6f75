"""Policy-serving gateway CLI of the port (counterpart of the JAX
package's `scripts/serve.py`): micro-batched act() over HTTP, one CUDA
graph per act bucket on the card.

    # random-init PPO CartPole policy on an ephemeral port
    python -m actor_critic_tpu_torch.serve --preset ppo_cartpole --random-init --port 0

    # two resident checkpoints, hot-swappable via POST /v1/swap
    python -m actor_critic_tpu_torch.serve --algo ppo --env jax:cartpole \
        --policy champ=runs/champ --policy canary=runs/canary \
        --default champ --port 8000 --buckets 1,4,16,64 --max-wait-us 2000

Checkpoints are params-only trees written by
`serving.export_policy_params`. Startup: every architecture's act buckets
are run once and captured as CUDA graphs (`PolicyEngine.warm`, one set
per `--max-inflight` lane) BEFORE the gateway binds. `--port 0` binds an
OS-assigned port and prints the actual one. `--device cpu` serves from
the CPU (eager acts); by default the card serves, and a run without one
raises. `--backend xla`, the JAX CLI's name for it, is `--backend device`.
`--set bf16_compute=true` serves a bf16 policy: its act graphs run the
trainer's bf16 network (the `mirror` backend stays float32, as JAX's).

Not ported yet, refused with the ROADMAP item each belongs to: the
telemetry and compile-cache flags (`--telemetry-dir`, `--telemetry-bind`,
`--compile-cache-dir`, `--no-warmup`) and the fleet's (`--distributed`,
`--rank`, `--world`, the mailbox flags).
"""

from __future__ import annotations

import argparse
import sys
import time

# The JAX CLI's flags whose paths are not ported yet, with the ROADMAP
# Queue 1 item each belongs to.
UNPORTED_FLAGS = {
    "--telemetry-dir": "item 10, telemetry",
    "--telemetry-bind": "item 10, telemetry",
    "--compile-cache-dir": "item 10, the compile cache",
    "--no-warmup": "item 10, the compile cache's warm-up",
    "--distributed": "item 8, multi-GPU",
    "--rank": "item 8, multi-GPU",
    "--world": "item 8, multi-GPU",
    "--mailbox-dir": "item 8, multi-GPU",
    "--stale-after-s": "item 8, multi-GPU",
    "--sync-mailbox": "item 8, multi-GPU",
    "--sync-policy": "item 8, multi-GPU",
    "--sync-rank": "item 8, multi-GPU",
    "--sync-poll-s": "item 8, multi-GPU",
}
# The JAX CLI's backend names that the engine calls otherwise.
BACKEND_ALIASES = {"xla": "device"}


def spec_for(env: str, env_kwargs: dict):
    """EnvSpec for an env selector without building a training pool:
    `jax:<name>` reads the maker's spec; `host:<id>` and `native:<id>` build
    a 1-env pool just long enough to read the spaces."""
    from actor_critic_tpu_torch import train
    from actor_critic_tpu_torch.envs.host_pool import HostEnvPool

    if env.startswith(("host:", "native:")):
        kind, _, name = env.partition(":")
        pool = HostEnvPool(name, 1, seed=0, backend="gym" if kind == "host" else "native",
                           env_kwargs=env_kwargs if kind == "host" else None)
        try:
            return pool.spec
        finally:
            pool.close()
    if env.startswith("jax:") or ":" not in env:
        return train.make_env(env, env_kwargs).spec
    raise SystemExit(f"env must be jax:<name>, host:<gym id> or native:<id>, got {env!r}")


def parse_policies(pairs: list[str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--policy wants ID=CKPT_DIR, got {pair!r}")
        pid, path = pair.split("=", 1)
        out[pid] = path
    return out


def parse_classed(items: list[str], flag: str, unit: str):
    """`[ID=]VALUE` items: (the plain default or None, {id: value})."""
    default = None
    by_id: dict[str, float] = {}
    for item in items:
        try:
            if "=" in item:
                pid, v = item.split("=", 1)
                by_id[pid] = float(v)
            else:
                default = float(item)
        except ValueError:
            raise SystemExit(f"{flag} wants [ID=]{unit}, got {item!r}") from None
    return default, by_id


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP Queue 1 "
                     f"{UNPORTED_FLAGS[option_string]})")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", help="config preset (see train.py --list-presets)")
    p.add_argument("--algo", help="algo when not using --preset")
    p.add_argument("--env", help="env selector when not using --preset")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="config overrides (train.py --set semantics)")
    p.add_argument("--env-set", action="append", default=[], metavar="K=V",
                   help="env maker kwargs (train.py --env-set semantics)")
    p.add_argument("--policy", action="append", default=[], metavar="ID=CKPT_DIR",
                   help="resident policy from a params-only checkpoint (repeatable)")
    p.add_argument("--default", default=None, metavar="ID",
                   help="default policy id (default: first --policy / the random one)")
    p.add_argument("--random-init", action="store_true",
                   help="add a freshly-initialized 'default' policy (demo/bench)")
    p.add_argument("--port", type=int, default=8000,
                   help="gateway port; 0 binds an OS-assigned ephemeral port (default 8000)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--buckets", default="1,2,4,8,16,32,64",
                   help="act bucket sizes, comma list (default 1,2,...,64), one CUDA graph "
                   "each on the card")
    p.add_argument(
        "--max-wait-us", action="append", default=[], metavar="[ID=]US",
        help="micro-batch window: max µs the dispatcher holds a flush while rows accumulate "
        "(p99 vs occupancy knob; default 2000). Repeatable; ID=US sets a per-policy window "
        "that rides the policy handle across hot swaps")
    p.add_argument("--queue-limit", type=int, default=256,
                   help="bounded request queue capacity; overflow answers 503")
    p.add_argument(
        "--max-inflight", type=int, default=1,
        help="overlapping in-flight flushes: >1 packs flush N+1 while flush N is on the card, "
        "each flush on a lane of its own (stream, staging, graphs) (default 1)")
    p.add_argument(
        "--shed-burn-threshold", type=float, default=None,
        help="admission control: shed (503) new requests to an SLO-classed policy whose burn "
        "rate is at/over this once the queue passes half capacity (default off)")
    p.add_argument("--sample", action="store_true",
                   help="serve sampled (stochastic) actions instead of greedy (PPO only)")
    p.add_argument(
        "--backend", choices=("device", "xla", "mirror", "auto"), default="device",
        help="acting backend: 'device' (CUDA graphs on the card, eager on the CPU; 'xla', the "
        "JAX CLI's name and default, is the same), 'mirror' (MLP policies through the numpy "
        "host mirror, no device), 'auto' (measure batch-1 walls of both at startup and keep "
        "the faster)")
    p.add_argument(
        "--slo-ms", action="append", default=[], metavar="[ID=]MS",
        help="per-policy latency SLO class in ms (repeatable; plain MS applies to every policy "
        "without its own); /metrics exports slo_burn per policy")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for flag in UNPORTED_FLAGS:
        p.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    # A JAX command line that spells out its default backend serves here too.
    args.backend = BACKEND_ALIASES.get(args.backend, args.backend)
    return args


def build(args: argparse.Namespace):
    """The engine, the store with its resident policies (warmed), from the
    parsed flags: `(engine, store, wait_default)`."""
    from actor_critic_tpu_torch import config as config_mod
    from actor_critic_tpu_torch import resolve_device, serving

    slo_default, slo_by_id = parse_classed(args.slo_ms, "--slo-ms", "MS")
    # The global window feeds the batcher; per-policy ones ride handles.
    wait_default, wait_by_id = parse_classed(args.max_wait_us, "--max-wait-us", "US")
    if wait_default is None:
        wait_default = 2000.0
    if args.max_inflight < 1:
        raise SystemExit(f"--max-inflight must be >= 1, got {args.max_inflight}")
    try:
        preset = config_mod.resolve(args.preset, args.algo, args.env,
                                    config_mod.parse_set_args(args.set),
                                    config_mod.parse_env_set_args(args.env_set))
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e)) from e
    if preset.algo not in serving.engine.SUPPORTED_ALGOS:
        raise SystemExit(f"unsupported serving algo {preset.algo!r}; supported: "
                         f"{serving.engine.SUPPORTED_ALGOS}")
    buckets = tuple(int(b) for b in args.buckets.split(",") if b.strip())
    policies = parse_policies(args.policy)
    if not policies and not args.random_init:
        raise SystemExit("no policies: pass --policy ID=CKPT_DIR or --random-init")
    resident = set(policies) | ({"default"} if args.random_init else set())
    if args.default is not None and args.default not in resident:
        raise SystemExit(f"--default {args.default!r} names no policy; resident: "
                         f"{sorted(resident)}")
    if args.backend != "mirror":
        resolve_device(args.device)  # no card and no --device cpu: raise before any work
    spec = spec_for(preset.env, preset.env_kwargs)
    engine = serving.PolicyEngine(
        spec, preset.config, algo=preset.algo, buckets=buckets, sample=args.sample,
        seed=args.seed, backend=args.backend, device=args.device, lanes=args.max_inflight)
    store = serving.PolicyStore()
    template = serving.init_params(spec, preset.config, preset.algo, seed=args.seed)
    if args.backend == "auto":
        # Fix the backend from measured batch-1 walls BEFORE any policy
        # installs (prepare_params needs a concrete backend).
        choice = engine.resolve_backend(template)
        print(f"auto backend: {choice} ({engine.auto_choice})", flush=True)
    for pid, ckpt_dir in policies.items():
        params = serving.restore_policy_params(ckpt_dir, template)
        store.register(pid, engine, params, default=(pid == args.default),
                       slo_ms=slo_by_id.get(pid, slo_default), max_wait_us=wait_by_id.get(pid))
        print(f"policy {pid!r} <- {ckpt_dir}", flush=True)
    if args.random_init:
        # Without --default the FIRST registration keeps the route: the
        # random policy never steals traffic from a loaded checkpoint.
        store.register("default", engine, template, default=(args.default == "default"),
                       slo_ms=slo_by_id.get("default", slo_default),
                       max_wait_us=wait_by_id.get("default"))
        print("policy 'default' <- random init", flush=True)
    for flag, by_id in (("--slo-ms", slo_by_id), ("--max-wait-us", wait_by_id)):
        unknown = set(by_id) - set(store.ids())
        if unknown:
            raise SystemExit(f"{flag} names no resident policy: {sorted(unknown)}")
    n_warm = engine.warm(store.get(store.default_id).params)
    print(f"warm: {n_warm} act buckets captured", flush=True)
    return engine, store, wait_default


def main(argv=None) -> int:
    from actor_critic_tpu_torch import serving

    args = parse_args(argv)
    engine, store, wait_default = build(args)
    gateway = serving.ServeGateway(
        store, port=args.port, host=args.host, max_wait_us=wait_default,
        queue_limit=args.queue_limit, max_inflight=args.max_inflight,
        shed_burn_threshold=args.shed_burn_threshold)
    # The ACTUAL bound port: with --port 0 the OS-assigned one.
    print(f"serving gateway: {gateway.url}/v1/act (policies: {sorted(store.ids())}, default "
          f"{store.default_id!r}; also /v1/swap /v1/policies /metrics /healthz)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        gateway.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
