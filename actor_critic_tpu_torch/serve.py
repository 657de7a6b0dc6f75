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
`serving.export_policy_params`. Startup: the serving side of the warm-up
registry (`utils/compile_cache.py`, entry `engine.make_act_program`) runs
every architecture's act buckets once and captures them as CUDA graphs
(`PolicyEngine.warm`, one set per `--max-inflight` lane) BEFORE the
gateway binds; `--no-warmup` skips it, and each bucket's first flush
captures instead. `--compile-cache-dir DIR` is the build cache (`auto`,
the default: the checkout's `build/`; `none`: a fresh temporary
directory), where a `native:` env's engine is built and found. `--port 0` binds an
OS-assigned port and prints the actual one. `--device cpu` serves from
the CPU (eager acts); by default the card serves, and a run without one
raises. `--backend xla`, the JAX CLI's name for it, is `--backend device`.
`--set bf16_compute=true` serves a bf16 policy: its act graphs run the
trainer's bf16 network (the `mirror` backend stays float32, as JAX's).
`--telemetry-dir DIR` attaches a telemetry session (started before the
engine, so each bucket's capture is a `compile` event): `/metrics` serves
the session's full exposition (the card's memory, the recompile count,
the serving gauge), every request's hops are spans in `DIR/spans.jsonl`
(`serve_parse`, `serve_queue_wait`, `serve_dispatch`, `serve_respond`,
`serve_request`, linked by flows), and the session's own exporter binds
an OS-assigned port on `--telemetry-bind` (loopback only, unless
`--distributed`).

The serving fleet (JAX's flags): `--distributed --mailbox-dir DIR --rank R
--world N` makes this gateway one rank of a fleet: `/healthz` adds the
fleet's membership read from the mailbox (`multihost.FleetMonitor`; 503
when a peer's last publish is older than `--stale-after-s`), the rank's
telemetry exporter is announced into the mailbox, and `/fleetz` and
`/fleetz/metrics` serve every announced rank's `/metrics` merged
(`telemetry/fleet.py`). `--sync-mailbox DIR` (with `--sync-policy`,
`--sync-rank`, `--sync-poll-s`) polls a training rank's mailbox snapshots
and hot-swaps each newer version into the policy (`MailboxPolicySyncer`:
no act graph is captured again; a torn file, a version regression or a
non-finite snapshot is dropped with the old version serving). `python -m
actor_critic_tpu_torch.serve_fleet` fronts the replicas.
"""

from __future__ import annotations

import argparse
import sys
import time

# The JAX CLI's flags whose paths are not ported yet, with the ROADMAP
# Queue 1 item each belongs to: none is left.
UNPORTED_FLAGS: dict[str, str] = {}
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
    p.add_argument(
        "--compile-cache-dir", default=None, metavar="DIR",
        help="the build cache (utils/compile_cache.py): where the native env engine (and any "
        "kernel library) is built and found; default 'auto', the checkout's build/; 'none' a "
        "fresh temporary directory (a cold start)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup bucket captures (each bucket's first flush captures)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--telemetry-dir", default=None,
                   help="attach a TelemetrySession: /metrics serves the full exporter exposition "
                   "and the serving gauge is sampled to disk")
    p.add_argument("--telemetry-bind", default="127.0.0.1", metavar="HOST",
                   help="bind address for the session's telemetry exporter (default 127.0.0.1; "
                   "non-loopback refused unless --distributed: /metrics has no auth)")
    p.add_argument(
        "--distributed", action="store_true",
        help="this gateway serves one rank of a fleet: /healthz surfaces fleet membership "
        "(rank, world, per-peer mailbox age) read from --mailbox-dir and answers 503 when a "
        "peer's last publish is older than --stale-after-s; /fleetz merges the announced "
        "ranks' /metrics")
    p.add_argument("--mailbox-dir", default=None,
                   help="the fleet's shared mailbox directory (train --mailbox-dir, the "
                   "launcher's --mailbox-dir)")
    p.add_argument("--rank", type=int, default=0, help="this rank in the fleet (default 0)")
    p.add_argument("--world", type=int, default=None,
                   help="fleet size (required with --distributed)")
    p.add_argument("--stale-after-s", type=float, default=30.0,
                   help="peer mailbox age bound before /healthz degrades to 503 (default 30)")
    p.add_argument(
        "--sync-mailbox", default=None, metavar="DIR",
        help="replica-to-replica policy propagation: poll this mailbox directory for published "
        "(version, params) snapshots and hot-swap them into --sync-policy, so version updates "
        "reach every replica without a restart. Independent of --distributed/--mailbox-dir "
        "(that one is fleet health; this one is the params feed)")
    p.add_argument("--sync-policy", default=None, metavar="ID",
                   help="--sync-mailbox: resident policy the snapshots swap into (default: the "
                   "default policy)")
    p.add_argument("--sync-rank", type=int, default=0, metavar="R",
                   help="--sync-mailbox: the publisher's mailbox rank to read (default 0)")
    p.add_argument("--sync-poll-s", type=float, default=0.25, metavar="S",
                   help="--sync-mailbox: poll interval in seconds (default 0.25)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.distributed and (args.mailbox_dir is None or args.world is None):
        raise SystemExit("--distributed wants --mailbox-dir and --world (the fleet this gateway "
                         "is a member of)")
    from actor_critic_tpu_torch.telemetry.exporter import validate_bind

    try:
        validate_bind(args.telemetry_bind, distributed=args.distributed)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    # A JAX command line that spells out its default backend serves here too.
    args.backend = BACKEND_ALIASES.get(args.backend, args.backend)
    return args


def build(args: argparse.Namespace):
    """The engine, the store with its resident policies (warmed unless
    `--no-warmup`), from the parsed flags: `(engine, store, wait_default)`."""
    from actor_critic_tpu_torch import config as config_mod
    from actor_critic_tpu_torch import resolve_device, serving
    from actor_critic_tpu_torch.utils import compile_cache

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
    runner = None
    if not args.no_warmup:
        runner = compile_cache.start_warmup(compile_cache.WarmupContext(
            algo=preset.algo, fused=False, spec=None, cfg=preset.config,
            serving_buckets=buckets, serving_sample=args.sample,
            device=args.device, native=preset.env.startswith("native:")))
    with compile_cache.running(runner):
        engine, store = _build(args, preset, buckets, policies, slo_default, slo_by_id,
                               wait_by_id, runner)
    return engine, store, wait_default


def _build(args, preset, buckets, policies, slo_default, slo_by_id, wait_by_id, runner):
    from actor_critic_tpu_torch import serving
    from actor_critic_tpu_torch.utils import compile_cache

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
    warmed: list[int] = []
    params = store.get(store.default_id).params
    if compile_cache.capture_part("engine.make_act_program",
                                  lambda: warmed.append(engine.warm(params))):
        print(f"warm: {warmed[0]} act buckets captured", flush=True)
    elif runner is None:
        print("warm: skipped (--no-warmup): each bucket captures at its first flush", flush=True)
    return engine, store


def start_session(args: argparse.Namespace):
    """The `--telemetry-dir` session (installed as the current one), or
    None."""
    if not args.telemetry_dir:
        return None
    from actor_critic_tpu_torch import telemetry

    session = telemetry.TelemetrySession(
        args.telemetry_dir,
        run_info={"mode": "serve", "algo": args.algo or args.preset, "preset": args.preset,
                  "buckets": args.buckets},
        serve_port=0, serve_host=args.telemetry_bind)
    telemetry.set_current(session)
    return session


def apply_cache_dir(args: argparse.Namespace) -> str:
    """Enable the build cache `--compile-cache-dir` resolves to (a fresh
    temporary directory for 'none') for the rest of the process; returns
    it."""
    from actor_critic_tpu_torch.utils import compile_cache

    cache_dir = compile_cache.resolve_cache_dir(args.compile_cache_dir, None)
    return compile_cache.enable_persistent_cache(cache_dir or compile_cache.fresh_cache_dir())


def start_fleet(args: argparse.Namespace, session):
    """`--distributed`: the fleet's membership monitor and metrics
    aggregator over `--mailbox-dir`, this rank's exporter announced there
    first (`(monitor, aggregator)`, or `(None, None)`)."""
    if not args.distributed:
        return None, None
    from actor_critic_tpu_torch.parallel.multihost import FleetMonitor
    from actor_critic_tpu_torch.telemetry.fleet import FleetAggregator, announce_endpoint

    monitor = FleetMonitor(args.mailbox_dir, args.rank, args.world,
                           stale_after_s=args.stale_after_s)
    if session is not None and session.exporter_port is not None:
        announce_endpoint(args.mailbox_dir, args.rank,
                          f"http://{args.telemetry_bind}:{session.exporter_port}")
    return monitor, FleetAggregator(mailbox_dir=args.mailbox_dir)


def start_syncer(args: argparse.Namespace, store):
    """`--sync-mailbox`: the policy syncer, started (None without the
    flag)."""
    if not args.sync_mailbox:
        return None
    from actor_critic_tpu_torch import serving

    sync_pid = args.sync_policy or store.default_id
    if sync_pid not in store.ids():
        raise SystemExit(f"--sync-policy {sync_pid!r} names no resident policy; resident: "
                         f"{sorted(store.ids())}")
    syncer = serving.MailboxPolicySyncer(store, sync_pid, args.sync_mailbox, rank=args.sync_rank,
                                         poll_s=args.sync_poll_s).start()
    print(f"policy sync: {sync_pid!r} <- {args.sync_mailbox} (rank {args.sync_rank}, every "
          f"{args.sync_poll_s:g}s)", flush=True)
    return syncer


class Running:
    """What `main` serves: the engine, the store, the gateway, and the
    policy syncer (None without `--sync-mailbox`)."""

    def __init__(self, engine, store, gateway, syncer):
        self.engine, self.store, self.gateway, self.syncer = engine, store, gateway, syncer

    def close(self) -> None:
        self.gateway.close()
        if self.syncer is not None:
            self.syncer.close()


def start(args: argparse.Namespace, session=None) -> Running:
    """Build and bind everything the flags ask for (`main`'s body before its
    wait): the engine and the store, the fleet's monitor and aggregator,
    the syncer, then the gateway, whose URL is printed."""
    from actor_critic_tpu_torch import serving

    engine, store, wait_default = build(args)
    monitor, aggregator = start_fleet(args, session)
    syncer = start_syncer(args, store)
    try:
        gateway = serving.ServeGateway(
            store, port=args.port, host=args.host, session=session, max_wait_us=wait_default,
            queue_limit=args.queue_limit, fleet=monitor, aggregator=aggregator,
            max_inflight=args.max_inflight, shed_burn_threshold=args.shed_burn_threshold)
    except BaseException:
        if syncer is not None:
            syncer.close()
        raise
    routes = "/v1/swap /v1/policies /metrics /healthz" + (
        " /fleetz /fleetz/metrics" if aggregator is not None else "")
    # The ACTUAL bound port: with --port 0 the OS-assigned one.
    print(f"serving gateway: {gateway.url}/v1/act (policies: {sorted(store.ids())}, "
          f"default {store.default_id!r}; also {routes})", flush=True)
    if session is not None:
        print(f"telemetry exporter: {session.exporter.url}/metrics /healthz", flush=True)
    return Running(engine, store, gateway, syncer)


def wait_for_interrupt(running: Running) -> None:
    """Serve until SIGINT (KeyboardInterrupt)."""
    while True:
        time.sleep(3600)


def main(argv=None) -> int:
    args = parse_args(argv)
    print(f"compile cache: {apply_cache_dir(args)}", flush=True)
    session = start_session(args)
    running = None
    try:
        running = start(args, session)
        wait_for_interrupt(running)
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        if running is not None:
            running.close()
        if session is not None:
            session.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
