"""Fleet fronting-proxy CLI of the port (counterpart of the JAX package's
`scripts/serve_fleet.py`): N gateway replicas behind one address.

    # two replicas already serving (python -m actor_critic_tpu_torch.serve --port 8001/8002)
    python -m actor_critic_tpu_torch.serve_fleet \
        --replica http://127.0.0.1:8001 --replica http://127.0.0.1:8002 --port 8000

    # an OS-assigned port, round robin, fast health probing
    python -m actor_critic_tpu_torch.serve_fleet --replica ... --port 0 \
        --policy round_robin --health-interval 0.25

The proxy (`serving/fleet_proxy.py::FleetProxy`) relays each request to
one healthy replica (least-loaded by default) over kept-alive upstream
connections, fails over on transport errors, and evicts a replica whose
`/healthz` fails `--unhealthy-after` probes in a row (one 200 readmits
it). Application answers, a replica's 503 shed included, relay verbatim;
`GET /proxyz` serves the proxy's per-replica stats. It holds no policy
and touches no device: versions reach the replicas through the mailbox
(`serve --sync-mailbox` on each), never through here. SIGINT or SIGTERM
closes it.
"""

from __future__ import annotations

import argparse
import signal
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--replica", action="append", default=[], metavar="URL",
                   help="upstream gateway base URL, e.g. http://127.0.0.1:8001 (repeatable; at "
                   "least one required)")
    p.add_argument("--port", type=int, default=8000,
                   help="proxy port; 0 binds an OS-assigned port and prints it (default 8000)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--policy", choices=("least_loaded", "round_robin"), default="least_loaded",
                   help="replica selection: least_loaded picks the fewest in-flight relays "
                   "(default); round_robin rotates")
    p.add_argument("--health-interval", type=float, default=1.0, metavar="S",
                   help="seconds between /healthz probe rounds (default 1.0)")
    p.add_argument("--unhealthy-after", type=int, default=2, metavar="N",
                   help="consecutive failed probes before a replica is evicted (default 2); one "
                   "200 readmits it")
    p.add_argument("--timeout", type=float, default=30.0, metavar="S",
                   help="upstream relay timeout in seconds (default 30)")
    args = p.parse_args(argv)
    if not args.replica:
        raise SystemExit("no replicas: pass --replica URL at least once")

    from actor_critic_tpu_torch.serving.fleet_proxy import FleetProxy

    proxy = FleetProxy(args.replica, port=args.port, host=args.host, policy=args.policy,
                       health_interval_s=args.health_interval,
                       unhealthy_after=args.unhealthy_after, timeout_s=args.timeout)
    print(f"fleet proxy on {proxy.url} -> {len(args.replica)} replicas ({args.policy}); "
          "GET /proxyz for stats", flush=True)
    stop: list[int] = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    try:
        while not stop:
            signal.pause()
    finally:
        proxy.close()
        print("fleet proxy closed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
