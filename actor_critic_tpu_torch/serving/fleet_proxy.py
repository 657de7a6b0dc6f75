"""Serving scale-out (counterpart of `actor_critic_tpu/serving/fleet_proxy.py`):
N gateway replicas behind a small fronting proxy, and mailbox-driven
policy propagation.

`FleetProxy` is a stdlib HTTP reverse proxy for a fleet of `ServeGateway`
replicas: each request is relayed to one healthy replica over a kept-alive
upstream connection (one per handler thread, so the measured hop is the
relay, not TCP setup) and the response streamed back verbatim. Replicas
are picked least-loaded (fewest relays in flight) or round-robin; a probe
thread polls each replica's `/healthz` and evicts one that fails
`unhealthy_after` probes in a row, and a 200 readmits it at once. A
transport failure mid-relay fails over to another healthy replica; an
application answer (a replica's 503 shed included) relays as it is, since
retrying a shed would defeat the replica's admission control. `GET
/proxyz` serves the proxy's own stats. The proxy holds no device state.

`MailboxPolicySyncer` carries `(version, params)` snapshots from a
publisher (a training rank, a canary promoter) into a replica's resident
`PolicyStore`, over the multi-process learner's filesystem mailbox
(`parallel/multihost.py`: `write_params`'s write, fsync and rename;
`read_params`' torn-file tolerance). A snapshot's leaves are the PPO
network's parameters in the port's order and layout; the syncer names them
from the resident engine's network and hands the store a flax-layout tree
(`weights.flax_tree`), so `store.swap` runs the engine's parameter
preparation and `numguard` as any swap does: a swap uploads into the
version's own tensors, which the lanes copy into the parameters their
graphs read, and no act graph is captured again. Version regressions
and torn files are dropped at the read; a non-finite snapshot is refused
with the previous version still serving.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import urlparse

from actor_critic_tpu_torch.serving.policy_store import PolicyStore

# Response headers worth relaying upstream->client (everything else is
# hop-by-hop or re-derived by _respond's Content-Length).
_RELAY_HEADERS = ("content-type", "x-trace-id")


class NoHealthyReplica(RuntimeError):
    """Every replica is evicted or failed over (proxy: HTTP 503)."""


class _Replica:
    """One upstream gateway: URL, liveness, and load/relay counters.
    All mutable fields are guarded by the owning proxy's lock except
    the probe bookkeeping (`_probe_failures`), which only the probe
    thread writes."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        parsed = urlparse(self.url)
        if not parsed.hostname or not parsed.port:
            raise ValueError(
                f"replica URL must carry host and port, got {url!r}"
            )
        self.host = parsed.hostname
        self.port = parsed.port
        self.healthy = True
        self.inflight = 0
        self.forwards = 0
        self.transport_errors = 0
        self.evictions = 0
        # Consecutive probe failures: the probe thread's alone.
        self._probe_failures = 0

    def stats(self) -> dict:
        return {
            "url": self.url,
            "healthy": self.healthy,
            "inflight": self.inflight,
            "forwards": self.forwards,
            "transport_errors": self.transport_errors,
            "evictions": self.evictions,
        }


class _ProxyHandler(BaseHTTPRequestHandler):
    # The gateway handler's socket discipline: keep-alive, Nagle off, a
    # fully buffered writer.
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    wbufsize = -1

    def log_message(self, *args) -> None:
        pass  # per-request noise stays out of the run's logs

    def _respond(
        self, status: int, payload: bytes,
        content_type: str = "application/json",
        headers: Optional[dict] = None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(payload)

    def _relay(self, method: str) -> None:
        proxy = self.server.proxy  # type: ignore[attr-defined]
        path = self.path
        try:
            if method == "GET" and urlparse(path).path == "/proxyz":
                self._respond(
                    200, (json.dumps(proxy.stats()) + "\n").encode()
                )
                return
            body = b""
            length = int(self.headers.get("Content-Length", 0))
            if length:
                body = self.rfile.read(length)
            fwd_headers = {"Content-Type": "application/json"}
            trace = self.headers.get("x-trace-id")
            if trace:
                fwd_headers["x-trace-id"] = trace
            status, payload, headers = proxy.forward(
                method, path, body, fwd_headers
            )
            ctype = headers.pop(
                "content-type", "application/json"
            )
            self._respond(status, payload, content_type=ctype,
                          headers=headers)
        except NoHealthyReplica as e:
            self._respond(
                503, (json.dumps({"error": str(e)}) + "\n").encode()
            )
        except Exception as e:  # the proxy must answer, never die
            try:
                self._respond(
                    502, (json.dumps({"error": str(e)[:500]}) + "\n").encode()
                )
            except Exception:
                pass

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        self._relay("GET")

    def do_POST(self) -> None:  # noqa: N802 (http.server contract)
        self._relay("POST")


class _ProxyServer(ThreadingHTTPServer):
    request_queue_size = 128  # gateway.py's backlog rationale
    daemon_threads = True


class FleetProxy:
    """Least-loaded/round-robin fronting proxy over gateway replicas
    (module docstring). `port=0` binds an ephemeral port; the actual
    one is on `self.port`/`self.url`."""

    def __init__(
        self,
        replicas: list[str],
        port: int = 0,
        host: str = "127.0.0.1",
        policy: str = "least_loaded",
        health_interval_s: float = 1.0,
        unhealthy_after: int = 2,
        timeout_s: float = 30.0,
        probe: bool = True,
    ):
        if not replicas:
            raise ValueError("FleetProxy needs at least one replica URL")
        if policy not in ("least_loaded", "round_robin"):
            raise ValueError(
                "policy must be 'least_loaded' or 'round_robin', got "
                f"{policy!r}"
            )
        self.policy = policy
        self.timeout_s = float(timeout_s)
        self.health_interval_s = float(health_interval_s)
        self.unhealthy_after = int(unhealthy_after)
        self._lock = threading.Lock()
        self._replicas = [_Replica(u) for u in replicas]
        self._rr = 0  # round-robin cursor, guarded by _lock
        self._relayed = 0
        self._failovers = 0
        # Per handler-thread upstream connection cache: {url: conn}.
        # Handler threads die with their client connection, taking
        # their upstreams along (ThreadingHTTPServer daemon threads).
        self._local = threading.local()
        self._stop = threading.Event()
        self._server = _ProxyServer((host, int(port)), _ProxyHandler)
        self._server.proxy = self  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fleet-proxy",
            daemon=True,
        )
        self._thread.start()
        self._probe_thread = None
        if probe:
            self._probe_thread = threading.Thread(
                target=self._probe_run, name="fleet-proxy-health",
                daemon=True,
            )
            self._probe_thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- selection / relay ---------------------------------------------------

    def _select(self, tried: set) -> Optional[_Replica]:
        with self._lock:
            candidates = [
                r for r in self._replicas
                if r.healthy and r.url not in tried
            ]
            if not candidates:
                return None
            if self.policy == "least_loaded":
                rep = min(candidates, key=lambda r: r.inflight)
            else:
                rep = candidates[self._rr % len(candidates)]
                self._rr += 1
            rep.inflight += 1
            return rep

    def _conn_for(self, rep: _Replica) -> http.client.HTTPConnection:
        cache = getattr(self._local, "conns", None)
        if cache is None:
            cache = self._local.conns = {}
        conn = cache.get(rep.url)
        if conn is None:
            import socket

            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.timeout_s
            )
            conn.connect()
            # Nagle off on the upstream leg too (gateway rationale).
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
            cache[rep.url] = conn
        return conn

    def _drop_conn(self, rep: _Replica) -> None:
        cache = getattr(self._local, "conns", None)
        conn = cache.pop(rep.url, None) if cache else None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def _mark_unhealthy(self, rep: _Replica) -> None:
        with self._lock:
            if rep.healthy:
                rep.healthy = False
                rep.evictions += 1

    def forward(
        self, method: str, path: str, body: bytes, headers: dict
    ) -> tuple[int, bytes, dict]:
        """Relay one request to a healthy replica; `(status, payload,
        relay-headers)`. Transport failures evict the replica and fail
        over (at most once per replica); raises NoHealthyReplica when
        the fleet is exhausted."""
        tried: set = set()
        while True:
            rep = self._select(tried)
            if rep is None:
                raise NoHealthyReplica(
                    f"no healthy replica for {method} {path} "
                    f"(tried {len(tried)}/{len(self._replicas)})"
                )
            tried.add(rep.url)
            try:
                conn = self._conn_for(rep)
                conn.request(method, path, body=body or None,
                             headers=headers)
                resp = conn.getresponse()
                payload = resp.read()  # drain for keep-alive reuse
                out_headers = {
                    k: v for k, v in resp.getheaders()
                    if k.lower() in _RELAY_HEADERS
                }
                if resp.will_close:
                    self._drop_conn(rep)
                with self._lock:
                    rep.forwards += 1
                    self._relayed += 1
                return resp.status, payload, out_headers
            except (OSError, http.client.HTTPException):
                # Transport-level failure: this replica is gone from
                # this hop's point of view — evict now (the probe
                # readmits it when /healthz answers again) and fail
                # over. Application errors never reach this branch.
                self._drop_conn(rep)
                self._mark_unhealthy(rep)
                with self._lock:
                    rep.transport_errors += 1
                    self._failovers += 1
            finally:
                with self._lock:
                    rep.inflight -= 1

    # -- health probing ------------------------------------------------------

    def probe_once(self) -> None:
        """One /healthz sweep over every replica (factored off the
        thread loop so tests can drive eviction/readmission without
        wall-clock waits). A 200 readmits immediately; anything else —
        including a refused connect — counts toward the consecutive-
        failure eviction bound."""
        for rep in self._replicas:
            ok = False
            try:
                conn = http.client.HTTPConnection(
                    rep.host, rep.port,
                    timeout=max(self.health_interval_s, 0.2),
                )
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                resp.read()
                ok = resp.status == 200
                conn.close()
            except Exception:
                ok = False
            if ok:
                rep._probe_failures = 0
                with self._lock:
                    rep.healthy = True
            else:
                rep._probe_failures += 1
                if rep._probe_failures >= self.unhealthy_after:
                    self._mark_unhealthy(rep)

    def _probe_run(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self.health_interval_s)

    # -- introspection / lifecycle -------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy,
                "relayed": self._relayed,
                "failovers": self._failovers,
                "healthy": sum(1 for r in self._replicas if r.healthy),
                "replicas": [r.stats() for r in self._replicas],
            }

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)


class MailboxPolicySyncer:
    """Replica-side policy-version consumer over the mailbox (module
    docstring): polls the publisher rank's snapshot file and hot-swaps
    fresh versions into the local store through `store.swap` (the engine's
    `prepare_params`, `numguard`: a non-finite snapshot is refused with the
    previous version still serving). `poll_once` is factored off the
    thread loop so a test can drive the consume-and-swap logic without a
    thread.

    `template`: the parameter names of the mailbox's leaves, in order
    (default: the resident policy's engine network's `named_parameters`,
    the PPO network a training rank publishes). The leaves convert to the
    store's flax layout by `weights.flax_tree`; a custom `convert(named)`
    replaces that (a stub engine's own tree)."""

    def __init__(
        self,
        store: PolicyStore,
        policy_id: str,
        mailbox_dir: str,
        rank: int = 0,
        template: Any = None,
        poll_s: float = 0.05,
        convert: Optional[Callable[[dict], Any]] = None,
    ):
        from actor_critic_tpu_torch import weights
        from actor_critic_tpu_torch.parallel import multihost

        self._multihost = multihost
        self._store = store
        self.policy_id = str(policy_id)
        self.mailbox_dir = mailbox_dir
        self.rank = int(rank)
        if template is None:
            engine = store.get(self.policy_id).engine
            template = [name for name, _ in engine._network().named_parameters()]
        self._template = list(template)
        self._convert = convert if convert is not None else weights.flax_tree
        self._poll_s = float(poll_s)
        # Written by the sync thread's loop only (or a test's direct
        # poll_once with the thread never started); observers read the
        # ints as they are.
        # torchlint: thread-owned=mailbox (newest version this replica
        # consumed; single writer: poll_once runs on the sync thread's loop
        # only, or under fleetsan's scheduler with the thread never
        # started; swaps() reads it as a plain GIL-atomic int)
        self._seen = -1
        # torchlint: thread-owned=mailbox (the same single writer as _seen)
        self._swaps = 0
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"policy-sync-{self.policy_id}",
            daemon=True,
        )

    def start(self) -> "MailboxPolicySyncer":
        self._thread.start()
        return self

    def poll_once(self) -> bool:
        """ONE poll of the publisher's snapshot: drop absent and torn reads
        and version regressions, swap the rest into the store. True when a
        swap landed."""
        out = self._multihost.read_params(
            self.mailbox_dir, self.rank, self._template
        )
        if out is None:
            return False
        version, named = out
        if version <= self._seen:
            return False
        self._store.swap(self.policy_id, self._convert(named), version=version)
        self._seen = version
        self._swaps += 1
        return True

    @property
    def version(self) -> int:
        """Newest version this replica consumed (-1 before any)."""
        return self._seen

    @property
    def swaps(self) -> int:
        return self._swaps

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self.poll_once()
                self._stop.wait(self._poll_s)
        except BaseException as e:  # surfaced by the owner's poll
            self.error = e

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
