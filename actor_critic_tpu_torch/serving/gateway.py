"""Policy-serving HTTP gateway: micro-batched act() over stdlib HTTP
(counterpart of `actor_critic_tpu/serving/gateway.py`).

    POST /v1/act        {"obs": [[...], ...] | [...], "policy": "id"?}
                        -> {"actions": [...], "policy": id,
                            "version": n, "latency_ms": x, "trace": id}
                        One obs (shape == obs_shape) is auto-batched and
                        the reply unwrapped. 404 unknown policy, 400 bad
                        shape/JSON, 503 queue full / shed / dispatcher
                        down / timed out.
    POST /v1/swap       {"policy": id, "checkpoint": dir, "step": n?}
                        Hot-swap a resident policy from a params-only
                        checkpoint (policy_store.export_policy_params)
                        without dropping in-flight requests; 422 for a
                        non-finite checkpoint.
    GET  /v1/policies   {"policies": {id: version}, "default": id}
    GET  /metrics       Prometheus text of the serving gauge (the SLO
                        histograms as `_bucket/_sum/_count` families);
                        with a telemetry session attached, the session's
                        full exposition (`telemetry/exporter.py`: the
                        card's memory, recompiles, every gauge).
    GET  /healthz       Dispatcher liveness; 503 when the dispatcher
                        thread is dead or visibly stalled (non-empty
                        queue, no flush for `stall_after_s`). With a
                        `fleet` (`multihost.FleetMonitor`: one rank of a
                        `--distributed` fleet) the body adds the fleet's
                        membership, and a stale peer answers 503.
    GET  /fleetz        With an `aggregator` (`telemetry.fleet.
                        FleetAggregator`): every rank's scrape merged
                        into one JSON view (exact sums, merged-bucket
                        quantiles).
    GET  /fleetz/metrics  The same merge as Prometheus text.

A caller's `x-trace-id` header is kept (capped at 64 characters), else
one is minted; it is echoed as a header and in the body. The server is a
`ThreadingHTTPServer` daemon bound to 127.0.0.1 by default, with HTTP/1.1
keep-alive, so a closed-loop client's measured latency is the gateway's,
not TCP setup. `threaded=False` is the single-threaded HTTP/1.0 baseline
with a batch-1, zero-wait batcher.

With a telemetry session (`session=`, else the process's current one)
each /v1/act request emits its hops as spans, linked by one Chrome-trace
flow per trace id: `serve_parse` and `serve_request` on the handler
thread, `serve_queue_wait` and `serve_dispatch` on the dispatcher
(`batcher._emit_flush_trace`), `serve_respond` after the socket write.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from actor_critic_tpu_torch.serving.batcher import (
    DispatcherDown,
    MicroBatcher,
    Overloaded,
    QueueFull,
)
from actor_critic_tpu_torch.serving.policy_store import PolicyStore, UnknownPolicy
from actor_critic_tpu_torch.telemetry import histo as _histo
from actor_critic_tpu_torch.telemetry import sampler as _sampler
from actor_critic_tpu_torch.telemetry.exporter import _line, _metric_name
from actor_critic_tpu_torch.telemetry.session import current as _telemetry_current
from actor_critic_tpu_torch.telemetry.spans import flow_id_of
from actor_critic_tpu_torch.utils.numguard import NonFiniteError

TRACE_HEADER = "x-trace-id"
_TRACE_ID_MAX = 64  # a hostile header must not bloat every span row


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def standalone_metrics(batcher: MicroBatcher) -> str:
    """Prometheus text of the serving gauge: its numeric entries as gauges,
    its histogram snapshots as `_bucket/_sum/_count` families (one family
    per metric, per-policy label sets). JAX's metric names."""
    rows: list[str] = []
    hist_rows: dict[str, list[str]] = {}
    for key, value in sorted(batcher.gauge().items()):
        if _histo.is_snapshot(value):
            name = _metric_name("serving", value.get("metric") or key)
            hist_rows.setdefault(name, []).extend(_histo.render_prometheus(name, value))
            continue
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        name = _metric_name("serving", key)
        rows.append(f"# TYPE {name} gauge")
        rows.append(_line(name, value))
    for name in sorted(hist_rows):
        rows.append(f"# TYPE {name} histogram")
        rows.extend(hist_rows[name])
    return "\n".join(rows) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # Keep-alive needs an accurate Content-Length on every response, which
    # _respond guarantees.
    protocol_version = "HTTP/1.1"
    # Nagle + delayed ACK turn small request/response packets into ~40 ms
    # round trips on loopback.
    disable_nagle_algorithm = True
    # Status, headers and body leave as one segment.
    wbufsize = -1

    def log_message(self, *args) -> None:
        pass  # no per-request noise in the run's logs

    def _respond(self, status: int, content_type: str, payload: str,
                 headers: Optional[dict] = None) -> None:
        data = payload.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def _respond_json(self, status: int, body: dict, headers: Optional[dict] = None) -> None:
        self._respond(status, "application/json", json.dumps(body, default=str) + "\n", headers)

    def _read_body(self) -> Optional[dict]:
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b""
            body = json.loads(raw or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None
        return body if isinstance(body, dict) else None

    def do_POST(self) -> None:  # noqa: N802 (http.server contract)
        gw = self.server.gateway  # type: ignore[attr-defined]
        path = urlparse(self.path).path
        t_recv_pc = time.perf_counter()
        try:
            body = self._read_body()
            if body is None:
                self._respond_json(400, {"error": "body must be a JSON object"})
            elif path == "/v1/act":
                trace_id = (self.headers.get(TRACE_HEADER) or mint_trace_id())[:_TRACE_ID_MAX]
                status, out = gw.handle_act(body, trace_id=trace_id, t_recv_pc=t_recv_pc)
                t_resp_pc = time.perf_counter()
                self._respond_json(status, out, headers={TRACE_HEADER: trace_id})
                gw.emit_respond_span(trace_id, t_resp_pc)
            elif path == "/v1/swap":
                self._respond_json(*gw.handle_swap(body))
            else:
                self._respond_json(404, {"error": f"no route {path!r}"})
        except Exception as e:  # the gateway must answer, never die
            try:
                self._respond_json(500, {"error": str(e)[:500]})
            except Exception:  # noqa: BLE001 — the client went away
                pass

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        gw = self.server.gateway  # type: ignore[attr-defined]
        path = urlparse(self.path).path
        try:
            if path == "/metrics":
                self._respond(200, "text/plain; version=0.0.4; charset=utf-8",
                              gw.render_metrics())
            elif path == "/healthz":
                self._respond_json(*gw.healthz())
            elif path == "/v1/policies":
                self._respond_json(200, {"policies": gw.store.ids(),
                                         "default": gw.store.default_id})
            elif path == "/fleetz" and gw.aggregator is not None:
                self._respond_json(200, gw.aggregator.fleetz())
            elif path == "/fleetz/metrics" and gw.aggregator is not None:
                self._respond(200, "text/plain; version=0.0.4; charset=utf-8",
                              gw.aggregator.merged_metrics())
            else:
                routes = ["/v1/act (POST)", "/v1/swap (POST)", "/v1/policies", "/metrics",
                          "/healthz"]
                if gw.aggregator is not None:
                    routes += ["/fleetz", "/fleetz/metrics"]
                self._respond_json(404, {"error": f"no route {path!r}", "routes": routes})
        except Exception as e:
            try:
                self._respond_json(500, {"error": str(e)[:500]})
            except Exception:  # noqa: BLE001 — the client went away
                pass


class _ThreadedServer(ThreadingHTTPServer):
    # The stdlib backlog of 5 SYN-drops a burst of closed-loop clients into
    # 1 s / 3 s retransmit stalls.
    request_queue_size = 128
    daemon_threads = True


class _SequentialServer(HTTPServer):
    request_queue_size = 128


class _SequentialHandler(_Handler):
    """The single-threaded baseline's handler: HTTP/1.0, no keep-alive (with
    one server thread a kept-alive connection would starve every other
    client)."""

    protocol_version = "HTTP/1.0"


class ServeGateway:
    """Owns the HTTP server thread, the micro-batcher and the serving gauge's
    registration for one serving process. `port=0` binds an OS-assigned
    port; the ACTUAL port is on `self.port` (and in `self.url`).

    `threaded=False` swaps the concurrent server and micro-batcher for a
    single-threaded HTTP/1.0 server with a batch-1, zero-wait batcher: the
    sequential baseline. `session`: a telemetry session the request spans
    go to and `/metrics` renders (default: the process's current session
    for spans, the serving gauge alone for `/metrics`)."""

    def __init__(
        self,
        store: PolicyStore,
        port: int = 0,
        host: str = "127.0.0.1",
        session=None,
        max_wait_us: float = 2000.0,
        max_batch_rows: Optional[int] = None,
        queue_limit: int = 256,
        request_timeout_s: float = 30.0,
        stall_after_s: float = 5.0,
        batcher: Optional[MicroBatcher] = None,
        threaded: bool = True,
        fleet=None,
        aggregator=None,
        max_inflight: int = 1,
        shed_burn_threshold: Optional[float] = None,
        shed_queue_frac: float = 0.5,
    ):
        self.store = store
        self.session = session
        # The fleet's merged views (/fleetz) and its membership (/healthz)
        # when this gateway is one rank of a --distributed fleet.
        self.aggregator = aggregator
        self.fleet = fleet
        self.threaded = bool(threaded)
        self.request_timeout_s = float(request_timeout_s)
        self.stall_after_s = float(stall_after_s)
        owns_batcher = batcher is None
        if not threaded and batcher is None:
            # One request per flush, no window: there is never a second
            # in-flight request to batch with.
            batcher = MicroBatcher(store, max_wait_us=0.0, max_batch_rows=1,
                                   queue_limit=queue_limit)
        self.batcher = batcher or MicroBatcher(
            store, max_wait_us=max_wait_us, max_batch_rows=max_batch_rows,
            queue_limit=queue_limit, max_inflight=max_inflight,
            shed_burn_threshold=shed_burn_threshold, shed_queue_frac=shed_queue_frac,
        )
        # The dispatcher's hops go to the same session as the handler's.
        self.batcher.session_resolver = self._trace_session
        self._gauge_key = _sampler.register_gauge("serving", self.batcher.gauge)
        try:
            if threaded:
                self._server = _ThreadedServer((host, int(port)), _Handler)
            else:
                self._server = _SequentialServer((host, int(port)), _SequentialHandler)
        except Exception:
            # A bind failure: close() is unreachable when __init__ raises, so
            # the gauge and the dispatcher just made must not leak.
            _sampler.unregister_gauge(self._gauge_key)
            if owns_batcher:
                self.batcher.close(timeout=1.0)
            raise
        self._server.gateway = self  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serve-gateway", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- route handlers (return (status, body); HTTP-free for tests) ---------

    def _trace_session(self):
        """Span-emission target: the attached session, else the current one."""
        return self.session if self.session is not None else _telemetry_current()

    def emit_respond_span(self, trace_id: str, t_resp_pc: float) -> None:
        """The `serve_respond` hop: response serialization and the socket
        write the handler just finished."""
        sess = self._trace_session()
        if sess is not None:
            sess.tracer.complete("serve_respond", t_resp_pc, time.perf_counter() - t_resp_pc,
                                 {"trace": trace_id})

    def handle_act(self, body: dict, trace_id: Optional[str] = None,
                   t_recv_pc: Optional[float] = None) -> tuple[int, dict]:
        """One /v1/act request; a direct caller may omit `trace_id` (one is
        minted, so the response carries one either way) and `t_recv_pc`
        (the handler's socket-read stamp)."""
        t0_pc = time.perf_counter() if t_recv_pc is None else t_recv_pc
        tid = trace_id or mint_trace_id()
        status, out = self._act(body, tid, t0_pc)
        if isinstance(out, dict):
            out.setdefault("trace", tid)
        sess = self._trace_session()
        if sess is not None:
            # Flow END first: its ts must land inside the serve_request
            # slice emitted next.
            sess.tracer.flow(flow_id_of(tid), "f")
            sess.tracer.complete("serve_request", t0_pc, time.perf_counter() - t0_pc,
                                 {"trace": tid, "status": status})
        return status, out

    def _act(self, body: dict, tid: str, t0_pc: float) -> tuple[int, dict]:
        policy_id = body.get("policy")
        if "obs" not in body:
            return 400, {"error": "missing 'obs'"}
        try:
            handle = self.store.get(policy_id)
        except UnknownPolicy as e:
            return 404, {"error": str(e)}
        spec = getattr(handle.engine, "spec", None)
        try:
            obs = np.asarray(body["obs"], dtype=getattr(handle.engine, "obs_dtype", np.float32))
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad obs payload: {e}"}
        single = False
        if spec is not None:
            shape = tuple(spec.obs_shape)
            if obs.shape == shape:
                obs, single = obs[None], True
            elif obs.shape[1:] != shape or obs.ndim != len(shape) + 1:
                return 400, {"error": f"obs must be shaped {shape} or [n, *{shape}], got "
                                      f"{tuple(obs.shape)}"}
        elif obs.ndim == 0:
            return 400, {"error": "obs must be at least rank 1"}
        sess = self._trace_session()
        if sess is not None:
            # The parse hop: socket read, JSON decode, obs validation.
            sess.tracer.complete("serve_parse", t0_pc, time.perf_counter() - t0_pc,
                                 {"trace": tid})
        t0 = time.monotonic()
        try:
            # Route by the RESOLVED id: the default route could be repointed
            # between validation above and submit, and obs was validated
            # against THIS handle's spec.
            req = self.batcher.submit(obs, handle.policy_id, trace_id=tid)
        except ValueError as e:  # oversized request
            return 400, {"error": str(e)}
        except QueueFull as e:  # submit() already counted the reject
            return 503, {"error": str(e)}
        except Overloaded as e:  # submit() already counted the shed
            return 503, {"error": str(e), "shed": True}
        except DispatcherDown as e:
            self.batcher.metrics.record_shed()
            return 503, {"error": str(e)}
        if sess is not None:
            # Flow START on this thread, inside serve_request: the
            # dispatcher's flow step links the flush that serves it back here.
            sess.tracer.flow(flow_id_of(tid), "s")
        try:
            actions, version = self.batcher.wait(req, timeout=self.request_timeout_s)
        except (DispatcherDown, TimeoutError) as e:
            # Shed after admission: distinct from the queue-capacity reject.
            self.batcher.metrics.record_shed()
            return 503, {"error": str(e)}
        except Exception as e:
            # A flush failure relayed through wait(): the server's fault,
            # never a client 4xx.
            return 500, {"error": str(e)[:500]}
        out = np.asarray(actions)
        if single:
            out = out[0]
        return 200, {
            "actions": out.tolist(),
            "policy": req.policy_id,
            "version": version,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
        }

    def handle_swap(self, body: dict) -> tuple[int, dict]:
        policy_id, ckpt = body.get("policy"), body.get("checkpoint")
        if not policy_id or not ckpt:
            return 400, {"error": "need 'policy' and 'checkpoint'"}
        step = body.get("step")
        try:
            handle = self.store.swap_from_checkpoint(
                str(policy_id), str(ckpt), None if step is None else int(step))
        except UnknownPolicy as e:
            return 404, {"error": str(e)}
        except FileNotFoundError as e:
            return 400, {"error": f"checkpoint restore failed: {e}"}
        except NonFiniteError as e:
            # The swap gate refusing a nan/inf checkpoint is the client's
            # input, not a server fault; the previous version keeps serving.
            return 422, {"error": str(e)}
        return 200, {"policy": handle.policy_id, "version": handle.version}

    def healthz(self) -> tuple[int, dict]:
        h = self.batcher.health()
        body = {"status": "ok", "dispatcher": h, "policies": self.store.ids(),
                "default": self.store.default_id}
        stalled = (not h["alive"]) or (
            h["queue_depth"] > 0 and h["last_flush_age_s"] > self.stall_after_s)
        if self.fleet is not None:
            snap = self.fleet.snapshot()
            body["fleet"] = snap
            if not snap["ok"]:
                # A quiet peer degrades this rank's health: the proxy in front
                # sees which members report a late mailbox, not only who died.
                stalled = True
        if stalled:
            body["status"] = "stalled"
            return 503, body
        return 200, body

    def render_metrics(self) -> str:
        if self.session is not None:
            from actor_critic_tpu_torch.telemetry.exporter import render_metrics

            return render_metrics(self.session)
        return standalone_metrics(self.batcher)

    def close(self) -> None:
        _sampler.unregister_gauge(self._gauge_key)
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # noqa: BLE001 — closing must finish
            pass
        self._thread.join(timeout=5.0)
        self.batcher.close()
