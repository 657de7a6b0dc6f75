"""Live run introspection over HTTP (the port's counterpart of
`actor_critic_tpu/telemetry/exporter.py`).

A stdlib-only daemon HTTP thread (`http.server.ThreadingHTTPServer`)
that makes a LIVE training process answer:

    GET /metrics        Prometheus text: RSS, per-card live/peak bytes
                        (`torch.cuda.memory_stats`), the recompile
                        counter (CUDA-graph captures and compiler runs:
                        `actor_critic_recompiles_total`), every registered
                        sampler gauge (the async queue, the device ring,
                        the serving gateway), the last observe() training
                        row, and iters/s + env-steps/s.
    GET /healthz        JSON liveness: uptime, watchdog staleness, the
                        innermost open telemetry span, age of the last
                        logged row. HTTP 503 once the watchdog is past
                        its timeout outside its grace.
    GET /profile?iters=N   Arm an on-demand windowed torch.profiler
                        capture (telemetry/profiler.py): the next N
                        ticks are traced into <telemetry-dir>/profile_XXX/
                        without restarting the run. Returns the
                        profiler status as JSON.

Enabled by `python -m actor_critic_tpu_torch.train --telemetry-port PORT`
(0 picks an ephemeral port, printed at startup and recorded as an
`exporter_start` event). Binds 127.0.0.1 unless told otherwise
(`validate_bind`). The serving gateway's `/metrics` reads `_line` and
`_metric_name` from here. JAX's three compile-cache metrics read the
port's build cache (`utils/compile_cache.py`): the builds that found their
library (hits) and those that ran a compiler (misses), and whether a cache
directory is enabled.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Optional
from urllib.parse import parse_qs, urlparse

if TYPE_CHECKING:  # import cycle: session constructs the exporter
    from actor_critic_tpu_torch.telemetry.session import TelemetrySession

_PREFIX = "actor_critic"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}

LOOPBACK_HOSTS = frozenset({"127.0.0.1", "localhost", "::1"})


def validate_bind(host: str, distributed: bool = False) -> str:
    """Gate non-loopback telemetry binds: the exporter serves process
    internals with no auth, so exposing it beyond the host must be an
    explicit fleet decision, a distributed run whose ranks scrape each
    other (`/fleetz`), stated by the caller passing `distributed=True`.
    Raises ValueError otherwise; returns the host unchanged when
    acceptable."""
    if host not in LOOPBACK_HOSTS and not distributed:
        raise ValueError(
            f"refusing non-loopback telemetry bind {host!r} without "
            "--distributed: /metrics exposes process internals with no "
            "auth — bind 127.0.0.1 and scrape through an SSH tunnel, "
            "or pass --distributed for a fleet whose ranks scrape "
            "each other"
        )
    return host


def _metric_name(*parts: str) -> str:
    return "_".join(
        _NAME_RE.sub("_", str(p)) for p in (_PREFIX, *parts) if p != ""
    )


def _escape_label(v: object) -> str:
    return "".join(_LABEL_ESC.get(c, c) for c in str(v))


def _line(name: str, value: float, labels: Optional[dict] = None) -> str:
    lbl = ""
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in labels.items()
        )
        lbl = "{" + inner + "}"
    # numpy scalars repr as np.float64(...); coerce to a plain number.
    value = float(value)
    text = repr(int(value)) if value.is_integer() else repr(value)
    return f"{name}{lbl} {text}"


def render_metrics(session: "TelemetrySession") -> str:
    """One Prometheus text-format exposition of the session's live state.
    Pure function of (sampler row, session) so tests can render without
    a socket. A CLOSED session renders a tombstone (`up 0` and nothing
    else): the gauge registry and last-observation rows are process
    state that outlives the session, and re-serving them after close()
    would serve a dead run's numbers as live."""
    from actor_critic_tpu_torch.telemetry import histo
    from actor_critic_tpu_torch.telemetry.sampler import sample_row

    out: list[str] = []

    def emit(name: str, mtype: str, help_: str, rows: list) -> None:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {mtype}")
        out.extend(rows)

    if getattr(session, "closed", False):
        emit(
            _metric_name("up"), "gauge",
            "1 while the telemetry session is live",
            [_line(_metric_name("up"), 0)],
        )
        return "\n".join(out) + "\n"

    row = sample_row()
    emit(
        _metric_name("up"), "gauge", "1 while the telemetry session is live",
        [_line(_metric_name("up"), 1)],
    )
    emit(
        _metric_name("uptime_seconds"), "gauge",
        "seconds since the telemetry session started",
        [_line(_metric_name("uptime_seconds"), round(session.uptime_s(), 3))],
    )
    emit(
        _metric_name("recompiles_total"), "counter",
        "CUDA-graph captures and kernel builds that ran a compiler",
        [_line(_metric_name("recompiles_total"), row.get("recompiles", 0))],
    )
    from actor_critic_tpu_torch.utils import compile_cache

    cstats = compile_cache.cache_stats()
    for field in ("hits", "misses"):
        name = _metric_name("compile_cache", f"{field}_total")
        emit(name, "counter",
             f"kernel and engine build cache {field} (a library found vs a compiler run)",
             [_line(name, cstats[field])])
    name = _metric_name("compile_cache_enabled")
    emit(name, "gauge", "1 when a build cache directory is configured",
         [_line(name, int(compile_cache.enabled_dir() is not None))])
    if "rss_bytes" in row:
        emit(
            _metric_name("rss_bytes"), "gauge", "process resident set size",
            [_line(_metric_name("rss_bytes"), row["rss_bytes"])],
        )
    dev_rows: dict[str, list[str]] = {"live_bytes": [], "peak_bytes": []}
    for d in row.get("devices", []):
        labels = {"device": d.get("id"), "platform": d.get("platform")}
        for field in dev_rows:
            if field in d:
                dev_rows[field].append(
                    _line(_metric_name("device", field), d[field], labels)
                )
    for field, rows in dev_rows.items():
        if rows:
            emit(
                _metric_name("device", field), "gauge",
                f"per-card {field} from torch.cuda.memory_stats()", rows,
            )
    # Registered sampler gauges (dict-valued rows flatten one level:
    # traj_queue -> actor_critic_traj_queue_depth etc.). Histogram
    # snapshots (telemetry/histo.py marker dicts, e.g. the serving
    # gauge's per-policy latency histograms) render as one
    # `_bucket/_sum/_count` family per metric name, all label sets
    # grouped under a single TYPE header.
    skip = {"ts", "recompiles", "rss_bytes", "devices"}
    hist_rows: dict[str, list[str]] = {}
    for key, value in row.items():
        if key in skip:
            continue
        if histo.is_snapshot(value):
            fields = [("", value)]
        elif isinstance(value, dict):
            fields = value.items()
        else:
            fields = [("", value)]
        for fk, fv in fields:
            if histo.is_snapshot(fv):
                name = _metric_name(key, fv.get("metric") or fk)
                hist_rows.setdefault(name, []).extend(
                    histo.render_prometheus(name, fv)
                )
                continue
            if isinstance(fv, bool) or not isinstance(fv, (int, float)):
                continue
            name = _metric_name(key, fk)
            emit(name, "gauge", f"registered gauge {key}", [_line(name, fv)])
    for name in sorted(hist_rows):
        emit(
            name, "histogram",
            "cumulative fixed-boundary histogram (mergeable across "
            "ranks: buckets sum exactly)",
            hist_rows[name],
        )
    for rk, rv in sorted(session.rates().items()):
        name = _metric_name(rk)
        emit(
            name, "gauge", "rate from the last two logged iterations",
            [_line(name, round(rv, 6))],
        )
    age = session.last_observe_age_s()
    if age is not None:
        # Without this a wedged run keeps exporting its LAST healthy
        # rates forever; scrapers alert on this age going flat-out.
        name = _metric_name("last_observe_age_seconds")
        emit(
            name, "gauge",
            "seconds since the last logged training row (rates above "
            "are stale once this grows past the log cadence)",
            [_line(name, round(age, 3))],
        )
    last = session.last_observation
    if last is not None:
        name = _metric_name("train_iteration")
        emit(
            name, "gauge", "iteration of the last logged training row",
            [_line(name, last["it"])],
        )
        name = _metric_name("train_metric")
        rows = [
            _line(name, v, {"metric": k})
            for k, v in sorted(last.items())
            if k not in ("it", "age_t")
            and not isinstance(v, bool)
            and isinstance(v, (int, float))
            and v == v  # NaN breaks the text format; drop the sample
        ]
        if rows:
            emit(name, "gauge", "last observe() training row", rows)
    return "\n".join(out) + "\n"


def healthz(session: "TelemetrySession") -> tuple[int, dict]:
    """(http_status, body) for /healthz: 503 only when an armed watchdog
    is past its timeout outside the startup grace — the same condition
    that is about to exit 42."""
    from actor_critic_tpu_torch import telemetry
    from actor_critic_tpu_torch.utils import watchdog

    body: dict = {
        "status": "ok",
        "uptime_s": round(session.uptime_s(), 3),
    }
    age = session.last_observe_age_s()
    if age is not None:
        body["last_observe_age_s"] = round(age, 3)
        body["last_iteration"] = session.last_observation["it"]
    last = telemetry.last_open_span()
    if last is not None:
        body["open_span"] = {"name": last[0], "open_s": round(last[1], 3)}
    if session.profiler is not None:
        body["profiler"] = session.profiler.status()
    wd = watchdog.status()
    status = 200
    if wd is not None:
        body["watchdog"] = wd
        if wd["staleness_s"] > wd["timeout_s"] and not wd["in_grace"]:
            body["status"] = "stalled"
            status = 503
    return status, body


class _Handler(BaseHTTPRequestHandler):
    # The exporter is a diagnostics sidecar: it must never write to the
    # run's stdout/stderr (stderr noise per scrape would swamp logs).
    def log_message(self, *args) -> None:
        pass

    def _respond(self, status: int, content_type: str, payload: str) -> None:
        data = payload.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _respond_json(self, status: int, body: dict) -> None:
        self._respond(
            status, "application/json", json.dumps(body, default=str) + "\n"
        )

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        session = self.server.telemetry_session  # type: ignore[attr-defined]
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                self._respond(
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    render_metrics(session),
                )
            elif url.path == "/healthz":
                self._respond_json(*healthz(session))
            elif url.path == "/profile":
                if session.profiler is None:
                    self._respond_json(
                        503, {"error": "profiling disabled for this session"}
                    )
                    return
                from actor_critic_tpu_torch.telemetry.profiler import (
                    DEFAULT_PROFILE_ITERS,
                )

                q = parse_qs(url.query)
                try:
                    iters = int(q.get("iters", [DEFAULT_PROFILE_ITERS])[0])
                    if iters < 1:
                        raise ValueError
                except ValueError:
                    self._respond_json(
                        400, {"error": "iters must be a positive integer"}
                    )
                    return
                self._respond_json(202, session.profiler.arm(iters))
            else:
                self._respond_json(
                    404,
                    {"error": f"no route {url.path!r}",
                     "routes": ["/metrics", "/healthz", "/profile?iters=N"]},
                )
        except Exception as e:  # noqa: BLE001 — introspection must never kill the run
            try:
                self._respond_json(500, {"error": str(e)[:500]})
            except Exception:
                pass


class TelemetryExporter:
    """Owns the HTTP server + its daemon thread for one session."""

    def __init__(
        self,
        session: "TelemetrySession",
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self._server.telemetry_session = session  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="telemetry-exporter",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)
