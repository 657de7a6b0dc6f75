"""Unified run telemetry of the port (counterpart of
`actor_critic_tpu/telemetry/`): phase spans, resource sampling and health
events behind one `TelemetrySession`.

- `spans`   — host-side span tracer emitting Chrome-trace-format events
              (`spans.jsonl`, one event per line; Perfetto-viewable via
              `scripts/run_report.py --trace`).
- `sampler` — daemon resource sampler (`resources.jsonl`): process RSS,
              per-card live/peak bytes, the recompile counter (CUDA-graph
              captures and compiler runs), the registered gauges.
- `health`  — throughput-regression and divergence detectors emitting
              structured events (`events.jsonl`).
- `flight`  — the crash flight recorder: an mmap'd ring of the last
              records, dumped on stall and divergence (JAX's ring layout).
- `session` — `TelemetrySession` owning the sinks, plus the module-level
              current-session API the training loops call.
- `exporter`— live introspection over HTTP: `/metrics` (Prometheus text),
              `/healthz` (watchdog staleness and open span),
              `/profile?iters=N` (arm an on-demand capture).
- `profiler`— the armable windowed `torch.profiler` capture and the
              compile record (`record_compile`): every capture and build
              becomes a `compile` event.
- `histo`   — cumulative fixed-boundary latency histograms (serving).

Instrumentation is ALWAYS on (a span is two `time.perf_counter()` calls
and a list push/pop, with no device sync); the JSONL sinks only exist
while a session is installed (`--telemetry-dir`). The open-span stack is
kept even without a session so the stall watchdog can name the hung phase
in its exit-42 diagnosis.
"""

from actor_critic_tpu_torch.telemetry.profiler import (  # noqa: F401
    tick as profiler_tick,
)
from actor_critic_tpu_torch.telemetry.session import (  # noqa: F401
    TelemetrySession,
    complete_span,
    current,
    event,
    instant,
    last_open_span,
    observe,
    open_spans,
    set_current,
    span,
    stall_report,
)
from actor_critic_tpu_torch.telemetry.spans import CANONICAL_PHASES  # noqa: F401
