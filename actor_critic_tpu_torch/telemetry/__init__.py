"""Serving-side telemetry of the port (counterpart of part of
`actor_critic_tpu/telemetry/`): cumulative latency histograms
(`histo.py`), the Prometheus text helpers (`exporter.py`) and the
process-wide gauge registry (`sampler.py`). The telemetry session, its
sampler loop, spans and the full exporter are not ported yet (ROADMAP
Queue 1 item 10)."""
