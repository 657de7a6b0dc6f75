"""Run plumbing of the port (counterpart of `actor_critic_tpu/utils/`):
the logging and checkpoint cadences (`cadence.py`), the JSONL metrics
sink (`logging.py`), checkpoint / resume and the chunk-wall sidecar
(`checkpoint.py`), the finiteness gate (`numguard.py`), the stall
watchdog (`watchdog.py`) and the tracing and timing helpers
(`profiling.py`)."""
