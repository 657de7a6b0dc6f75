"""Run plumbing of the port (counterpart of `actor_critic_tpu/utils/`):
the logging and checkpoint cadences (`cadence.py`), the JSONL metrics
sink (`logging.py`) and checkpoint / resume (`checkpoint.py`)."""
