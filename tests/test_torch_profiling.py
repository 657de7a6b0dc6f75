"""The port's tracing and timing helpers (`actor_critic_tpu_torch/utils/
profiling.py`, JAX's `utils/profiling.py` and its tests): `time_fn`
returns a positive time per call, `trace` writes a Chrome trace of what
ran inside it, and `nan_guard` warns exactly on non-finite input and
refuses to run inside a CUDA-graph capture (where no host check can)."""

import json
import logging
import os

import pytest
import torch

from actor_critic_tpu_torch.utils import profiling


def test_time_fn_returns_positive_time():
    x = torch.ones(128, 128)
    dt = profiling.time_fn(lambda a: a @ a, x, iters=3, warmup=1)
    assert dt > 0


def test_trace_writes_artifacts(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.named_scope("doubling"):
            (torch.ones(64, 64) * 2).sum()
    files = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert files, "profiler trace produced no files"
    events = json.load(open(os.path.join(logdir, profiling.TRACE_FILE)))["traceEvents"]
    assert any(e.get("name") == "doubling" for e in events)


def test_nan_guard_warns_only_on_nonfinite(caplog, monkeypatch):
    with caplog.at_level(logging.WARNING):
        profiling.nan_guard({"loss": torch.ones(4)}, name="test-metrics")
    assert "non-finite" not in caplog.text
    with caplog.at_level(logging.WARNING):
        profiling.nan_guard({"loss": torch.tensor([1.0, float("nan"), 3.0, 4.0])},
                            name="test-metrics")
    assert "non-finite" in caplog.text and "test-metrics" in caplog.text
    # Inside a capture no host check can run: it raises, never warns later.
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="captured CUDA graph"):
        profiling.nan_guard({"loss": torch.ones(4)})
