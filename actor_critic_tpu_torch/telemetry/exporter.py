"""Prometheus text-format helpers (the part of
`actor_critic_tpu/telemetry/exporter.py` that the serving gateway's
`/metrics` reads: metric names and sample lines). The live exporter, its
HTTP server and `render_metrics` over a telemetry session are not ported
yet (ROADMAP Queue 1 item 10)."""

from __future__ import annotations

import re
from typing import Optional

_PREFIX = "actor_critic"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


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
