"""JSONL metrics sink (counterpart of `actor_critic_tpu/utils/logging.py`).

One JSON object per logged iteration, appended to `path` (the CLI's
`--metrics`), and echoed to stdout unless `echo` is off (`--quiet`). The
echo is the same JSON line as the file's, the port's row format. Values
are scrubbed as the JAX logger scrubs them: a non-finite number becomes
null, a value that is not a number its string.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

from actor_critic_tpu_torch.utils.cadence import finite_or_none


class JsonlLogger:
    """Append-only JSONL metrics writer with an optional stdout echo."""

    def __init__(self, path: Optional[str | os.PathLike] = "metrics.jsonl", echo: bool = False):
        self._fh: Optional[IO[str]] = None
        if path is not None:
            parent = os.path.dirname(os.fspath(path))
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._echo = echo
        self._t0 = time.time()

    def log(self, iteration: int, metrics: dict) -> None:
        """Write one row: `iter`, `wall_s` (seconds since the logger opened,
        unless `metrics` brings its own) and every metric."""
        row = {"iter": int(iteration), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
            else:
                row[k] = v if isinstance(v, int) and not isinstance(v, bool) else finite_or_none(v)
        line = json.dumps(row)
        if self._fh is not None:
            self._fh.write(line + "\n")
        if self._echo:
            print(line, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
