"""Fixed-boundary cumulative histograms for the serving SLO layer
(counterpart of `actor_critic_tpu/telemetry/histo.py`, the same code).

Bucket counts are plain counters, so merging ranks is exact bucket-wise
addition (`merge`), and any quantile is recoverable to bucket resolution
at read time (`quantile`: linear interpolation inside the landing bucket).
Snapshots are plain dicts carrying a `"histogram": True` marker, so the
serving gauge's renderer recognizes one and writes the Prometheus
`_bucket`/`_sum`/`_count` triplet (`render_prometheus`).

Stdlib only.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

# Default serving-latency ladder (milliseconds). Chosen to straddle the
# measured gateway range: sub-ms mirror-backend acts up through the
# multi-second timeout cliff, roughly log-spaced like the Prometheus
# client defaults. +Inf is implicit (the last cumulative bucket).
DEFAULT_LATENCY_BOUNDARIES_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
)


class Histogram:
    """Thread-safe fixed-boundary cumulative histogram.

    `boundaries` are the upper bounds of the finite buckets, strictly
    increasing; an implicit +Inf bucket catches the overflow. Counts are
    stored PER-BUCKET internally and cumulated at snapshot time (one
    add per observe, not one per bucket).
    """

    __slots__ = ("boundaries", "_counts", "_sum", "_count", "_lock")

    def __init__(
        self, boundaries: Sequence[float] = DEFAULT_LATENCY_BOUNDARIES_MS
    ):
        bounds = tuple(float(b) for b in boundaries)
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError(
                f"boundaries must be non-empty and strictly increasing, "
                f"got {bounds}"
            )
        self.boundaries = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def _index(self, value: float) -> int:
        # Linear scan beats bisect at this ladder length (11 bounds) and
        # keeps the hot path allocation-free.
        for i, b in enumerate(self.boundaries):
            if value <= b:
                return i
        return len(self.boundaries)

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return  # a NaN latency must not poison _sum
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def observe_many(self, values: Sequence[float]) -> None:
        """Batched observe: one lock acquisition per flush, not per
        request (the dispatcher records a whole flush's latencies)."""
        clean = [float(v) for v in values]
        clean = [v for v in clean if not math.isnan(v)]
        if not clean:
            return
        idx = [self._index(v) for v in clean]
        with self._lock:
            for i in idx:
                self._counts[i] += 1
            self._sum += sum(clean)
            self._count += len(clean)

    def snapshot(self, labels: Optional[dict] = None) -> dict:
        """One mergeable/renderable view: CUMULATIVE bucket counts (the
        Prometheus `_bucket{le=...}` convention — the +Inf bucket equals
        `count`), plus sum/count and the marker key the exporter keys
        rendering off."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        snap = {
            "histogram": True,
            "boundaries": list(self.boundaries),
            "buckets": cum,
            "sum": round(s, 6),
            "count": total,
        }
        if labels:
            snap["labels"] = dict(labels)
        return snap


def is_snapshot(obj: object) -> bool:
    """Whether `obj` is a histogram snapshot dict (the exporter's
    recognition test — cheap and explicit, no isinstance gymnastics)."""
    return (
        isinstance(obj, dict)
        and obj.get("histogram") is True
        and isinstance(obj.get("buckets"), list)
        and isinstance(obj.get("boundaries"), list)
    )


def merge(snapshots: Sequence[dict]) -> Optional[dict]:
    """Exact bucket-wise merge of same-boundary snapshots (the fleet
    rollup): merged bucket k == sum of every input's bucket k, merged
    sum/count likewise. Returns None for an empty/boundary-mismatched
    input set — a fleet mixing histogram shapes is a deploy skew the
    caller should surface, not silently blend."""
    snaps = [s for s in snapshots if is_snapshot(s)]
    if not snaps:
        return None
    bounds = snaps[0]["boundaries"]
    if any(s["boundaries"] != bounds for s in snaps[1:]):
        return None
    n = len(bounds) + 1
    if any(len(s["buckets"]) != n for s in snaps):
        return None
    merged = [0] * n
    for s in snaps:
        for i, c in enumerate(s["buckets"]):
            merged[i] += int(c)
    return {
        "histogram": True,
        "boundaries": list(bounds),
        "buckets": merged,
        "sum": round(sum(float(s["sum"]) for s in snaps), 6),
        "count": sum(int(s["count"]) for s in snaps),
    }


def quantile(snap: dict, q: float) -> Optional[float]:
    """Histogram-derived quantile estimate from a snapshot: find the
    cumulative bucket the rank lands in and interpolate linearly inside
    it (lower edge = previous boundary, or 0 for the first bucket; the
    +Inf bucket clamps to the last finite boundary — the honest answer
    a bounded ladder can give). None while the histogram is empty."""
    if not is_snapshot(snap) or not 0.0 <= q <= 1.0:
        return None
    total = int(snap["count"])
    if total <= 0:
        return None
    bounds = snap["boundaries"]
    cum = snap["buckets"]
    rank = q * total
    prev_cum = 0
    for i, c in enumerate(cum):
        if rank <= c or i == len(cum) - 1:
            if i >= len(bounds):
                return float(bounds[-1])  # +Inf bucket: clamp
            lo = 0.0 if i == 0 else float(bounds[i - 1])
            hi = float(bounds[i])
            in_bucket = c - prev_cum
            if in_bucket <= 0:
                return hi
            frac = (rank - prev_cum) / in_bucket
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        prev_cum = c
    return float(bounds[-1])


def render_prometheus(
    name: str, snap: dict, labels: Optional[dict] = None
) -> list[str]:
    """Prometheus text lines for one snapshot: `<name>_bucket{le=...}`
    ascending (+Inf last), `<name>_sum`, `<name>_count`. `labels` merge
    with any labels the snapshot itself carries (snapshot wins on
    collision — it is closer to the data)."""
    from actor_critic_tpu_torch.telemetry.exporter import _line

    lbl = dict(labels or {})
    lbl.update(snap.get("labels") or {})
    out = []
    for b, c in zip(snap["boundaries"], snap["buckets"]):
        le = repr(int(b)) if float(b).is_integer() else repr(float(b))
        out.append(_line(f"{name}_bucket", c, {**lbl, "le": le}))
    out.append(_line(f"{name}_bucket", snap["buckets"][-1],
                     {**lbl, "le": "+Inf"}))
    out.append(_line(f"{name}_sum", snap["sum"], lbl or None))
    out.append(_line(f"{name}_count", snap["count"], lbl or None))
    return out


def parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Parse Prometheus text exposition into (name, labels, value)
    triples, skipping comments/blank/malformed lines — the fleet
    aggregator's scrape decoder (stdlib only, handles exactly the
    subset our own exporter emits)."""
    out: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, val = line.rsplit(None, 1)
            value = float(val)
        except ValueError:
            continue
        labels: dict = {}
        name = head
        if "{" in head and head.endswith("}"):
            name, _, inner = head.partition("{")
            inner = inner[:-1]
            ok = True
            for part in _split_labels(inner):
                if "=" not in part:
                    ok = False
                    break
                k, _, v = part.partition("=")
                v = v.strip()
                if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                    v = v[1:-1].replace('\\"', '"').replace("\\n", "\n")
                    v = v.replace("\\\\", "\\")
                labels[k.strip()] = v
            if not ok:
                continue
        out.append((name, labels, value))
    return out


def _split_labels(inner: str) -> list[str]:
    """Split a label body on commas OUTSIDE quoted values (a policy id
    containing a comma must not shear the pair list)."""
    parts, buf, in_q, prev = [], [], False, ""
    for ch in inner:
        if ch == '"' and prev != "\\":
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        prev = ch
    if buf:
        parts.append("".join(buf))
    return [p for p in (p.strip() for p in parts) if p]
