"""Fleet-level metrics aggregation (counterpart of
`actor_critic_tpu/telemetry/fleet.py`).

Each rank's exporter (`telemetry/exporter.py`) answers for one process; a
fleet is N processes. This module adds:

- endpoint announce/discover over the same mailbox directory the gossip
  exchange shares (`parallel/multihost.py`): each rank atomically
  publishes `telemetry_endpoint_host<rank>.json` with its exporter URL
  (write, fsync, rename, a pid-unique temporary name; a torn read is
  None), and any process that sees the mailbox can list the fleet;
- `FleetAggregator`, which scrapes every discovered rank's `/metrics` and
  serves two merged views through the serving gateway (`/fleetz` JSON,
  `/fleetz/metrics` Prometheus text). Counters, histogram buckets, `_sum`
  and `_count` rows merge by exact addition (the fixed bucket boundaries
  of `telemetry/histo.py` make cumulative histograms sum bucket by bucket);
  point gauges get min/max rollups, never an average no rank reported.

Scrapes happen on demand (each `/fleetz` request) with a per-rank timeout,
and a dead rank becomes an entry in `unreachable` rather than failing the
view.
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.request
from typing import Optional

from actor_critic_tpu_torch.telemetry import histo
from actor_critic_tpu_torch.telemetry.exporter import _line

_ENDPOINT_RE = re.compile(r"^telemetry_endpoint_host(\d+)\.json$")


def endpoint_file(mailbox_dir: str, rank: int) -> str:
    return os.path.join(
        mailbox_dir, f"telemetry_endpoint_host{int(rank)}.json"
    )


def announce_endpoint(
    mailbox_dir: str, rank: int, url: str, **extra
) -> str:
    """Atomically publish this rank's exporter URL into the shared
    mailbox directory (write→fsync→rename, pid-unique tmp: two ranks
    sharing the dir must never interleave into one tmp file)."""
    path = endpoint_file(mailbox_dir, rank)
    body = {
        "rank": int(rank),
        "url": str(url),
        "pid": os.getpid(),
        "ts": round(time.time(), 3),
        **extra,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(body, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_endpoint(mailbox_dir: str, rank: int) -> Optional[dict]:
    """One rank's announcement, or None on absent/torn file (same
    retry-next-poll contract as the params mailbox)."""
    try:
        with open(endpoint_file(mailbox_dir, rank)) as f:
            out = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    return out if isinstance(out, dict) and "url" in out else None


def discover_endpoints(mailbox_dir: str) -> dict[int, str]:
    """{rank: exporter url} for every announced rank in the mailbox."""
    try:
        names = os.listdir(mailbox_dir)
    except OSError:
        return {}
    out: dict[int, str] = {}
    for name in names:
        m = _ENDPOINT_RE.match(name)
        if not m:
            continue
        ann = read_endpoint(mailbox_dir, int(m.group(1)))
        if ann is not None:
            out[int(m.group(1))] = str(ann["url"])
    return out


# Families whose rows are exact-summable across ranks: monotone counters
# and the three histogram series (cumulative buckets sum bucket-wise).
_SUM_SUFFIXES = ("_total", "_bucket", "_sum", "_count")


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def snapshots_from_parsed(
    entries: list[tuple[str, dict, float]]
) -> dict[tuple[str, tuple], dict]:
    """Reconstruct histo snapshot dicts from parsed `_bucket/_sum/_count`
    exposition rows: {(family, labels-sans-le key): snapshot}. The
    round-trip is exact — the exposition IS the cumulative counts."""
    acc: dict[tuple[str, tuple], dict] = {}
    for name, labels, value in entries:
        if name.endswith("_bucket") and "le" in labels:
            fam = name[: -len("_bucket")]
            rest = {k: v for k, v in labels.items() if k != "le"}
            slot = acc.setdefault(
                (fam, _labels_key(rest)),
                {"bounds": {}, "sum": 0.0, "count": 0, "labels": rest},
            )
            slot["bounds"][labels["le"]] = value
        elif name.endswith("_sum"):
            fam = name[: -len("_sum")]
            key = (fam, _labels_key(labels))
            if key in acc:
                acc[key]["sum"] = value
        elif name.endswith("_count"):
            fam = name[: -len("_count")]
            key = (fam, _labels_key(labels))
            if key in acc:
                acc[key]["count"] = value
    out: dict[tuple[str, tuple], dict] = {}
    for key, slot in acc.items():
        finite = sorted(
            (float(le) for le in slot["bounds"] if le != "+Inf")
        )
        if not finite or "+Inf" not in slot["bounds"]:
            continue  # not a complete histogram family
        buckets = [int(slot["bounds"][_le_str(b)]) for b in finite]
        buckets.append(int(slot["bounds"]["+Inf"]))
        out[key] = {
            "histogram": True,
            "boundaries": finite,
            "buckets": buckets,
            "sum": float(slot["sum"]),
            "count": int(slot["count"]),
            "labels": dict(slot["labels"]),
        }
    return out


def _le_str(bound: float) -> str:
    """The exposition string for a finite boundary (render_prometheus
    drops the trailing `.0` on integral bounds — mirror that)."""
    return repr(int(bound)) if float(bound).is_integer() else repr(float(bound))


class FleetAggregator:
    """Scrape-and-merge across every rank's exporter.

    `mailbox_dir` enables discovery via announce files; an explicit
    `endpoints` dict ({rank: url}) overrides/augments it (tests, static
    fleets). Discovery re-runs per scrape, so ranks joining late appear
    without restarting the gateway.
    """

    def __init__(
        self,
        mailbox_dir: Optional[str] = None,
        endpoints: Optional[dict[int, str]] = None,
        timeout_s: float = 2.0,
    ):
        self.mailbox_dir = mailbox_dir
        self._static = dict(endpoints or {})
        self.timeout_s = float(timeout_s)

    def endpoints(self) -> dict[int, str]:
        out: dict[int, str] = {}
        if self.mailbox_dir is not None:
            out.update(discover_endpoints(self.mailbox_dir))
        out.update(self._static)
        return out

    def _fetch(self, url: str) -> Optional[str]:
        try:
            with urllib.request.urlopen(
                url.rstrip("/") + "/metrics", timeout=self.timeout_s
            ) as resp:
                return resp.read().decode("utf-8", "replace")
        except Exception:
            return None

    def scrape(self) -> dict[int, Optional[str]]:
        """{rank: /metrics exposition text, or None if unreachable}."""
        return {
            rank: self._fetch(url)
            for rank, url in sorted(self.endpoints().items())
        }

    # -- merged Prometheus text ---------------------------------------------

    def merged_metrics(self) -> str:
        """One exposition: every rank's rows re-labeled `rank="<r>"`,
        plus `rank="fleet"` rollups — exact sums for counters/histogram
        series, min/max for point gauges."""
        scraped = self.scrape()
        per_rank: list[str] = []
        sums: dict[tuple[str, tuple], float] = {}
        gauges: dict[tuple[str, tuple], list[float]] = {}
        reachable = 0
        for rank, text in scraped.items():
            if text is None:
                continue
            reachable += 1
            for name, labels, value in histo.parse_prometheus(text):
                per_rank.append(
                    _line(name, value, {**labels, "rank": str(rank)})
                )
                key = (name, _labels_key(labels))
                if name.endswith(_SUM_SUFFIXES):
                    sums[key] = sums.get(key, 0.0) + value
                else:
                    gauges.setdefault(key, []).append(value)
        out = [
            "# fleet-merged exposition: per-rank rows plus rank=\"fleet\" "
            "rollups (exact sums for counters/histograms, min/max for "
            "gauges)",
            _line("actor_critic_fleet_size", len(scraped)),
            _line("actor_critic_fleet_reachable", reachable),
        ]
        out.extend(per_rank)
        for (name, lkey) in sorted(sums):
            out.append(
                _line(name, sums[(name, lkey)],
                      {**dict(lkey), "rank": "fleet"})
            )
        for (name, lkey) in sorted(gauges):
            vals = gauges[(name, lkey)]
            base = dict(lkey)
            out.append(
                _line(name, min(vals),
                      {**base, "rank": "fleet", "agg": "min"})
            )
            out.append(
                _line(name, max(vals),
                      {**base, "rank": "fleet", "agg": "max"})
            )
        return "\n".join(out) + "\n"

    # -- merged JSON summary ------------------------------------------------

    def fleetz(self) -> dict:
        """The /fleetz body: per-rank reachability + headline gauges,
        and fleet-merged latency histograms with hist-derived p50/p99
        (merged bucket-wise first, THEN quantiled — quantiles of merged
        buckets are the fleet quantiles; averaging per-rank p99s is not)."""
        scraped = self.scrape()
        endpoints = self.endpoints()
        ranks: dict[str, dict] = {}
        counters: dict[str, float] = {}
        hists: dict[tuple[str, tuple], list[dict]] = {}
        for rank, text in scraped.items():
            entry: dict = {"url": endpoints.get(rank)}
            if text is None:
                entry["up"] = False
            else:
                parsed = histo.parse_prometheus(text)
                flat = {
                    name: value
                    for name, labels, value in parsed
                    if not labels
                }
                entry["up"] = flat.get("actor_critic_up", 0.0) == 1.0
                for k in (
                    "actor_critic_uptime_seconds",
                    "actor_critic_serving_requests_total",
                    "actor_critic_serving_slo_burn",
                    "actor_critic_iters_per_s",
                ):
                    if k in flat:
                        entry[k.removeprefix("actor_critic_")] = flat[k]
                for name, labels, value in parsed:
                    if name.endswith("_total") and not labels:
                        counters[name] = counters.get(name, 0.0) + value
                for key, snap in snapshots_from_parsed(parsed).items():
                    hists.setdefault(key, []).append(snap)
            ranks[str(rank)] = entry
        merged_hists: dict[str, dict] = {}
        for (fam, lkey), snaps in sorted(hists.items()):
            merged = histo.merge(snaps)
            if merged is None:
                continue
            label = ",".join(f"{k}={v}" for k, v in lkey) or "all"
            merged_hists[f"{fam}{{{label}}}"] = {
                "count": merged["count"],
                "sum": merged["sum"],
                "p50": histo.quantile(merged, 0.5),
                "p99": histo.quantile(merged, 0.99),
                "buckets": merged["buckets"],
                "boundaries": merged["boundaries"],
            }
        return {
            "fleet_size": len(scraped),
            "reachable": sorted(
                r for r, t in scraped.items() if t is not None
            ),
            "unreachable": sorted(
                r for r, t in scraped.items() if t is None
            ),
            "ranks": ranks,
            "counters": counters,
            "histograms": merged_hists,
        }
