"""Near miss: the rank_affinity_flag.py shapes made safe — every
shared artifact path folds the rank in (the `host<rank>/` convention
parallel/launch.py uses). Parsed only — never
imported."""

import json
import os


class TelemetrySession:  # stand-in sink shape; never imported
    def __init__(self, directory, **kwargs):
        self.directory = directory


def start_fleet_telemetry(base_dir, rank):
    return TelemetrySession(os.path.join(base_dir, f"host{rank}"))


def log_fleet_row(out_dir, rank, row):
    path = os.path.join(out_dir, f"metrics.host{rank}.jsonl")
    with open(path, "w") as f:
        json.dump(row, f)
