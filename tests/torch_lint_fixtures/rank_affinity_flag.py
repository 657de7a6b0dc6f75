"""Flag fixture (MUST FLAG rank-affinity): shared artifact paths
written from per-rank scopes with no process identity in the path —
every host of the fleet clobbers the same file. Parsed only — never
imported."""

import json
import os


class TelemetrySession:  # stand-in sink shape; never imported
    def __init__(self, directory, **kwargs):
        self.directory = directory


def start_fleet_telemetry(base_dir, rank):
    # Same directory on every host: N hosts interleave one spans.jsonl.
    return TelemetrySession(base_dir)


def log_fleet_row(out_dir, rank, row):
    path = os.path.join(out_dir, "metrics.jsonl")  # rank never reaches it
    with open(path, "w") as f:
        json.dump(row, f)
