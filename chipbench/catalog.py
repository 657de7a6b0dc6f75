"""Finds a cell's parts by name, so that a new cell, configuration,
traffic mix or metric is a new file and a new entry in `BENCHMARK.json`,
never an edit:

- `BENCHMARK.json` (at the checkout's root): the cells, their
  configuration and traffic names, and the metrics with the cells they
  are reported in;
- `chipbench/configs/<config>.json`: the configuration as it is run (the
  `file` of its `configs` entry), and `<config>.py` beside it: its weight
  layout, FLOP and byte functions;
- `chipbench/reference/<config>.py`: its plain reference;
- `chipbench/traffic/<traffic>.json`: the traffic's parameters;
- `chipbench/limits/<cell>.json`: the limit of each number the check
  compares for the cell;
- `chipbench/metrics/<metric>.py`: one reader per metric, `read(run)`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType


def load_module(path: Path) -> ModuleType:
    """The Python file at `path` as a module, once per process (metric
    names may hold dots, so files are loaded by path, not by import name)."""
    path = Path(path).resolve()
    digest = hashlib.sha256(str(path).encode()).hexdigest()[:12]
    name = f"chipbench_file_{path.stem.replace('.', '_')}_{digest}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with its parts loaded."""

    name: str
    config: str
    traffic: str
    chips: int
    conf: dict            # the configuration file
    params: dict          # the traffic file
    config_mod: ModuleType
    reference_mod: ModuleType
    limits: dict
    end_to_end: list      # `end_to_end` entries reported in this cell
    per_layer: list       # `per_layer` entries reported in this cell

    @property
    def num_envs(self) -> int:
        return int(self.params["num_envs"])

    @property
    def steps(self) -> int:
        return int(self.params["rollout_steps"])


class Catalog:
    """`BENCHMARK.json` at `root` and the benchmark's files under
    `root/chipbench`."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "chipbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _json(self, *parts: str) -> dict:
        with open(self.dir.joinpath(*parts)) as f:
            return json.load(f)

    def cell_names(self) -> list[str]:
        return [w["name"] for w in self.bench["workloads"]]

    @staticmethod
    def _reported(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {self.cell_names()}")
        config = next(c for c in self.bench["configs"] if c["name"] == entry["config"])
        with open(self.root / config["file"]) as f:
            conf = json.load(f)
        return Cell(
            name=name,
            config=entry["config"],
            traffic=entry["traffic"],
            chips=int(entry["chips"]),
            conf=conf,
            params=self._json("traffic", f"{entry['traffic']}.json"),
            config_mod=load_module(self.dir / "configs" / f"{entry['config']}.py"),
            reference_mod=load_module(self.dir / "reference" / f"{entry['config']}.py"),
            limits=self._json("limits", f"{name}.json"),
            end_to_end=[m for m in self.bench["end_to_end"] if self._reported(m, name)],
            per_layer=[m for m in self.bench["per_layer"] if self._reported(m, name)],
        )

    def reader(self, metric: str) -> ModuleType:
        """`metric`'s reader: its `read(run)` gives the value, or None where
        the run holds nothing to read it from."""
        return load_module(self.dir / "metrics" / f"{metric}.py")
