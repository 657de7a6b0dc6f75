"""The benchmark's definition: BENCHMARK.json within the contract's
limits, every part found by name, and a cell added by files alone."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from chipbench import catalog, core

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"] and BENCH["command"] == ["python3", "chipbench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_cells_and_metrics_are_consistent():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert list(cells) == ["a2c_cartpole.e4096_t64", "impala_pong.e64_t20", "impala_pong.e256_t20",
                           "a2c_cartpole.e65536_t64"]
    assert all(w["chips"] == 1 for w in cells.values())
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
    assert BENCH["run_seconds"] in range(1, 52)
    assert 338 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(cell):
    c = catalog.Catalog(ROOT).cell(cell)
    assert c.conf["name"] == c.config and c.num_envs > 0 and c.steps > 0
    assert set(c.limits) <= {"loss_gap", "grad_gap", "delta_gap", "actor_gap", "state_gap"} and c.limits
    # A configuration with stale actors has their refresh compared.
    assert ("actor_gap" in c.limits) == ("actor_refresh_every" in c.conf["config"])
    for m in c.end_to_end + c.per_layer:
        assert callable(catalog.Catalog(ROOT).reader(m["name"]).read)
    assert {m["name"] for m in c.end_to_end} == {"env_steps_per_s", "iter_ms_p95", "setup_s"}


def test_a_cell_and_a_metric_added_as_files_are_found(tiny_root):
    """A later change adds a traffic file, a limits file, a metric reader and
    entries in BENCHMARK.json, and edits nothing: the harness runs it."""
    (tiny_root / "chipbench" / "metrics" / "episodes_per_iter.py").write_text(
        "def read(run):\n    return None if run.window is None else float(run.window.iterations)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "episodes_per_iter", "unit": "episodes", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["a2c_cartpole.tiny"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = catalog.Catalog(tiny_root)
    assert "a2c_cartpole.tiny" in cat.cell_names()
    result, _ = core.execute(cat, "a2c_cartpole.tiny", 3, 0.2, False, time.time(), device="cpu")
    assert result["correct"]
    assert result["metrics"]["episodes_per_iter"]["value"] == result["attempted"]
    other, _ = core.execute(cat, "impala_pong.tiny", 3, 0.2, False, time.time(), device="cpu")
    assert "episodes_per_iter" not in other["metrics"]


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(ROOT / "chipbench" / "run.py"), "--workload",
                        "a2c_cartpole.e4096_t64", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to run."""
    import shutil

    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload", "impala_pong.e64_t20",
                        "--seed", "7", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_traced_run_calls_every_per_layer_reader(tiny_root):
    """With `--trace 1` each per-layer reader of a cell is called; off the
    card those that need the device's trace find nothing and are left out."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        m["workloads"].append("a2c_cartpole.tiny")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = core.execute(catalog.Catalog(tiny_root), "a2c_cartpole.tiny", 5, 0.2, True,
                             time.time(), device="cpu")
    assert result["correct"] and result["attempted"] == core.TRACE_ITERATIONS
    assert set(result["metrics"]) == {"replay_host_ms"}
    assert "busy_s" not in result["device"] and "breakdown" not in result
