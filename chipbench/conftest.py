"""pytest settings of the benchmark's own tests (`python -m pytest chipbench/tests`).

The `card` marker is registered here, since the repository's pytest.ini
(with `--strict-markers`) lists only the repository's own. Whether a card
is present is decided inside the `card` fixture, never at import or
collection, so every worker collects the same tests.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Small traffic for the CPU tests: the cells' own paths at a size a test
# run holds.
TINY = {
    "a2c_cartpole": {"num_envs": 32, "rollout_steps": 8},
    "impala_pong": {"num_envs": 8, "rollout_steps": 5},
}
# The cell whose limits each tiny fixture cell is held to.
LIMITS_OF = {"a2c_cartpole": "a2c_cartpole.e4096_t64", "impala_pong": "impala_pong.e64_t20"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    """Skip the test unless a CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def make_root(tmp: Path) -> Path:
    """A checkout root in `tmp` with the benchmark's files and BENCHMARK.json,
    plus one tiny cell per configuration (`<config>.tiny`), added as files
    and entries as a later change would add them."""
    shutil.copytree(ROOT / "chipbench", tmp / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config, params in TINY.items():
        name = f"{config}.tiny"
        (tmp / "chipbench" / "traffic" / f"tiny_{config}.json").write_text(json.dumps(params))
        shutil.copy(tmp / "chipbench" / "limits" / f"{LIMITS_OF[config]}.json",
                    tmp / "chipbench" / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": config, "traffic": f"tiny_{config}",
                                   "chips": 1, "why": "a test's tiny cell"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
