"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name; the references import nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "actor_critic_tpu"}
FILES = sorted((ROOT / "chipbench").rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "chipbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "actor_critic_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch", "chipbench"}


def test_the_forbidden_check_compares_whole_names():
    from chipbench import core

    assert "actor_critic_tpu_torch" not in core.forbidden_loaded()
    assert set(core.FORBIDDEN_MODULES) == FORBIDDEN


def test_a_run_loads_no_jax(tiny_root):
    """A whole CPU run in a fresh process leaves none of the names in sys.modules."""
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1]);"
        "from chipbench import core, catalog;"
        "cat = catalog.Catalog(sys.argv[2]);"
        "core.execute(cat, 'a2c_cartpole.tiny', 1, 0.1, False, time.time(), device='cpu');"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(core.FORBIDDEN_MODULES)))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(tiny_root)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
