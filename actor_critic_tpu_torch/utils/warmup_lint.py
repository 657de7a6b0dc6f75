"""The warm-up registry's lint (the port's counterpart of the JAX package's
`analysis/warmup.py` and `scripts/check_warmup_registry.py`).

Every CUDA-graph capture site in the port's `algos/`, `envs/`,
`data_plane/` and `serving/` must belong to registered warm-up entries
(`utils/compile_cache.SITES`, each of its entries registered) or be in
`compile_cache.EXEMPT` with a reason; otherwise a new capture would run
at its first call, inside the loop, unseen by the warm-up. A capture site
is a call of `CapturedStep(`, `HostUpdate(`, `BlockedEval(` or
`loop.capture(`, or a `_capture` method (the serving engine lane's, the
blocked eval's), keyed "<module>.<enclosing top-level function or
class>". Stale `SITES` and `EXEMPT` keys (no such site any more) are
findings too.

    python -m actor_critic_tpu_torch.utils.warmup_lint   # exit 1, naming each finding
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, Optional

PACKAGE = Path(__file__).resolve().parent.parent
SCAN_DIRS = ("algos", "envs", "data_plane", "serving")
CAPTURE_CALLS = frozenset({"CapturedStep", "HostUpdate", "BlockedEval"})


def _is_capture_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in CAPTURE_CALLS
    if isinstance(f, ast.Attribute):
        if f.attr in CAPTURE_CALLS:
            return True
        return f.attr == "capture" and isinstance(f.value, ast.Name) and f.value.id == "loop"
    return False


def capture_sites(path: str | Path) -> list[tuple[str, int]]:
    """(enclosing top-level function or class, lineno) of each capture site
    in the file ("<module>" at module scope)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    sites: list[tuple[str, int]] = []

    def scan(node: ast.AST, enclosing: str) -> None:
        for child in ast.iter_child_nodes(node):
            name = enclosing
            top = isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            if top and enclosing == "<module>":
                name = child.name
            if _is_capture_call(child) or (
                    isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and child.name == "_capture"):
                sites.append((name if top and enclosing == "<module>" else enclosing,
                              child.lineno))
            scan(child, name)

    scan(tree, "<module>")
    return sites


def collect_sites(root: Path = PACKAGE,
                  scan_dirs: Iterable[str] = SCAN_DIRS) -> dict[str, list[tuple[str, int]]]:
    """Capture sites under `root`'s `scan_dirs`, by "<module>.<enclosing>":
    [(path relative to root, lineno), ...]."""
    out: dict[str, list[tuple[str, int]]] = {}
    for d in scan_dirs:
        for path in sorted((root / d).glob("*.py")):
            for enclosing, lineno in capture_sites(path):
                key = f"{path.stem}.{enclosing}"
                out.setdefault(key, []).append((str(path.relative_to(root)), lineno))
    return out


def findings(sites: dict[str, list[tuple[str, int]]], registered: Iterable[str],
             site_entries: dict[str, tuple[str, ...]], exempt: dict[str, str],
             check_stale: bool = True) -> list[str]:
    """Each site that neither belongs to registered entries nor is exempt
    (with a reason), and, with `check_stale`, each `site_entries`/`exempt`
    key that names no site."""
    registered = set(registered)
    out = []
    for key, locations in sorted(sites.items()):
        relpath, lineno = locations[0]
        if key in exempt and exempt[key].strip():
            continue
        entries = site_entries.get(key)
        if not entries:
            out.append(f"{relpath}:{lineno}: unregistered capture site {key!r}: name its warm-up "
                       "entries in compile_cache.SITES (registered with register_warmup) or add "
                       "it to compile_cache.EXEMPT with a reason")
            continue
        missing = [e for e in entries if e not in registered]
        if missing:
            out.append(f"{relpath}:{lineno}: capture site {key!r} belongs to unregistered "
                       f"entries {missing}")
    if check_stale:
        for key in sorted(set(site_entries) | set(exempt)):
            if key not in sites:
                out.append(f"stale compile_cache key {key!r}: no such capture site exists")
    return out


def main(argv: Optional[list[str]] = None) -> int:
    from actor_critic_tpu_torch.utils import compile_cache

    found = findings(collect_sites(), compile_cache.registered_warmups(), compile_cache.SITES,
                     compile_cache.EXEMPT)
    for line in found:
        print(line, file=sys.stderr)
    if not found:
        print(f"warm-up registry: every capture site of {', '.join(SCAN_DIRS)} belongs to a "
              "registered entry")
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
