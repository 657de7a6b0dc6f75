"""warmup-registry: every CUDA-graph capture site in the port's `algos/`,
`envs/`, `data_plane/` and `serving/` belongs to registered warm-up entries
(`utils/compile_cache.SITES`, each entry registered) or is in
`compile_cache.EXEMPT` with a reason (the port's counterpart of
`actor_critic_tpu/analysis/warmup.py`). Otherwise a new capture runs at its
first call, inside the loop, unseen by the warm-up. Stale `SITES` and
`EXEMPT` keys (no such site any more) are findings too.

A capture site is a call of `CapturedStep(`, `HostUpdate(`, `BlockedEval(`
or `loop.capture(`, or a `_capture` method (the serving engine lane's, the
blocked eval's), keyed "<module>.<enclosing top-level function or class>".

This is the one pass that imports project code: the registry
(`utils/compile_cache.py`), lazily, inside the check, so every other pass
and any `--skip warmup-registry` run stays import-free. `utils/warmup_lint.py`
is the standalone CLI over the same functions:

    python -m actor_critic_tpu_torch.utils.warmup_lint   # exit 1, naming each finding
"""

from __future__ import annotations

import ast
import os
import sys
from pathlib import Path
from typing import Iterable, Optional

from actor_critic_tpu_torch.analysis.core import Finding, ModuleInfo, register_check

CHECK = "warmup-registry"

PACKAGE = Path(__file__).resolve().parent.parent
SCAN_DIRS = ("algos", "envs", "data_plane", "serving")
CAPTURE_CALLS = frozenset({"CapturedStep", "HostUpdate", "BlockedEval"})
_EXEMPT_HOME = "actor_critic_tpu_torch/utils/compile_cache.py"


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


def sites_in_tree(tree: ast.AST) -> list[tuple[str, int]]:
    """(enclosing top-level function or class, lineno) of each capture site
    ("<module>" at module scope)."""
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


def capture_sites(path: str | Path) -> list[tuple[str, int]]:
    """The capture sites of one file."""
    return sites_in_tree(ast.parse(Path(path).read_text(), filename=str(path)))


def collect_sites(root: Path = PACKAGE,
                  scan_dirs: Iterable[str] = SCAN_DIRS) -> dict[str, list[tuple[str, int]]]:
    """Capture sites under `root`'s `scan_dirs`, by "<module>.<enclosing>":
    [(path relative to root, lineno), ...]."""
    out: dict[str, list[tuple[str, int]]] = {}
    for d in scan_dirs:
        for path in sorted((Path(root) / d).glob("*.py")):
            for enclosing, lineno in capture_sites(path):
                out.setdefault(f"{path.stem}.{enclosing}", []).append(
                    (str(path.relative_to(root)), lineno))
    return out


def problems(sites: dict[str, list[tuple[str, int]]], registered: Iterable[str],
             site_entries: dict[str, tuple[str, ...]], exempt: dict[str, str],
             check_stale: bool = True) -> list[tuple[str, int, str, str]]:
    """(path, line, key, text) of each site that neither belongs to
    registered entries nor is exempt with a reason, and, with
    `check_stale`, of each `site_entries`/`exempt` key naming no site (path
    "", line 0)."""
    registered = set(registered)
    out = []
    for key, locations in sorted(sites.items()):
        relpath, lineno = locations[0]
        if key in exempt and exempt[key].strip():
            continue
        entries = site_entries.get(key)
        if not entries:
            out.append((relpath, lineno, key,
                        f"unregistered capture site {key!r}: name its warm-up entries in "
                        "compile_cache.SITES (registered with register_warmup) or add it to "
                        "compile_cache.EXEMPT with a reason"))
            continue
        missing = [e for e in entries if e not in registered]
        if missing:
            out.append((relpath, lineno, key,
                        f"capture site {key!r} belongs to unregistered entries {missing}"))
    if check_stale:
        for key in sorted(set(site_entries) | set(exempt)):
            if key not in sites:
                out.append(("", 0, key,
                            f"stale compile_cache key {key!r}: no such capture site exists"))
    return out


def findings(sites: dict[str, list[tuple[str, int]]], registered: Iterable[str],
             site_entries: dict[str, tuple[str, ...]], exempt: dict[str, str],
             check_stale: bool = True) -> list[str]:
    """`problems` as the standalone lint prints them ("path:line: text")."""
    return [f"{path}:{line}: {text}" if path else text
            for path, line, _, text in problems(sites, registered, site_entries, exempt,
                                                check_stale)]


def load_registry() -> tuple[tuple[str, ...], dict[str, tuple[str, ...]], dict[str, str]]:
    """(registered entries, SITES, EXEMPT) of the live registry."""
    from actor_critic_tpu_torch.utils import compile_cache

    return (tuple(compile_cache.registered_warmups()), dict(compile_cache.SITES),
            dict(compile_cache.EXEMPT))


def _package_prefix(modules: list[ModuleInfo]) -> Optional[str]:
    """"<...>actor_critic_tpu_torch/" as the scanned relpaths spell it."""
    for m in modules:
        i = m.relpath.find("actor_critic_tpu_torch/")
        if i >= 0:
            return m.relpath[: i + len("actor_critic_tpu_torch/")]
    return None


def sites_from_modules(modules: Iterable[ModuleInfo], prefix: str,
                       scan_dirs: Iterable[str] = SCAN_DIRS) -> dict[str, list[tuple[str, int]]]:
    """Capture sites of the scanned modules under `prefix`'s `scan_dirs`
    (one level: `algos/x.py`, not `algos/sub/x.py`), keyed as
    `collect_sites` keys them, located by repo-relative path."""
    out: dict[str, list[tuple[str, int]]] = {}
    for mod in modules:
        for d in scan_dirs:
            base = f"{prefix.rstrip('/')}/{d}/" if prefix else f"{d}/"
            rest = mod.relpath[len(base):] if mod.relpath.startswith(base) else None
            if rest is None or "/" in rest:
                continue
            for enclosing, lineno in sites_in_tree(mod.tree):
                out.setdefault(f"{rest[:-3]}.{enclosing}", []).append((mod.relpath, lineno))
    return out


def site_findings(sites: dict[str, list[tuple[str, int]]], registered: Iterable[str],
                  site_entries: dict[str, tuple[str, ...]], exempt: dict[str, str],
                  check_stale: bool = True) -> list[Finding]:
    """`problems` as Findings (a stale key is located at the registry)."""
    return [Finding(CHECK, path or _EXEMPT_HOME, line or 1, 0, text,
                    key.split(".", 1)[-1] if path else "<module>",
                    line_text="" if path else f"compile_cache[{key!r}]")
            for path, line, key, text in problems(sites, registered, site_entries, exempt,
                                                  check_stale)]


def _full_scan(modules: list[ModuleInfo], prefix: str) -> bool:
    """Whether the scan covers every .py file of the scan dirs on disk (only
    then can a key be called stale)."""
    scanned = {m.relpath for m in modules}
    mod = next(m for m in modules if m.relpath.startswith(prefix))
    root = mod.path[: len(mod.path) - len(mod.relpath)] or "."
    for d in SCAN_DIRS:
        directory = os.path.join(root, prefix, d)
        if not os.path.isdir(directory):
            continue
        for fname in os.listdir(directory):
            if fname.endswith(".py") and f"{prefix}{d}/{fname}" not in scanned:
                return False
    return True


@register_check(
    CHECK,
    "CUDA-graph capture sites in algos//envs//data_plane//serving/ without registered "
    "warm-up entries or an EXEMPT reason (a capture at the first dispatch)",
    scope="repo",
)
def check_warmup_registry(modules: list[ModuleInfo]) -> list[Finding]:
    prefix = _package_prefix(modules)
    if prefix is None:
        return []  # the scan does not cover the package: nothing to hold
    sites = sites_from_modules(modules, prefix)
    if not sites:
        return []
    registered, site_entries, exempt = load_registry()
    return site_findings(sites, registered, site_entries, exempt,
                         check_stale=_full_scan(modules, prefix))


def main(argv: Optional[list[str]] = None) -> int:
    """The standalone lint: exit 0 when every capture site is covered, 1
    with each finding on stderr otherwise."""
    registered, site_entries, exempt = load_registry()
    found = findings(collect_sites(), registered, site_entries, exempt)
    for line in found:
        print(line, file=sys.stderr)
    if not found:
        print(f"warm-up registry: every capture site of {', '.join(SCAN_DIRS)} belongs to a "
              "registered entry")
    return 1 if found else 0
