"""torchlint core: findings, the check registry, suppressions and the
runner (the port's counterpart of `actor_critic_tpu/analysis/core.py`).

The analyzer is pure `ast` over source text: it never imports the modules
it scans (the one registered exception, the `warmup-registry` pass,
imports the registry it validates against, `utils/compile_cache.py`, not
the scanned files; see `analysis/warmup.py`). Every check therefore runs
on the CPU in milliseconds, with no card, no env pools and no import side
effects, and the analyzer imports neither torch nor JAX.

Vocabulary:

- A **check** is a registered pass. Module-scope checks run once per
  scanned file and receive a `ModuleInfo`; repo-scope checks run once per
  analysis and receive the whole `list[ModuleInfo]` (they correlate across
  files: thread spawns, collectives, the warm-up registry).
- A **Finding** names one defect at one source location. Its
  `fingerprint()` leaves the line NUMBER out (check + path + enclosing
  top-level function + stripped line text), so a baseline entry survives
  edits above the finding.
- A `# torchlint: disable=<check>[,<check>...]` comment on the flagged
  line suppresses those checks there (`disable=all` every check). A
  comment-only line suppresses the next simple statement. Suppressions
  are for findings right about the pattern and wrong about the hazard:
  the why goes in the same comment.
- `# torchlint: thread-owned=<role>` marks an attribute or module global
  whose compound writes all come from one thread role
  (`analysis/thread_model.py`); `# torchlint: hot-module` opts a module
  into the step-loop passes (`analysis/perf_model.py`).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import tokenize
from typing import Callable, Iterable, Optional

PRAGMA = "torchlint"

# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect at one location. `context` is the enclosing top-level
    function ("<module>" at module scope); `line_text` is the stripped
    source line: with check and path they form the line-number-free
    baseline fingerprint."""

    check: str
    path: str  # repo-relative, POSIX separators
    line: int
    col: int
    message: str
    context: str = "<module>"
    line_text: str = ""

    def fingerprint(self) -> str:
        return f"{self.check}:{self.path}:{self.context}:{self.line_text}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.check}] "
                f"{self.message} (in {self.context})")


class AnalysisError(Exception):
    """A scanned file could not be read or parsed, a check name is
    unknown, a baseline is malformed: the CLI exits 2 (a crash), apart from
    1 (findings)."""


# ---------------------------------------------------------------------------
# Parsed-module facts every check shares
# ---------------------------------------------------------------------------

# Anchored to the start of the comment: a comment QUOTING a pragma ("the
# `# torchlint: disable=...` below") registers nothing. Check names are
# comma-separated tokens; free text after them is the reason.
_DISABLE_RE = re.compile(
    rf"^#\s*{PRAGMA}:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")
_HOT_RE = re.compile(rf"^#\s*{PRAGMA}:\s*hot-module\b")
_THREAD_OWNED_RE = re.compile(rf"^#\s*{PRAGMA}:\s*thread-owned=([A-Za-z0-9_\-]+)")

_COMPOUND = (ast.If, ast.For, ast.AsyncFor, ast.While, ast.With, ast.AsyncWith, ast.Try,
             ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


class ModuleInfo:
    """One parsed source file plus the facts checks keep re-needing: parent
    links, enclosing-function names, per-line suppressions and import
    aliases."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        try:
            self.tree = ast.parse(source, filename=path)
        except (SyntaxError, ValueError) as e:
            raise AnalysisError(f"{relpath}: parse error: {e}") from e
        self._parents: dict[ast.AST, ast.AST] = {}
        _index_subtrees(self.tree, self._parents)
        self.hot_module = False  # set by the comment scan
        # lineno -> last line of the SIMPLE statement starting there, so a
        # standalone pragma covers a wrapped statement. Compound statements
        # are left out: a pragma before a block header covers the header
        # line only, never the block.
        self._stmt_end: dict[int, int] = {}
        for node in walk(self.tree):
            if isinstance(node, ast.stmt) and not isinstance(node, _COMPOUND):
                self._stmt_end[node.lineno] = max(self._stmt_end.get(node.lineno, node.lineno),
                                                  node.end_lineno or node.lineno)
        # lineno -> role of a `# torchlint: thread-owned=<role>` comment
        # (resolved to its attribute or global by analysis/thread_model.py).
        self.thread_owned: dict[int, str] = {}
        self._suppressions = self._scan_suppressions()
        self.aliases = self._scan_aliases()

    # -- structure ---------------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> str:
        """The TOP-LEVEL def the node sits in ("<module>" otherwise)."""
        name = "<module>"
        for anc in self.ancestors(node):
            if (isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and isinstance(self._parents.get(anc), ast.Module)):
                name = anc.name
        return name

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # -- suppressions ------------------------------------------------------

    def _scan_suppressions(self) -> dict[int, set[str]]:
        """line -> disabled check names. A trailing comment suppresses its
        own line; a comment-only line suppresses the next simple statement
        in full (findings anchor where the inner expression starts, which
        may be a continuation line), and before a compound header the
        header line only. Read through tokenize, so a pragma inside a
        string literal is none."""
        out: dict[int, set[str]] = {}

        def record(lineno: int, names: set[str]) -> None:
            names = {n for n in names if n}
            if self.lines[lineno - 1].strip().startswith("#"):
                for j in range(lineno + 1, len(self.lines) + 1):
                    nxt = self.lines[j - 1].strip()
                    if nxt and not nxt.startswith("#"):
                        for k in range(j, self._stmt_end.get(j, j) + 1):
                            out.setdefault(k, set()).update(names)
                        return
                return
            out.setdefault(lineno, set()).update(names)

        def scan(lineno: int, text: str) -> None:
            if _HOT_RE.match(text):
                self.hot_module = True
            owned = _THREAD_OWNED_RE.match(text)
            if owned:
                self.thread_owned[lineno] = owned.group(1)
            m = _DISABLE_RE.match(text)
            if m:
                record(lineno, {n.strip() for n in m.group(1).split(",")})

        try:
            lines = iter(ln + "\n" for ln in self.lines)
            for tok in tokenize.generate_tokens(lines.__next__):
                if tok.type == tokenize.COMMENT:
                    scan(tok.start[0], tok.string)
        except (tokenize.TokenizeError, IndentationError, SyntaxError):
            # Comment-looking raw lines; a string literal can then only
            # over-suppress one line.
            for i, ln in enumerate(self.lines, 1):
                if ln.lstrip().startswith("#"):
                    scan(i, ln.lstrip())
        return out

    def suppressed(self, lineno: int, check: str) -> bool:
        names = self._suppressions.get(lineno, ())
        if check in names or "all" in names:
            return True
        # `disable=host-sync` suppresses its successor, transfer-discipline.
        return any(alias in names for alias, target in CHECK_ALIASES.items() if target == check)

    # -- imports -----------------------------------------------------------

    def _scan_aliases(self) -> dict[str, str]:
        """local name -> canonical dotted name ("np" -> "numpy", "dist" ->
        "torch.distributed", "F" -> "torch.nn.functional", "CapturedStep"
        -> "actor_critic_tpu_torch.algos.loop.CapturedStep")."""
        out: dict[str, str] = {}
        for node in walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def scope_of(self, node: ast.AST) -> ast.AST:
        """The top-level def containing `node`, or the module: the
        statement-ordered unit the dataflow passes share."""
        scope: ast.AST = self.tree
        for anc in self.ancestors(node):
            if (isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and isinstance(self.parent(anc), ast.Module)):
                scope = anc
        return scope

    def exclusive_branches(self, a: ast.AST, b: ast.AST) -> bool:
        """Whether `a` and `b` sit in different arms of a common `if` (at
        most one of them runs)."""
        pa, pb = self._branch_map(a), self._branch_map(b)
        return any(pa[key] != pb[key] for key in pa.keys() & pb.keys())

    def _branch_map(self, node: ast.AST) -> dict[int, str]:
        out: dict[int, str] = {}
        child = node
        for anc in self.ancestors(node):
            if isinstance(anc, ast.If):
                if any(child is n for n in anc.body):
                    out[id(anc)] = "body"
                elif any(child is n for n in anc.orelse):
                    out[id(anc)] = "orelse"
            child = anc
        return out

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of an expression, alias-resolved at the
        root (`dist.all_reduce` -> "torch.distributed.all_reduce"); None
        for anything but a Name/Attribute chain."""
        parts: list[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        parts.append(self.aliases.get(cur.id, cur.id))
        return ".".join(reversed(parts))


def _index_subtrees(tree: ast.AST, parents: dict) -> None:
    """One preorder pass over `tree`: every node's parent, and on every
    node the span of its subtree in the preorder list, so that `walk` of
    any node is a slice instead of a new traversal (the passes walk the
    same subtrees many times)."""
    nodes: list[ast.AST] = []
    stack: list[tuple[ast.AST, bool]] = [(tree, False)]
    starts: list[int] = []
    while stack:
        node, done = stack.pop()
        if done:
            node._torchlint_span = (nodes, starts.pop(), len(nodes))
            continue
        starts.append(len(nodes))
        nodes.append(node)
        stack.append((node, True))
        children = list(ast.iter_child_nodes(node))
        for child in children:
            parents[child] = node
        stack.extend((child, False) for child in reversed(children))


def walk(node: ast.AST) -> list[ast.AST]:
    """Every node of `node`'s subtree, itself first, in source order:
    `ast.walk`'s nodes (in preorder), from the index `ModuleInfo` built."""
    span = getattr(node, "_torchlint_span", None)
    if span is None:
        return list(ast.walk(node))
    nodes, start, end = span
    return nodes[start:end]


def target_names(tgt: ast.AST, roots: bool = False) -> list[str]:
    """Bare names an assignment target binds (unpacking included). With
    `roots`, subscript and attribute targets give their base name too
    (`state["k"] = ...` mutates `state`)."""
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return [n for e in tgt.elts for n in target_names(e, roots)]
    if roots:
        while isinstance(tgt, (ast.Subscript, ast.Attribute)):
            tgt = tgt.value
        if isinstance(tgt, ast.Name):
            return [tgt.id]
    return []


def terminal_name(func: ast.AST) -> Optional[str]:
    """`f` of `f(...)`, `mod.f(...)` and `obj.attr.f(...)`."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def walk_local(root: ast.AST):
    """`ast.walk` of `root` without descending into nested defs, lambdas or
    classes (their bodies run later, or elsewhere)."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                                  ast.ClassDef)):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# Check registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    doc: str  # one line, printed by --list-checks
    fn: Callable
    scope: str = "module"  # "module" | "repo"


_CHECKS: dict[str, Check] = {}

# An absorbed check keeps its name: `--select host-sync` runs
# transfer-discipline, and `disable=host-sync` suppresses it.
CHECK_ALIASES: dict[str, str] = {"host-sync": "transfer-discipline"}


def resolve_check_name(name: str) -> str:
    return CHECK_ALIASES.get(name, name)


def register_check(name: str, doc: str, scope: str = "module"):
    """Decorator registering `fn(module_info) -> list[Finding]` (module
    scope) or `fn(list[ModuleInfo]) -> list[Finding]` (repo scope)."""

    def deco(fn):
        _CHECKS[name] = Check(name=name, doc=doc, fn=fn, scope=scope)
        return fn

    return deco


def registered_checks() -> tuple[Check, ...]:
    _ensure_builtin_checks()
    return tuple(_CHECKS[k] for k in sorted(_CHECKS))


def _ensure_builtin_checks() -> None:
    # Each pass module registers itself on import; lazy, so that importing
    # core alone stays cheap.
    from actor_critic_tpu_torch.analysis import (  # noqa: F401
        concurrency,
        distributed,
        donation,
        perf,
        prng,
        recompile,
        tracer_leak,
        warmup,
    )


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def iter_python_files(paths: Iterable[str], repo_root: str) -> list[str]:
    """Files and directories expanded to sorted .py paths (skipping
    __pycache__ and hidden directories). A missing path raises: a typo'd
    path must not read as a clean run."""
    out: list[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(repo_root, p)
        if os.path.isfile(ap):
            out.append(ap)
        elif os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d != "__pycache__" and not d.startswith(".")]
                out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                           if f.endswith(".py"))
        else:
            raise AnalysisError(f"no such file or directory: {p}")
    return out


def load_modules(paths: Iterable[str], repo_root: str) -> list[ModuleInfo]:
    modules: list[ModuleInfo] = []
    for path in iter_python_files(paths, repo_root):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            raise AnalysisError(f"{path}: {e}") from e
        modules.append(ModuleInfo(path, os.path.relpath(path, repo_root), source))
    return modules


def run_checks(modules: list[ModuleInfo], checks: Optional[Iterable[str]] = None,
               skip: Iterable[str] = ()) -> list[Finding]:
    """Every finding over the parsed modules, suppressions applied, sorted
    by location. `checks` selects by name (aliases resolved), `skip` drops
    names from the selection; an unknown name raises."""
    _ensure_builtin_checks()
    selected = (list(dict.fromkeys(resolve_check_name(c) for c in checks))
                if checks is not None else sorted(_CHECKS))
    skip = [resolve_check_name(c) for c in skip]
    unknown = [c for c in [*selected, *skip] if c not in _CHECKS]
    if unknown:
        raise AnalysisError(f"unknown check(s): {', '.join(sorted(set(unknown)))} "
                            f"(have: {', '.join(sorted(_CHECKS))})")
    selected = [c for c in selected if c not in set(skip)]

    by_rel = {m.relpath: m for m in modules}
    findings: list[Finding] = []
    for name in selected:
        check = _CHECKS[name]
        raw = check.fn(modules) if check.scope == "repo" else [
            f for m in modules for f in check.fn(m)]
        for f in raw:
            mod = by_rel.get(f.path)
            if mod is not None:
                if not f.line_text:
                    f = dataclasses.replace(f, line_text=mod.line_text(f.line))
                if mod.suppressed(f.line, f.check):
                    continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    return findings


def analyze_paths(paths: Iterable[str], repo_root: str, checks: Optional[Iterable[str]] = None,
                  skip: Iterable[str] = ()) -> list[Finding]:
    """Parse and run in one call: the API the CLI and the tests drive."""
    return run_checks(load_modules(paths, repo_root), checks=checks, skip=skip)
