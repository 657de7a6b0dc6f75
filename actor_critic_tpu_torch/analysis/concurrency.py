"""Concurrency passes: lock-discipline, publish-aliasing,
check-then-act (the port's counterpart of `actor_critic_tpu/analysis/concurrency.py`).

Each is grounded in a concurrency bug of the actor-learner pipeline:

- **lock-discipline** — the global open-span stack corrupted by
  interleaved actor threads: a COMPOUND write (aug-assign, container
  mutation, subscript store) to state shared across thread roles must
  happen under a held lock or carry a `# torchlint: thread-owned=<role>`
  annotation with the audited reason. Plain reference stores and plain
  reads are GIL-atomic and stay out of scope (thread_model.py documents
  the model assumptions).
- **publish-aliasing** — the zero-copy queue-slot race: an array or
  tensor handed to a cross-thread channel (`TrajQueue.put`,
  `PolicyPublisher.publish`, a pipe's `send`) must be a snapshot, not a
  view of a preallocated, recycled slot (a numpy slot, a pinned staging
  tensor of `BlockBuffers`); and on the consumer side, `np.asarray` /
  `torch.from_numpy` / `torch.as_tensor` (which alias host memory
  zero-copy) over a block that is `release`d back to a slot pool
  in the same scope reads memory the next `put` rewrites.
- **check-then-act** — unlocked read-test-write windows on shared
  flags/counters (`if self._closed: return` ... `self._closed = True`):
  two threads pass the test before either writes. Double-checked
  locking (the WRITE under the lock) is recognized and stays clean.

lock-discipline and check-then-act are repo-scope: they consult the
whole-repo `ThreadModel` (thread entry points resolved across files).
publish-aliasing is per-module. A write that is part of a
check-then-act pair is reported by check-then-act only, so one defect
never double-flags.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from actor_critic_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register_check,
    target_names,
    walk,
)
from actor_critic_tpu_torch.analysis.thread_model import (
    CALLER_ROLE,
    MUTATING_METHODS,
    ClassModel,
    ThreadModel,
    self_attr,
)

LOCK_DISCIPLINE = "lock-discipline"
PUBLISH_ALIASING = "publish-aliasing"
CHECK_THEN_ACT = "check-then-act"

# Cross-thread channel method names (TrajQueue.put, PolicyPublisher
# .publish, DeviceTrajRing.put, multiprocessing pipe send).
CHANNEL_METHODS = {"put", "put_nowait", "publish", "send", "send_bytes"}

# numpy and torch constructors that yield preallocated storage a producer
# refills (the port's pinned staging tensors among them).
_ALLOCATORS = {
    f"{lib}.{n}"
    for lib in ("numpy", "torch")
    for n in (
        "zeros", "empty", "ones", "full", "zeros_like", "empty_like",
        "ones_like", "full_like", "frombuffer",
    )
}

# Wrapping any of these around a hazard source makes it a snapshot.
_SNAPSHOT_DOTTED = {
    "numpy.array", "numpy.copy", "copy.deepcopy", "torch.tensor", "torch.clone",
}
_SNAPSHOT_METHODS = {"copy", "tobytes", "clone"}

# Possibly-zero-copy host-array coercions the consumer-side rule flags.
_ALIASING_DOTTED = {"numpy.asarray", "numpy.frombuffer", "torch.from_numpy",
                    "torch.as_tensor", "torch.asarray"}


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------


class _Access:
    """One compound write to a `self.<attr>` or module-global container/
    counter: the interleaving-sensitive operation class."""

    __slots__ = ("node", "name", "method", "kind")

    def __init__(self, node: ast.AST, name: str, method: str, kind: str):
        self.node = node      # anchor for the finding
        self.name = name      # attribute or global name
        self.method = method  # enclosing method name ("" at module level)
        self.kind = kind      # human-readable operation description


def _under_lock(
    mod: ModuleInfo,
    node: ast.AST,
    lock_attrs: Iterable[str],
    module_locks: Iterable[str],
) -> bool:
    """Whether `node` sits inside a `with self.<lock>:` /
    `with <module_lock>:` context, or in a method whose name ends in
    `_locked` (the held-by-contract naming convention: such helpers are
    only called with the lock already taken)."""
    lock_attrs = set(lock_attrs)
    module_locks = set(module_locks)
    for anc in mod.ancestors(node):
        if isinstance(
            anc, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) and anc.name.endswith("_locked"):
            return True
        if not isinstance(anc, (ast.With, ast.AsyncWith)):
            continue
        for item in anc.items:
            expr = item.context_expr
            attr = self_attr(expr)
            if attr is not None and attr in lock_attrs:
                return True
            if isinstance(expr, ast.Name) and expr.id in module_locks:
                return True
    return False


def _enclosing_function_node(
    mod: ModuleInfo, node: ast.AST
) -> Optional[ast.AST]:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _enclosing_method(cls: ClassModel, node: ast.AST, mod: ModuleInfo) -> str:
    for anc in mod.ancestors(node):
        if (
            isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
            and mod.parent(anc) is cls.node
        ):
            return anc.name
    return ""


def _compound_writes_in(
    mod: ModuleInfo, root: ast.AST, cls: Optional[ClassModel]
) -> list[_Access]:
    """Compound writes inside `root`. With `cls`, `self.<attr>` targets;
    without, bare-Name targets (module-global candidates — the caller
    filters by what the scope actually binds locally)."""
    out: list[_Access] = []

    def method_of(node: ast.AST) -> str:
        return _enclosing_method(cls, node, mod) if cls else ""

    for node in walk(root):
        if isinstance(node, ast.AugAssign):
            tgt = node.target
            # `self.x += 1`, `GLOBAL += 1`, and the subscripted forms
            # (`STATS["hits"] += 1`) are all read-modify-write.
            if isinstance(tgt, ast.Subscript):
                tgt = tgt.value
            name = _target_name(tgt, cls)
            if name:
                out.append(
                    _Access(node, name, method_of(node), "augmented write")
                )
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                if not isinstance(tgt, ast.Subscript):
                    continue
                name = _target_name(tgt.value, cls)
                if name:
                    out.append(
                        _Access(tgt, name, method_of(tgt), "subscript store")
                    )
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            if node.func.attr not in MUTATING_METHODS:
                continue
            name = _target_name(node.func.value, cls)
            if name:
                out.append(
                    _Access(
                        node, name, method_of(node),
                        f"`.{node.func.attr}()` mutation",
                    )
                )
    return out


def _target_name(node: ast.AST, cls: Optional[ClassModel]) -> Optional[str]:
    """`self.<attr>` → attr (class mode); bare Name → id (module mode)."""
    if cls is not None:
        return self_attr(node)
    return node.id if isinstance(node, ast.Name) else None


def _attr_touches(cls: ClassModel, mod: ModuleInfo) -> dict[str, set[str]]:
    """attr -> methods that read or write it (any access counts toward
    role reach; only compound writes are flagged)."""
    out: dict[str, set[str]] = {}
    for node in walk(cls.node):
        attr = self_attr(node)
        if attr is None:
            continue
        method = _enclosing_method(cls, node, mod)
        if method:
            out.setdefault(attr, set()).add(method)
    return out


def _module_global_names(mod: ModuleInfo) -> set[str]:
    names: set[str] = set()
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                names.update(target_names(tgt))
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            names.update(target_names(stmt.target))
    return names


def _locally_bound(scope: ast.AST, name: str) -> bool:
    """Whether a function scope binds `name` locally (so a reference is
    NOT the module global), unless it declares it `global`."""
    if isinstance(scope, ast.Module):
        return False
    bound, declared_global = _bindings(scope)
    return name in bound and name not in declared_global


def _bindings(scope: ast.AST) -> tuple[set[str], set[str]]:
    """(names the scope binds, names it declares `global`), computed once
    per scope node (nested defs included, as the walk always did)."""
    cached = getattr(scope, "_torchlint_bindings", None)
    if cached is not None:
        return cached
    bound: set[str] = set()
    declared_global: set[str] = set()
    for node in walk(scope):
        if isinstance(node, ast.Global):
            declared_global.update(node.names)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                bound.update(target_names(t))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            bound.update(target_names(node.target))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            bound.update(target_names(node.target))
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        args = scope.args
        bound.update(a.arg for a in (
            args.posonlyargs + args.args + args.kwonlyargs
            + ([args.vararg] if args.vararg else [])
            + ([args.kwarg] if args.kwarg else [])
        ))
    scope._torchlint_bindings = (bound, declared_global)
    return bound, declared_global


# ---------------------------------------------------------------------------
# check-then-act pair detection (shared with lock-discipline for dedup)
# ---------------------------------------------------------------------------


class _CtaPair:
    __slots__ = ("test_if", "writes", "name", "scope_desc")

    def __init__(self, test_if: ast.If, writes: list[ast.AST], name: str,
                 scope_desc: str):
        self.test_if = test_if
        self.writes = writes  # EVERY unlocked write in the window —
        #                       lock-discipline excludes them all, so
        #                       one defect never double-flags
        self.name = name
        self.scope_desc = scope_desc  # "self._closed" / "_REGISTRY"

    @property
    def write(self) -> ast.AST:
        return self.writes[0]  # anchor for the finding message


def _reads_in(node: ast.AST, cls: Optional[ClassModel]) -> set[str]:
    """Names/attrs the expression reads, in the requested mode."""
    out: set[str] = set()
    for sub in walk(node):
        name = _target_name(sub, cls)
        if name:
            out.add(name)
    return out


def _writes_to(
    stmt: ast.AST, name: str, cls: Optional[ClassModel]
) -> list[ast.AST]:
    """Write sites (plain OR compound) to attr/global `name` in `stmt`."""
    out: list[ast.AST] = []
    for node in walk(stmt):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if _target_name(tgt, cls) == name:
                    out.append(node)
                elif isinstance(tgt, ast.Subscript) and _target_name(
                    tgt.value, cls
                ) == name:
                    out.append(node)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if node.value is None and isinstance(node, ast.AnnAssign):
                continue
            tgt = node.target
            if _target_name(tgt, cls) == name:
                out.append(node)
            elif isinstance(tgt, ast.Subscript) and _target_name(
                tgt.value, cls
            ) == name:
                out.append(node)
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            if node.func.attr in MUTATING_METHODS and _target_name(
                node.func.value, cls
            ) == name:
                out.append(node)
    return out


_EXITS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _cta_pairs_in_scope(
    mod: ModuleInfo,
    scope: ast.AST,
    names: set[str],
    cls: Optional[ClassModel],
    lock_attrs: set[str],
    module_locks: set[str],
) -> list[_CtaPair]:
    """Unlocked test-then-write pairs on `names` within one function:
    the `if` reads the flag outside a lock, and an unlocked write to the
    same flag sits in the if body/orelse — or anywhere after an if whose
    body exits early (the `if done: return` guard shape)."""
    pairs: list[_CtaPair] = []
    for node in walk(scope):
        if not isinstance(node, ast.If):
            continue
        if _under_lock(mod, node, lock_attrs, module_locks):
            continue
        tested = _reads_in(node.test, cls) & names
        for name in sorted(tested):
            candidates: list[ast.AST] = []
            for stmt in node.body + node.orelse:
                candidates.extend(_writes_to(stmt, name, cls))
            if node.body and isinstance(node.body[-1], _EXITS):
                end = node.end_lineno or node.lineno
                for stmt in walk(scope):
                    if (
                        isinstance(stmt, ast.stmt)
                        and stmt.lineno > end
                    ):
                        candidates.extend(_writes_to(stmt, name, cls))
            unlocked = [
                w
                for w in candidates
                if not _under_lock(mod, w, lock_attrs, module_locks)
            ]
            if unlocked:
                desc = f"self.{name}" if cls else name
                pairs.append(_CtaPair(node, unlocked, name, desc))
    return pairs


def _class_cta_pairs(
    model: ThreadModel, mod: ModuleInfo, cls: ClassModel
) -> list[_CtaPair]:
    names = {
        a
        for a in _attr_touches(cls, mod)
        if a not in cls.lock_attrs and a not in cls.owned_attrs
    }
    module_locks = model.module_locks.get(mod.relpath, set())
    pairs: list[_CtaPair] = []
    for mname, fn in cls.methods().items():
        if mname == "__init__":
            continue
        pairs.extend(
            _cta_pairs_in_scope(
                mod, fn, names, cls, cls.lock_attrs, module_locks
            )
        )
    return pairs


def _module_cta_pairs(
    model: ThreadModel, mod: ModuleInfo
) -> list[_CtaPair]:
    """Check-then-act on module GLOBALS, from any function or method in
    a threaded module (a shared span stack is a module global mutated
    from class methods — depth must not matter)."""
    if not model.is_threaded_module(mod):
        return []
    module_locks = model.module_locks.get(mod.relpath, set())
    names = {
        n
        for n in _module_global_names(mod)
        if n not in module_locks
        and (mod.relpath, n) not in model.owned_globals
    }
    pairs: list[_CtaPair] = []
    seen: set[tuple[int, str]] = set()
    for fn in walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scoped = {n for n in names if not _locally_bound(fn, n)}
        if not scoped:
            continue
        cls = model.class_model(mod, fn)
        lock_attrs = cls.lock_attrs if cls else set()
        for pair in _cta_pairs_in_scope(
            mod, fn, scoped, None, lock_attrs, module_locks
        ):
            # Nested defs are walked from every enclosing function;
            # report each (if, name) pair once.
            key = (id(pair.test_if), pair.name)
            if key not in seen:
                seen.add(key)
                pairs.append(pair)
    return pairs


def _all_cta_pairs(model: ThreadModel, mod: ModuleInfo) -> list[_CtaPair]:
    pairs = _module_cta_pairs(model, mod)
    for (relpath, _), cls in model.classes.items():
        if relpath != mod.relpath:
            continue
        if not (cls.threaded or cls.lock_attrs):
            continue
        pairs.extend(_class_cta_pairs(model, mod, cls))
    return pairs


# Single-entry cache: lock-discipline and check-then-act are separate
# registered checks but need the SAME thread model and CTA pairs (the
# latter for findings, the former only to de-duplicate) — without
# sharing, every lint run would derive the repo-wide facts twice. The
# cached modules list is held strongly, so the id()-keyed entry can
# never alias a garbage-collected ModuleInfo.
_SHARED: dict = {}


def _shared_analysis(
    modules: list[ModuleInfo],
) -> tuple[ThreadModel, dict[int, list[_CtaPair]]]:
    key = tuple(id(m) for m in modules)
    entry = _SHARED.get("entry")
    if entry is not None and entry[0] == key:
        return entry[1], entry[2]
    model = ThreadModel(modules)
    pairs = {id(m): _all_cta_pairs(model, m) for m in modules}
    _SHARED["entry"] = (key, model, pairs, list(modules))
    return model, pairs


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------


@register_check(
    LOCK_DISCIPLINE,
    "compound write to cross-thread shared state outside its lock "
    "(a shared span stack); audited single-writer attrs carry "
    "`# torchlint: thread-owned=<role>`",
    scope="repo",
)
def check_lock_discipline(modules: list[ModuleInfo]) -> list[Finding]:
    model, pairs = _shared_analysis(modules)
    findings: list[Finding] = []
    for mod in modules:
        cta_writes = {
            id(w) for p in pairs[id(mod)] for w in p.writes
        }
        findings.extend(_class_lock_findings(model, mod, cta_writes))
        findings.extend(_module_lock_findings(model, mod, cta_writes))
    return findings


def _class_lock_findings(
    model: ThreadModel, mod: ModuleInfo, cta_writes: set[int]
) -> list[Finding]:
    findings: list[Finding] = []
    module_locks = model.module_locks.get(mod.relpath, set())
    for (relpath, _), cls in model.classes.items():
        if relpath != mod.relpath or not (cls.threaded or cls.lock_attrs):
            continue
        touches = _attr_touches(cls, mod)
        for acc in _compound_writes_in(mod, cls.node, cls):
            if acc.method in ("", "__init__"):
                continue  # pre-publication (happens-before Thread.start)
            if acc.name in cls.lock_attrs or acc.name in cls.owned_attrs:
                continue
            if id(acc.node) in cta_writes:
                continue  # reported by check-then-act
            if _under_lock(mod, acc.node, cls.lock_attrs, module_locks):
                continue
            if cls.lock_attrs:
                shared = True  # a lock-owning class declares shared state
            else:
                roles: set[str] = set()
                for m in touches.get(acc.name, ()):
                    roles |= cls.roles_of(m)
                writer_roles = cls.roles_of(acc.method)
                shared = len(roles) > 1 or (
                    writer_roles != {CALLER_ROLE}
                    and not acc.name.startswith("_")
                )
            if not shared:
                continue
            lock_hint = (
                f"`with self.{sorted(cls.lock_attrs)[0]}:`"
                if cls.lock_attrs
                else "a lock"
            )
            findings.append(
                Finding(
                    LOCK_DISCIPLINE, mod.relpath,
                    acc.node.lineno, acc.node.col_offset,
                    f"{acc.kind} to `self.{acc.name}` in "
                    f"`{cls.name}.{acc.method}` outside {lock_hint} — the "
                    "attribute is reachable from more than one thread "
                    "role, and a compound write interleaves; hold the "
                    "lock, or annotate the attribute "
                    "`# torchlint: thread-owned=<role>` with the audited "
                    "reason",
                    mod.enclosing_function(acc.node),
                )
            )
    return findings


def _module_lock_findings(
    model: ThreadModel, mod: ModuleInfo, cta_writes: set[int]
) -> list[Finding]:
    if not model.is_threaded_module(mod):
        return []
    findings: list[Finding] = []
    module_locks = model.module_locks.get(mod.relpath, set())
    globals_ = _module_global_names(mod) - module_locks
    for acc in _compound_writes_in(mod, mod.tree, None):
        fn = _enclosing_function_node(mod, acc.node)
        if fn is None:
            continue  # module-scope statements run at import, one thread
        if acc.name not in globals_:
            continue
        if _locally_bound(fn, acc.name):
            continue
        if (mod.relpath, acc.name) in model.owned_globals:
            continue
        if id(acc.node) in cta_writes:
            continue
        cls = model.class_model(mod, acc.node)
        lock_attrs = cls.lock_attrs if cls else set()
        if not _under_lock(mod, acc.node, lock_attrs, module_locks):
            findings.append(
                Finding(
                    LOCK_DISCIPLINE, mod.relpath,
                    acc.node.lineno, acc.node.col_offset,
                    f"{acc.kind} to module global `{acc.name}` outside a "
                    "module lock, in a module that runs threads — "
                    "interleaved compound writes corrupt shared state "
                    "(an open-span stack shared by threads); guard it with a "
                    "module-level lock or annotate the global "
                    "`# torchlint: thread-owned=<role>` with the audited "
                    "reason",
                    mod.enclosing_function(acc.node),
                )
            )
    return findings


# ---------------------------------------------------------------------------
# check-then-act
# ---------------------------------------------------------------------------


@register_check(
    CHECK_THEN_ACT,
    "unlocked read-test-write window on a shared flag/counter "
    "(two threads pass the test before either writes)",
    scope="repo",
)
def check_check_then_act(modules: list[ModuleInfo]) -> list[Finding]:
    _model, pairs = _shared_analysis(modules)
    findings: list[Finding] = []
    for mod in modules:
        for pair in pairs[id(mod)]:
            findings.append(
                Finding(
                    CHECK_THEN_ACT, mod.relpath,
                    pair.test_if.lineno, pair.test_if.col_offset,
                    f"`{pair.scope_desc}` is tested here and written at "
                    f"line {pair.write.lineno} with no lock held across "
                    "the window — two threads can both pass the test "
                    "before either writes; take the lock around "
                    "test-and-set (double-checked locking keeps the "
                    "fast path), or annotate the state "
                    "`# torchlint: thread-owned=<role>` with the audited "
                    "reason",
                    mod.enclosing_function(pair.test_if),
                )
            )
    return findings


# ---------------------------------------------------------------------------
# publish-aliasing
# ---------------------------------------------------------------------------


def _alloc_attrs(mod: ModuleInfo, cls_node: ast.ClassDef) -> set[str]:
    """Attributes the class assigns from a numpy allocator — the
    preallocated slots a producer refills between publishes."""
    out: set[str] = set()
    for node in walk(cls_node):
        if not isinstance(node, ast.Assign):
            continue
        if not (
            isinstance(node.value, ast.Call)
            and mod.dotted(node.value.func) in _ALLOCATORS
        ):
            continue
        for tgt in node.targets:
            attr = self_attr(tgt)
            if attr:
                out.add(attr)
    return out


def _is_snapshotted(mod: ModuleInfo, node: ast.AST, stop: ast.AST) -> bool:
    """Whether a copy-like call wraps `node` on the way up to `stop`."""
    for anc in mod.ancestors(node):
        if anc is stop:
            return False
        if isinstance(anc, ast.Call):
            if (
                isinstance(anc.func, ast.Attribute)
                and anc.func.attr in _SNAPSHOT_METHODS
            ):
                return True
            if mod.dotted(anc.func) in _SNAPSHOT_DOTTED:
                return True
    return False


def _innermost_loop(mod: ModuleInfo, node: ast.AST) -> Optional[ast.AST]:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
            return anc
    return None


def _latest_assign(
    mod: ModuleInfo, scope: ast.AST, name: str, before: int
) -> Optional[tuple[int, ast.AST]]:
    best: Optional[tuple[int, ast.AST]] = None
    for node in walk(scope):
        if not isinstance(node, ast.Assign) or node.lineno >= before:
            continue
        if any(name in target_names(t) for t in node.targets):
            if best is None or node.lineno > best[0]:
                best = (node.lineno, node.value)
    return best


def _producer_findings(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    alloc_cache: dict[ast.AST, set[str]] = {}
    for call in walk(mod.tree):
        if not (
            isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr in CHANNEL_METHODS
        ):
            continue
        payload = list(call.args) + [k.value for k in call.keywords]
        scope = mod.scope_of(call)
        loop = _innermost_loop(mod, call)
        cls_node = next(
            (
                a
                for a in mod.ancestors(call)
                if isinstance(a, ast.ClassDef)
            ),
            None,
        )
        if cls_node is not None and cls_node not in alloc_cache:
            alloc_cache[cls_node] = _alloc_attrs(mod, cls_node)
        slots = alloc_cache.get(cls_node, set())
        context = mod.enclosing_function(call)
        for arg in payload:
            for sub in walk(arg):
                attr = self_attr(sub)
                if attr is not None and attr in slots:
                    if _is_snapshotted(mod, sub, call):
                        continue
                    findings.append(
                        Finding(
                            PUBLISH_ALIASING, mod.relpath,
                            sub.lineno, sub.col_offset,
                            f"`self.{attr}` is a preallocated slot the "
                            "producer refills, handed to cross-thread "
                            f"channel `.{call.func.attr}()` without a "
                            "snapshot — the consumer's view is "
                            "rewritten on the next fill; pass "
                            "`.copy()`/np.array/`.clone()`, or suppress with the "
                            "reason if the channel itself copies",
                            context,
                        )
                    )
                    continue
                if (
                    loop is not None
                    and isinstance(sub, ast.Name)
                    and isinstance(sub.ctx, ast.Load)
                ):
                    latest = _latest_assign(
                        mod, scope, sub.id, call.lineno
                    )
                    if latest is None:
                        continue
                    lineno, value = latest
                    inside_loop = (
                        loop.lineno <= lineno <= (loop.end_lineno or lineno)
                    )
                    if inside_loop:
                        continue
                    if not (
                        isinstance(value, ast.Call)
                        and mod.dotted(value.func) in _ALLOCATORS
                    ):
                        continue
                    if _is_snapshotted(mod, sub, call):
                        continue
                    findings.append(
                        Finding(
                            PUBLISH_ALIASING, mod.relpath,
                            sub.lineno, sub.col_offset,
                            f"`{sub.id}` is allocated once outside this "
                            "loop (line "
                            f"{lineno}) and handed to cross-thread "
                            f"channel `.{call.func.attr}()` every "
                            "iteration — each publish aliases the same "
                            "storage the next iteration rewrites; "
                            "snapshot it (`.copy()`/`.clone()`) or move "
                            "the allocation into the loop",
                            context,
                        )
                    )
    return findings


# Method calls that yield views/iterators over their receiver's storage
# (taint flows through them); every OTHER call returns a fresh value and
# is a taint barrier — the same rule donation.py uses for restore-taint.
_ALIAS_ATTR_CALLS = {
    "items", "values", "keys", "reshape", "view", "transpose", "ravel",
    "squeeze", "swapaxes",
}


def _tainted_reads(
    mod: ModuleInfo, expr: ast.AST, tainted: set[str]
) -> set[str]:
    """Tainted names `expr` can ALIAS: reached without crossing a
    fresh-value call boundary (snapshot constructors, jitted updates,
    arbitrary functions all return storage of their own)."""
    hits: set[str] = set()

    def visit(n: ast.AST, local: set[str]) -> None:
        if isinstance(n, ast.Name):
            if n.id in local:
                hits.add(n.id)
        elif isinstance(n, ast.Call):
            aliasing = mod.dotted(n.func) in _ALIASING_DOTTED or (
                isinstance(n.func, ast.Attribute)
                and n.func.attr in _ALIAS_ATTR_CALLS
            )
            if aliasing:
                if isinstance(n.func, ast.Attribute):
                    visit(n.func.value, local)
                for a in n.args:
                    visit(a, local)
        elif isinstance(n, (ast.Attribute, ast.Subscript, ast.Starred)):
            visit(n.value, local)
        elif isinstance(n, (ast.Tuple, ast.List, ast.Set)):
            for e in n.elts:
                visit(e, local)
        elif isinstance(n, ast.Dict):
            for v in n.values:
                if v is not None:
                    visit(v, local)
        elif isinstance(n, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                            ast.DictComp)):
            inner = set(local)
            for g in n.generators:
                if _tainted_reads(mod, g.iter, inner):
                    inner.update(target_names(g.target))
            exprs = (
                [n.key, n.value]
                if isinstance(n, ast.DictComp)
                else [n.elt]
            )
            for e in exprs:
                visit(e, inner)
        elif isinstance(n, ast.IfExp):
            visit(n.body, local)
            visit(n.orelse, local)
        # operators (BinOp etc.) materialize fresh arrays: barrier

    visit(expr, tainted)
    return hits


def _consumer_findings(mod: ModuleInfo) -> list[Finding]:
    """`asarray`-then-`release` in one scope: the zero-copy view reads a
    slot the pool recycles (a copy-on-transfer bug)."""
    findings: list[Finding] = []
    scopes: dict[ast.AST, list[str]] = {}
    for call in walk(mod.tree):
        if (
            isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "release"
            and len(call.args) == 1
            and isinstance(call.args[0], ast.Name)
        ):
            scopes.setdefault(mod.scope_of(call), []).append(
                call.args[0].id
            )
    for scope, released in scopes.items():
        tainted = set(released)
        # Propagate through view-preserving assignments and tainted
        # comprehension targets until stable (two passes cover the
        # chains this flags; fresh-value calls are barriers).
        for _ in range(2):
            for node in walk(scope):
                if isinstance(node, ast.Assign):
                    if _tainted_reads(mod, node.value, tainted):
                        for t in node.targets:
                            tainted.update(target_names(t))
                elif isinstance(node, ast.comprehension):
                    if _tainted_reads(mod, node.iter, tainted):
                        tainted.update(target_names(node.target))
        for call in walk(scope):
            if not (
                isinstance(call, ast.Call)
                and mod.dotted(call.func) in _ALIASING_DOTTED
            ):
                continue
            hit = _tainted_reads(mod, call, tainted)
            if not hit:
                continue
            if _is_snapshotted(mod, call, scope):
                continue
            fn = mod.dotted(call.func)
            short = fn.replace("numpy", "np")
            findings.append(
                Finding(
                    PUBLISH_ALIASING, mod.relpath,
                    call.lineno, call.col_offset,
                    f"`{short}` may alias host memory zero-copy, and "
                    f"`{sorted(hit)[0]}` comes from a block that is "
                    "`release`d back to its slot pool in this scope — "
                    "the next `put` rewrites the slot while the view "
                    "is still read (a copy-on-transfer bug); "
                    "snapshot with np.array/torch.tensor/.clone() before "
                    "releasing",
                    mod.enclosing_function(call),
                )
            )
    return findings


@register_check(
    PUBLISH_ALIASING,
    "array or tensor view of a recycled/preallocated slot crossing a thread "
    "channel (put/publish/send) or aliased past its release "
    "(a zero-copy queue race)",
)
def check_publish_aliasing(mod: ModuleInfo) -> list[Finding]:
    return _producer_findings(mod) + _consumer_findings(mod)
