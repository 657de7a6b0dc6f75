"""Whole-repo thread model for the concurrency passes (the port's
counterpart of `actor_critic_tpu/analysis/thread_model.py`, the same model).

The port's host pipeline runs threads: the async actors
(`algos/traj_queue.ActorService`) feeding `TrajQueue` and the device ring's
leases, the learner's drain loop, `PolicyPublisher`, the serving lanes and
batcher, the gossip mailbox's writer, the telemetry sampler and the warm-up
builder. This module derives, from `ast` alone, the facts the concurrency
checks in `analysis/concurrency.py` need:

- **Thread entry points** — every `threading.Thread(target=...)` spawn
  site, with the target resolved to a method of the enclosing class
  (`target=self._run`), a module-level function (`target=loop`), or a
  method of a locally constructed repo class (`svc = Service(...);
  Thread(target=svc.run)`). The role name comes from the `name=` kwarg
  when it is a readable constant/f-string head, else the target name.
- **Per-class roles** — for each class that spawns a thread onto one of
  its own methods: the transitive intra-class closure of each target
  method runs on that thread's role; every other method runs on the
  "caller" role (whatever thread holds the instance: for the port's
  services, the learner's or the main thread).
- **Lock inventory** — attributes assigned from
  `threading.Lock/RLock/Condition/Semaphore/BoundedSemaphore`, plus
  module-level locks, so checks can decide whether an access happens
  under a held `with self._lock:` context.
- **Threaded modules** — any module importing `threading`: the scope of
  the module-global discipline (a module that reaches for threads is
  declaring its globals may be shared).
- **`# torchlint: thread-owned=<role>` annotations** — the audited escape
  hatch: an attribute (or module global) whose compound mutations are
  all issued by one role, with readers that tolerate staleness, carries
  the annotation on a line that assigns it; the checks then skip it.
  Like suppressions, the why belongs in the same comment.

The model's assumptions:

1. Plain reference assignment (`self.x = value`, `GLOBAL = value`) and
   plain reads are treated as GIL-atomic and never flagged; the hazard
   class is COMPOUND mutation — `+=`, container method mutation
   (`append`/`pop`/`update`/...), and subscript stores — whose
   read-modify-write window interleaves.
2. Attribute accesses are analyzed within the owning class; mutation of
   `obj.attr` from outside the class is out of model (the passes are
   AST-only and do not infer types across call boundaries).
3. A method reached from no thread-target closure runs on the "caller"
   role. `__init__` is pre-publication (happens-before `Thread.start`)
   and exempt.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

from actor_critic_tpu_torch.analysis.core import ModuleInfo, target_names, walk

CALLER_ROLE = "caller"

_LOCK_CONSTRUCTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
}

# Container-mutating method names: calling one of these on an attribute
# or module-global is a compound write to the container.
MUTATING_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort", "reverse",
}


@dataclasses.dataclass
class SpawnSite:
    """One `threading.Thread(target=...)` call."""

    module: str           # relpath of the spawning module
    lineno: int
    role: str             # thread name head or target name
    target_class: Optional[str] = None  # class whose method is the target
    target_method: Optional[str] = None
    target_function: Optional[str] = None  # module-level function target


@dataclasses.dataclass
class ClassModel:
    """Concurrency-relevant facts about one class."""

    name: str
    module: str           # relpath
    node: ast.ClassDef
    lock_attrs: set[str] = dataclasses.field(default_factory=set)
    # method name -> set of self-method names it calls (intra-class)
    calls: dict[str, set[str]] = dataclasses.field(default_factory=dict)
    # role -> set of method names running under it (thread closures)
    thread_methods: dict[str, set[str]] = dataclasses.field(
        default_factory=dict
    )
    # attr name -> owning role, from thread-owned annotations
    owned_attrs: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def threaded(self) -> bool:
        return bool(self.thread_methods)

    def methods(self) -> dict[str, ast.AST]:
        return {
            n.name: n
            for n in self.node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

    def roles_of(self, method: str) -> set[str]:
        """Roles that can execute `method`: each thread whose target
        closure contains it, plus the caller role for anything public
        or outside every closure (a private closure-only helper runs
        exclusively on its thread)."""
        roles = {
            role
            for role, members in self.thread_methods.items()
            if method in members
        }
        if not roles or not method.startswith("_"):
            roles.add(CALLER_ROLE)
        return roles


class ThreadModel:
    """The repo-wide model: spawn sites, per-class facts, threaded
    modules, module-level locks, and thread-owned globals."""

    def __init__(self, modules: list[ModuleInfo]):
        self.spawns: list[SpawnSite] = []
        self.classes: dict[tuple[str, str], ClassModel] = {}
        self.threaded_modules: set[str] = set()
        # relpath -> set of module-global lock names
        self.module_locks: dict[str, set[str]] = {}
        # (relpath, global name) -> owning role
        self.owned_globals: dict[tuple[str, str], str] = {}
        for mod in modules:
            self._scan_module(mod)
        self._resolve_spawns(modules)

    # -- per-module facts --------------------------------------------------

    def _scan_module(self, mod: ModuleInfo) -> None:
        if any(
            root == "threading"
            for root in (
                v.split(".")[0] for v in mod.aliases.values()
            )
        ):
            self.threaded_modules.add(mod.relpath)
        locks = {
            name
            for stmt in mod.tree.body
            if isinstance(stmt, ast.Assign)
            and _is_lock_call(mod, stmt.value)
            for tgt in stmt.targets
            for name in target_names(tgt)
        }
        if locks:
            self.module_locks[mod.relpath] = locks
        for node in walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                self.classes[(mod.relpath, node.name)] = self._scan_class(
                    mod, node
                )
        self._scan_owned(mod)

    def _scan_class(self, mod: ModuleInfo, node: ast.ClassDef) -> ClassModel:
        cm = ClassModel(name=node.name, module=mod.relpath, node=node)
        for name, fn in cm.methods().items():
            callees: set[str] = set()
            for sub in walk(fn):
                if isinstance(sub, ast.Assign) and _is_lock_call(
                    mod, sub.value
                ):
                    for tgt in sub.targets:
                        attr = self_attr(tgt)
                        if attr:
                            cm.lock_attrs.add(attr)
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == "self"
                ):
                    callees.add(sub.func.attr)
            cm.calls[name] = callees
        return cm

    def _scan_owned(self, mod: ModuleInfo) -> None:
        """Resolve thread-owned annotation lines (collected by
        ModuleInfo) to class attributes / module globals: the annotated
        line's statement (or, for a standalone comment, the next
        statement) must assign the attribute or global it covers."""
        for lineno, role in mod.thread_owned.items():
            stmt = _stmt_at(mod, lineno)
            if stmt is None:
                continue
            targets: list[ast.AST] = []
            if isinstance(stmt, ast.Assign):
                targets = list(stmt.targets)
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                targets = [stmt.target]
            for tgt in targets:
                attr = self_attr(tgt)
                if attr is not None:
                    cls = self._enclosing_class(mod, stmt)
                    if cls is not None:
                        cls.owned_attrs[attr] = role
                    continue
                base = tgt
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if isinstance(base, ast.Name):
                    scope = mod.scope_of(stmt)
                    if isinstance(scope, ast.Module) or _declared_global(
                        scope, base.id
                    ):
                        self.owned_globals[(mod.relpath, base.id)] = role

    def _enclosing_class(
        self, mod: ModuleInfo, node: ast.AST
    ) -> Optional[ClassModel]:
        for anc in mod.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return self.classes.get((mod.relpath, anc.name))
        return None

    # -- spawn resolution --------------------------------------------------

    def _resolve_spawns(self, modules: list[ModuleInfo]) -> None:
        for mod in modules:
            for node in walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                if mod.dotted(node.func) != "threading.Thread":
                    continue
                target = next(
                    (k.value for k in node.keywords if k.arg == "target"),
                    None,
                )
                if target is None:
                    continue
                site = SpawnSite(
                    module=mod.relpath,
                    lineno=node.lineno,
                    role=_role_name(node, target),
                )
                attr = self_attr(target)
                if attr is not None:
                    cls = self._enclosing_class(mod, node)
                    if cls is not None:
                        site.target_class = cls.name
                        site.target_method = attr
                        cls.thread_methods[site.role] = _closure(cls, attr)
                elif isinstance(target, ast.Name):
                    site.target_function = target.id
                elif isinstance(target, ast.Attribute) and isinstance(
                    target.value, ast.Name
                ):
                    # Thread(target=svc.run) on a locally constructed
                    # repo class: resolve svc through the enclosing
                    # scope's assignments.
                    cls = self._local_instance_class(
                        mod, node, target.value.id
                    )
                    if cls is not None:
                        site.target_class = cls.name
                        site.target_method = target.attr
                        cls.thread_methods[site.role] = _closure(
                            cls, target.attr
                        )
                self.spawns.append(site)

    def _local_instance_class(
        self, mod: ModuleInfo, at: ast.AST, name: str
    ) -> Optional[ClassModel]:
        scope = mod.scope_of(at)
        cls: Optional[ClassModel] = None
        for node in walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            if not any(name in target_names(t) for t in node.targets):
                continue
            if isinstance(node.value, ast.Call) and isinstance(
                node.value.func, ast.Name
            ):
                cls = self.classes.get((mod.relpath, node.value.func.id))
        return cls

    # -- queries the checks use --------------------------------------------

    def class_model(
        self, mod: ModuleInfo, node: ast.AST
    ) -> Optional[ClassModel]:
        return self._enclosing_class(mod, node)

    def is_threaded_module(self, mod: ModuleInfo) -> bool:
        return mod.relpath in self.threaded_modules


def _closure(cls: ClassModel, method: str) -> set[str]:
    """`method` plus every self-method transitively called from it."""
    seen: set[str] = set()
    frontier = [method]
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        frontier.extend(cls.calls.get(m, ()))
    return seen


def _is_lock_call(mod: ModuleInfo, value: ast.AST) -> bool:
    return (
        isinstance(value, ast.Call)
        and mod.dotted(value.func) in _LOCK_CONSTRUCTORS
    )


def self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _declared_global(scope: ast.AST, name: str) -> bool:
    return any(
        isinstance(n, ast.Global) and name in n.names
        for n in walk(scope)
    )


_COMPOUND_STMTS = (
    ast.If, ast.For, ast.AsyncFor, ast.While, ast.With, ast.AsyncWith,
    ast.Try, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
)


def _stmt_at(mod: ModuleInfo, lineno: int) -> Optional[ast.stmt]:
    """The SIMPLE statement whose line span covers `lineno` (a trailing
    annotation), or — when the line is a standalone comment, which every
    enclosing compound statement's span covers but no simple one does —
    the next simple statement after it (mirrors the
    standalone-suppression rule in core.ModuleInfo)."""
    best: Optional[ast.stmt] = None
    for node in walk(mod.tree):
        if not isinstance(node, ast.stmt) or isinstance(
            node, _COMPOUND_STMTS
        ):
            continue
        if node.lineno <= lineno <= (node.end_lineno or node.lineno):
            if best is None or node.lineno >= best.lineno:
                best = node
    if best is not None:
        return best
    after = [
        n
        for n in walk(mod.tree)
        if isinstance(n, ast.stmt)
        and not isinstance(n, _COMPOUND_STMTS)
        and n.lineno > lineno
    ]
    return min(after, key=lambda n: n.lineno) if after else None


def _role_name(call: ast.Call, target: ast.AST) -> str:
    """Thread role: the `name=` kwarg's readable head (constant, or the
    leading literal of an f-string like f"actor-{i}") when present, else
    the target's terminal name."""
    for k in call.keywords:
        if k.arg != "name":
            continue
        v = k.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            return _trim_role(v.value)
        if isinstance(v, ast.JoinedStr) and v.values:
            head = v.values[0]
            if isinstance(head, ast.Constant) and isinstance(
                head.value, str
            ):
                return _trim_role(head.value)
    if isinstance(target, ast.Attribute):
        return target.attr
    if isinstance(target, ast.Name):
        return target.id
    return "thread"


def _trim_role(name: str) -> str:
    return name.strip().strip("-_ ") or "thread"
