"""Whole-repo process model for the distributed passes (the port's
counterpart of `actor_critic_tpu/analysis/process_model.py`).

The port runs as a fleet of processes: sync learners all-reducing over
`torch.distributed` (NCCL on the card, gloo on the CPU), gossip ranks
exchanging parameters through a file mailbox (`parallel/multihost.py`),
data- and sequence-parallel meshes (`parallel/mesh.py`, `dp.py`,
`seqpar.py`) and a serving fleet. This module derives, from `ast` alone,
the facts the distributed checks in `analysis/distributed.py` need:

- **Collective sites**: every call the WHOLE fleet must reach together:
  `torch.distributed`'s collectives (`all_reduce`, `all_gather`,
  `all_gather_into_tensor`, `broadcast`, `barrier`, `reduce_scatter`,
  ...), the port's wrappers (`mesh.psum`/`pmean`/`pmax`/`all_gather`/
  `pmean_tree`, and calling a `FlatGradients`), the cross-process set-up
  ops (`init_process_group`, `new_group`, `make_process_mesh`), and calls
  to repo functions whose bodies transitively contain any of them
  (resolved through imports and through locals assigned from
  collective-building factories, so `check = make_consistency_check(group,
  device); ...; check(v)` counts at the `check(v)` call site).
- **Axis inventory**: mesh-axis names DECLARED by `make_process_mesh`'s
  axis tuple (module string constants resolved: `DP_AXIS = "dp"`), versus
  names USED at collective sites through `mesh.group("dp")` and in
  `PartitionSpec(...)`. A used name no mesh declares raises at run time on
  the first rank that reaches it, or reduces over the wrong line.
- **Process-local taint**: names whose values differ across ranks:
  parameters named `rank`/`process_id`/..., rank-named attributes
  (`args.process_id`, `self._rank`), wall-clock and pid calls,
  `torch.distributed.get_rank()`, the `RANK` environment variable, and
  queue-depth probes, propagated through assignments. A collective
  inside a branch keyed on them desyncs the fleet into a deadlock.
- **Mailbox shapes**: path-builder functions (a module-level def whose
  every return is a pure `os.path.join`/f-string), the producers that
  open builder paths for writing (`open(..., "w")`, `torch.save`), the
  `os.replace` publish sites, and the consumers (`np.load`, `json.load`,
  `torch.load`) with their enclosing `try` handlers: the facts of the
  write→fsync→rename and torn-read rules.
- **Distributed scopes**: functions that demonstrably run once per rank:
  a `rank`/`process_id` parameter, a `get_rank()` read, a
  `distributed_init`/`init_process_group` call, or a read of a
  `.distributed` flag. Shared artifact paths written from such a scope
  must carry the rank, or every rank clobbers the same file.

Everything here is stdlib `ast` over source text: nothing scanned is
imported.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional

from actor_critic_tpu_torch.analysis.core import ModuleInfo, target_names, walk

# Collectives every rank of the group must reach, in one order.
COLLECTIVE_PRIMS = {
    f"torch.distributed.{n}"
    for n in (
        "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
        "broadcast", "broadcast_object_list", "reduce", "reduce_scatter",
        "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "barrier",
        "gather", "scatter", "monitored_barrier",
    )
}

# The port's collective wrappers (`parallel/mesh.py`), by terminal name:
# `psum(x, group)` and friends, each the identity with `group=None`. Their
# second argument is the group, `mesh.group("<axis>")` where a mesh names it.
COLLECTIVE_WRAPPERS = {"psum", "pmean", "pmax", "all_gather", "pmean_tree"}

# Classes whose instances perform a collective when called.
COLLECTIVE_CLASSES = {"FlatGradients"}

# Cross-process set-up: every rank reaches these together (they join the
# fleet or make its groups), so they join the process-local-gating rule,
# but NOT the try-divergence rule, where a designed single-process
# fallback is legitimate.
CROSS_PROCESS_OPS = {
    "torch.distributed.init_process_group",
    "torch.distributed.new_group",
    "torch.distributed.destroy_process_group",
}

# Mesh constructors: their axis-names argument DECLARES the names a group
# may be asked for.
_MESH_CALLS = {"make_process_mesh", "Mesh"}

# Parameter/attribute names whose VALUE differs per process.
RANK_NAMES = {
    "rank", "process_id", "process_index", "local_rank", "host_id",
}

# Calls whose result is process-local (wall clock, pid, rank).
PROCESS_LOCAL_CALLS = {
    "time.time",
    "time.monotonic",
    "time.perf_counter",
    "time.process_time",
    "os.getpid",
    "torch.distributed.get_rank",
    "socket.gethostname",
}

# Zero-arg methods probing process-local runtime state (queue depth).
PROCESS_LOCAL_METHODS = {"qsize", "queue_depth"}

# Environment variables naming this process's place in the fleet.
RANK_ENV = {"RANK", "LOCAL_RANK"}

# Torn/partial-file exception classes per consumer kind: a handler that
# names none of these (nor a bare/blanket Exception) dies on the first
# torn read instead of tolerating it.
TORN_EXC_NPZ = {"BadZipFile", "EOFError", "Exception", "BaseException"}
TORN_EXC_JSON = {
    "JSONDecodeError", "ValueError", "Exception", "BaseException",
}
TORN_EXC_PT = {"RuntimeError", "EOFError", "UnpicklingError", "Exception", "BaseException"}


def _callee(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    """The terminal name of a call that can reach a module-level def: a bare
    name (`check(v)`), or an attribute of an imported module
    (`mesh_lib.pmax(...)`). A method call on an object (`row.update(...)`,
    `self.load()`) is None: terminal names alone would tie every
    `dict.update` to a collective-performing `update` def."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        root = node.func.value
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id != "self" and root.id in mod.aliases:
            return node.func.attr
    return None


def _call_name(node: ast.Call) -> Optional[str]:
    """Terminal callable name: `TelemetrySession(...)` -> that, also for
    attribute calls (`telemetry.TelemetrySession(...)`)."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


# ---------------------------------------------------------------------------
# axis inventory
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AxisUse:
    """One axis name consumed at a collective / PartitionSpec site."""

    module: str
    node: ast.AST
    name: str
    where: str  # "collective" | "spec"


class AxisInventory:
    def __init__(self) -> None:
        self.declared: set[str] = set()
        # bare constant name -> string value, repo-wide ("DP_AXIS"->"dp")
        self.consts: dict[str, str] = {}
        self.uses: list[AxisUse] = []

    def resolve(self, mod: ModuleInfo, expr: ast.AST):
        """Axis-name expression -> str | tuple[str, ...] | None (None =
        not statically resolvable: a parameter, a computed name)."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            return self.consts.get(expr.id)
        if isinstance(expr, ast.Attribute):
            return self.consts.get(expr.attr)
        if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in ("group", "index") and expr.args):
            # `mesh.group("dp")`: the group of a named axis
            if len(expr.args) == 1:
                return self.resolve(mod, expr.args[0])
            return self.resolve(mod, ast.Tuple(elts=list(expr.args), ctx=ast.Load()))
        if isinstance(expr, (ast.Tuple, ast.List)):
            out = tuple(self.resolve(mod, e) for e in expr.elts)
            if all(isinstance(v, str) for v in out):
                return out
            return None
        return None


# ---------------------------------------------------------------------------
# collective sites + the performing-function closure
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveSite:
    """One call the whole fleet must reach together."""

    module: str
    node: ast.Call
    desc: str  # human-readable ("torch.distributed.all_reduce", "check (collective-performing)")
    kind: str  # "prim" | "cross-process" | "derived"
    axis_arg: Optional[ast.AST] = None  # prim sites: the axis expression


def _axis_expr(call: ast.Call) -> Optional[ast.AST]:
    """The group (axis) argument of a wrapper site: `psum(x, group)`."""
    for kw in call.keywords:
        if kw.arg in ("group", "axis_name"):
            return kw.value
    if len(call.args) >= 2:
        return call.args[1]
    return None


# ---------------------------------------------------------------------------
# mailbox shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProducerSite:
    """One open-for-write of a file later published (or not) in scope."""

    module: str
    open_call: ast.Call
    path_expr: ast.AST
    scope: ast.AST
    replace_call: Optional[ast.Call] = None  # os.replace/os.rename in scope
    has_fsync: bool = False
    writes_builder_path: bool = False  # final (consumed) path written directly


@dataclasses.dataclass
class ConsumerSite:
    """One parse of a shared file (np.load / json.load / read-open)."""

    module: str
    call: ast.Call
    kind: str  # "npz" | "json"
    handler_names: Optional[set[str]] = None  # None = not inside a try


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class ProcessModel:
    """The repo-wide model the distributed checks consult."""

    def __init__(self, modules: list[ModuleInfo]):
        self.axes = AxisInventory()
        # Executor defs EXECUTE a collective when called: a prim /
        # cross-process call (or a call to another executor) sits in
        # their own body, outside any nested def. Factory defs only
        # BUILD collective programs (the prims live in nested defs /
        # called factories): calling a factory communicates nothing,
        # but calling the object a factory returned does — that is the
        # `check = make_consistency_check(mesh); ...; check(v)` shape.
        # Cross-module resolution works on terminal names (unique
        # enough at repo scale).
        self._executor_names: set[str] = set()
        self._factory_names: set[str] = set()
        self.collective_sites: dict[str, list[CollectiveSite]] = {}
        self.producers: dict[str, list[ProducerSite]] = {}
        self.consumers: dict[str, list[ConsumerSite]] = {}
        # relpath -> path-builder function names defined there
        self.path_builders: dict[str, set[str]] = {}
        self._modules = modules
        self._scan_consts(modules)
        self._scan_axes(modules)
        self._close_performing(modules)
        for mod in modules:
            self.collective_sites[mod.relpath] = self._sites_in(mod)
            self.producers[mod.relpath] = self._producers_in(mod)
            self.consumers[mod.relpath] = self._consumers_in(mod)

    # -- constants + axis declarations --------------------------------------

    def _scan_consts(self, modules: list[ModuleInfo]) -> None:
        for mod in modules:
            for stmt in mod.tree.body:
                if not isinstance(stmt, ast.Assign):
                    continue
                if not (
                    isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)
                ):
                    continue
                for tgt in stmt.targets:
                    for name in target_names(tgt):
                        self.axes.consts[name] = stmt.value.value

    def _scan_axes(self, modules: list[ModuleInfo]) -> None:
        for mod in modules:
            for node in walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                if name in _MESH_CALLS:
                    arg = None
                    for kw in node.keywords:
                        if kw.arg == "axis_names":
                            arg = kw.value
                    if arg is None and len(node.args) >= 2:
                        arg = node.args[1]
                    if arg is not None:
                        resolved = self.axes.resolve(mod, arg)
                        if isinstance(resolved, str):
                            self.axes.declared.add(resolved)
                        elif isinstance(resolved, tuple):
                            self.axes.declared.update(resolved)
                elif name in ("PartitionSpec", "P"):
                    for arg in node.args:
                        resolved = self.axes.resolve(mod, arg)
                        if isinstance(resolved, str):
                            self.axes.uses.append(
                                AxisUse(mod.relpath, arg, resolved, "spec")
                            )
                        elif isinstance(resolved, tuple):
                            for v in resolved:
                                self.axes.uses.append(
                                    AxisUse(mod.relpath, arg, v, "spec")
                                )

    # -- performing closure --------------------------------------------------

    def _direct_collective(self, mod: ModuleInfo, call: ast.Call) -> bool:
        dotted = mod.dotted(call.func)
        return (dotted in COLLECTIVE_PRIMS or dotted in CROSS_PROCESS_OPS
                or _callee(mod, call) in COLLECTIVE_WRAPPERS)

    def _close_performing(self, modules: list[ModuleInfo]) -> None:
        """Split the repo's module-level defs into collective EXECUTORS
        and collective FACTORIES (class docstring), each closed to
        fixpoint over terminal-name call resolution (`from x import f`
        and `mod.f(...)` both reach an `f` defined anywhere in the scan
        set)."""
        defs: dict[tuple[str, str], ast.AST] = {}
        for mod in modules:
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs[(mod.relpath, node.name)] = node
        by_mod = {m.relpath: m for m in modules}

        def direct_calls(fn: ast.AST) -> list[ast.Call]:
            """Calls in fn's own body, nested defs excluded."""
            out, stack = [], list(ast.iter_child_nodes(fn))
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(node, ast.Call):
                    out.append(node)
                stack.extend(ast.iter_child_nodes(node))
            return out

        # Per def, computed once: whether it calls a collective directly
        # (own body / anywhere in it), and the terminal names it calls.
        facts = {}
        for key, fn in defs.items():
            mod = by_mod[key[0]]
            own = direct_calls(fn)
            every = [n for n in walk(fn) if isinstance(n, ast.Call)]
            facts[key] = (
                any(self._direct_collective(mod, c) for c in own),
                {_callee(mod, c) for c in own},
                any(self._direct_collective(mod, c) for c in every),
                {_callee(mod, c) for c in every},
            )

        changed = True
        while changed:
            changed = False
            for (relpath, fname), fn in defs.items():
                own_direct, own_names, any_direct, all_names = facts[(relpath, fname)]
                if fname not in self._executor_names:
                    hit = own_direct or bool(own_names & self._executor_names)
                    if hit:
                        self._executor_names.add(fname)
                        changed = True
                if fname not in self._factory_names and (
                    fname not in self._executor_names
                ):
                    hit = any_direct or bool(
                        all_names & (self._executor_names | self._factory_names))
                    if hit:
                        self._factory_names.add(fname)
                        changed = True

    # -- collective sites ----------------------------------------------------

    def _sites_in(self, mod: ModuleInfo) -> list[CollectiveSite]:
        # locals assigned from a call to a collective FACTORY: calling
        # the local is a collective site (check = make_consistency_
        # check(mesh); check(v)) — calling the factory itself is not.
        derived: dict[ast.AST, set[str]] = {}
        for node in walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Call)
                and (_callee(mod, node.value) in self._factory_names
                     or _callee(mod, node.value) in COLLECTIVE_CLASSES)
            ):
                continue
            scope = mod.scope_of(node)
            for tgt in node.targets:
                derived.setdefault(scope, set()).update(target_names(tgt))
        sites: list[CollectiveSite] = []
        for node in walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = mod.dotted(node.func)
            if dotted in COLLECTIVE_PRIMS:
                sites.append(CollectiveSite(mod.relpath, node, dotted, "prim"))
                continue
            if _callee(mod, node) in COLLECTIVE_WRAPPERS:
                sites.append(
                    CollectiveSite(
                        mod.relpath, node, _callee(mod, node), "prim",
                        axis_arg=_axis_expr(node),
                    )
                )
                continue
            if dotted in CROSS_PROCESS_OPS:
                sites.append(
                    CollectiveSite(mod.relpath, node, dotted, "cross-process")
                )
                continue
            cname = _callee(mod, node)
            if cname in self._executor_names:
                sites.append(
                    CollectiveSite(
                        mod.relpath, node,
                        f"{cname} (collective-performing)", "derived",
                    )
                )
            elif isinstance(node.func, ast.Name) and node.func.id in (
                derived.get(mod.scope_of(node), set())
            ):
                sites.append(
                    CollectiveSite(
                        mod.relpath, node,
                        f"{node.func.id} (built by a collective factory)",
                        "derived",
                    )
                )
        return sites

    # -- process-local taint -------------------------------------------------

    def process_local_names(self, mod: ModuleInfo, scope: ast.AST) -> set[str]:
        """Names in `scope` carrying per-process values, to fixpoint
        through plain assignments (2 passes cover the chains flagged)."""
        tainted: set[str] = set()
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = scope.args
            for a in (
                args.posonlyargs + args.args + args.kwonlyargs
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            ):
                if a.arg in RANK_NAMES:
                    tainted.add(a.arg)
        for _ in range(2):
            for node in walk(scope):
                if not isinstance(node, ast.Assign):
                    continue
                if self.expr_process_local(mod, node.value, tainted):
                    for tgt in node.targets:
                        tainted.update(target_names(tgt))
        return tainted

    def expr_process_local(
        self, mod: ModuleInfo, expr: ast.AST, tainted: Iterable[str]
    ) -> bool:
        """Whether evaluating `expr` reads per-process state."""
        tainted = set(tainted)
        for sub in walk(expr):
            if isinstance(sub, ast.Name) and sub.id in tainted:
                return True
            if isinstance(sub, ast.Attribute) and (
                sub.attr in RANK_NAMES or sub.attr.lstrip("_") in RANK_NAMES
            ):
                return True
            if _rank_env(mod, sub):
                return True
            if isinstance(sub, ast.Call):
                if mod.dotted(sub.func) in PROCESS_LOCAL_CALLS:
                    return True
                if (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in PROCESS_LOCAL_METHODS
                ):
                    return True
        return False

    # -- mailbox shapes ------------------------------------------------------

    def _builders_in(self, mod: ModuleInfo) -> set[str]:
        """Module-level defs whose every return is a pure path
        construction (os.path.join / f-string / str concat) — the shared
        protocol-path builders producers and consumers both call."""
        out: set[str] = set()
        for node in mod.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            returns = [
                s for s in walk(node) if isinstance(s, ast.Return)
            ]
            if not returns:
                continue
            if all(
                r.value is not None and _is_path_expr(mod, r.value)
                for r in returns
            ):
                out.add(node.name)
        return out

    def _producers_in(self, mod: ModuleInfo) -> list[ProducerSite]:
        builders = self.path_builders.setdefault(
            mod.relpath, self._builders_in(mod)
        )
        all_builders = set(builders)
        for names in self.path_builders.values():
            all_builders |= names
        sites: list[ProducerSite] = []
        per_scope: dict[ast.AST, list[ProducerSite]] = {}
        for node in walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if mod.dotted(node.func) == "torch.save" and len(node.args) >= 2:
                path_expr = node.args[1]
                scope = mod.scope_of(node)
                site = ProducerSite(mod.relpath, node, path_expr, scope)
                site.writes_builder_path = _expr_from_builder(
                    mod, scope, path_expr, all_builders
                )
                sites.append(site)
                per_scope.setdefault(scope, []).append(site)
                continue
            if not (
                isinstance(node.func, ast.Name) and node.func.id == "open"
                or mod.dotted(node.func) == "builtins.open"
            ):
                continue
            mode = None
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if not (isinstance(mode, str) and ("w" in mode or "x" in mode)):
                continue
            path_expr = node.args[0] if node.args else None
            if path_expr is None:
                continue
            scope = mod.scope_of(node)
            site = ProducerSite(mod.relpath, node, path_expr, scope)
            site.writes_builder_path = _expr_from_builder(
                mod, scope, path_expr, all_builders
            )
            sites.append(site)
            per_scope.setdefault(scope, []).append(site)
        for scope, scoped in per_scope.items():
            replace = None
            fsync = False
            for node in walk(scope):
                if isinstance(node, ast.Call):
                    dotted = mod.dotted(node.func)
                    if dotted in ("os.replace", "os.rename"):
                        replace = node
                    if dotted == "os.fsync" or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "fsync"
                    ):
                        fsync = True
            for site in scoped:
                site.replace_call = replace
                site.has_fsync = fsync
        return sites

    def _consumers_in(self, mod: ModuleInfo) -> list[ConsumerSite]:
        sites: list[ConsumerSite] = []
        for node in walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = mod.dotted(node.func)
            kind = None
            if dotted == "numpy.load":
                kind = "npz"
            elif dotted in ("json.load", "json.loads"):
                kind = "json"
            elif dotted == "torch.load":
                kind = "pt"
            if kind is None:
                continue
            handler_names: Optional[set[str]] = None
            for anc in mod.ancestors(node):
                if isinstance(anc, ast.Try):
                    in_body = any(
                        _contains(stmt, node) for stmt in anc.body
                    )
                    if in_body and anc.handlers:
                        handler_names = set()
                        for h in anc.handlers:
                            handler_names |= _handler_exc_names(h)
                        break
            sites.append(
                ConsumerSite(mod.relpath, node, kind, handler_names)
            )
        return sites

    # -- distributed scopes --------------------------------------------------

    def distributed_scope(self, mod: ModuleInfo, scope: ast.AST) -> bool:
        """Whether `scope` demonstrably runs once PER RANK of a fleet: a
        rank-named parameter, a `get_rank()` read, a
        `distributed_init`/`init_process_group` call, or a read
        of a `.distributed` flag (train.py's `args.distributed`)."""
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = scope.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                if a.arg in RANK_NAMES:
                    return True
        for node in walk(scope):
            if isinstance(node, ast.Call):
                dotted = mod.dotted(node.func)
                if dotted in (
                    "torch.distributed.get_rank",
                    "torch.distributed.init_process_group",
                ):
                    return True
                if _call_name(node) in (
                    "distributed_init", "multihost_init"
                ):
                    return True
            if isinstance(node, ast.Attribute) and node.attr == "distributed":
                return True
            if _rank_env(mod, node):
                return True
        return False


def _rank_env(mod: ModuleInfo, node: ast.AST) -> bool:
    """`os.environ["RANK"]` / `os.environ.get("RANK")` / `os.getenv("RANK")`."""
    key = None
    if isinstance(node, ast.Subscript) and mod.dotted(node.value) == "os.environ":
        key = node.slice
    elif isinstance(node, ast.Call) and node.args and mod.dotted(node.func) in (
            "os.environ.get", "os.getenv"):
        key = node.args[0]
    return isinstance(key, ast.Constant) and key.value in RANK_ENV


def _contains(root: ast.AST, target: ast.AST) -> bool:
    return any(sub is target for sub in walk(root))


def _handler_exc_names(handler: ast.ExceptHandler) -> set[str]:
    """Exception class terminal names a handler catches; a bare
    `except:` reads as catching everything."""
    if handler.type is None:
        return {"BaseException"}
    out: set[str] = set()
    types = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    for t in types:
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, ast.Attribute):
            out.add(t.attr)
    return out


def _is_path_expr(mod: ModuleInfo, expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        return mod.dotted(expr.func) in (
            "os.path.join", "pathlib.Path", "os.path.abspath",
        )
    if isinstance(expr, ast.JoinedStr):
        return True
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return _is_path_expr(mod, expr.left) or _is_path_expr(mod, expr.right)
    return False


def _expr_from_builder(
    mod: ModuleInfo, scope: ast.AST, expr: ast.AST, builders: set[str]
) -> bool:
    """Whether `expr` IS (or is a name last assigned from) a call to a
    shared path-builder — i.e. the final consumed path, not a tmp."""
    if isinstance(expr, ast.Call) and _call_name(expr) in builders:
        return True
    if isinstance(expr, ast.Name):
        latest: Optional[ast.AST] = None
        latest_line = -1
        for node in walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            if node.lineno >= expr.lineno:
                continue
            if any(expr.id in target_names(t) for t in node.targets):
                if node.lineno > latest_line:
                    latest, latest_line = node.value, node.lineno
        if latest is not None:
            return isinstance(latest, ast.Call) and (
                _call_name(latest) in builders
            )
    return False


def rank_parameterized(
    mod: ModuleInfo, scope: ast.AST, expr: ast.AST, depth: int = 2
) -> bool:
    """Whether a path expression is parameterized by the process
    identity: the expression (resolving Names through their latest
    in-scope assignment, `depth` hops) mentions a rank-named
    name/attribute, `os.getpid()`, or passes a rank-named value into a
    builder call (`params_file(dir, rank)`)."""
    for sub in walk(expr):
        if isinstance(sub, ast.Name) and (
            sub.id in RANK_NAMES or sub.id.lstrip("_") in RANK_NAMES
        ):
            return True
        if isinstance(sub, ast.Attribute) and (
            sub.attr in RANK_NAMES or sub.attr.lstrip("_") in RANK_NAMES
        ):
            return True
        if isinstance(sub, ast.Call) and mod.dotted(sub.func) in (
            "os.getpid", "uuid.uuid4", "tempfile.mkstemp",
            "tempfile.mkdtemp",
        ):
            return True
    if depth <= 0:
        return False
    # Resolve Name (and attribute, e.g. the `args.telemetry_dir`
    # rebind train.py's --distributed path does) reads one hop through
    # their latest prior in-scope assignment.
    for sub in walk(expr):
        matches = None
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            matches = lambda t, s=sub: s.id in target_names(t)  # noqa: E731
        elif isinstance(sub, ast.Attribute) and isinstance(
            sub.value, ast.Name
        ):
            matches = lambda t, s=sub: (  # noqa: E731
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == s.value.id
                and t.attr == s.attr
            )
        if matches is None:
            continue
        latest: Optional[ast.AST] = None
        latest_line = -1
        for node in walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            if node.lineno >= expr.lineno:
                continue
            if any(matches(t) for t in node.targets):
                if node.lineno > latest_line:
                    latest, latest_line = node.value, node.lineno
        if latest is not None and rank_parameterized(
            mod, scope, latest, depth - 1
        ):
            return True
    return False
