"""Which code of a module runs inside a CUDA-graph capture, and with what
static inputs (the port's counterpart of `actor_critic_tpu/analysis/jitinfo.py`).

JAX traces a function when `jax.jit` wraps it; the port captures work into
a CUDA graph on the card, through a handful of seams:

    loop.capture(graph) / torch.cuda.graph(graph)   a `with` block: its body
                                                     (and the local defs it
                                                     calls) is captured
    loop.CapturedStep(step, state)                   `step` is captured
    loop.warm_up(step, state, graphs)                `step` is captured
    HostUpdate(body, generator)                      `body` is captured
    BlockedEval(env, act_fn, ...)                    `act_fn` is captured
    make_*_step / make_*_update / make_*_train ...   the factory's returned
                                                     def is the program its
                                                     caller captures

A captured function's parameters are the tensors whose addresses the graph
bakes in (a jitted function's traced arguments); a parameter annotated
with a Python scalar type (`int`, `float`, `bool`, `str`) or named `self`
is static, and so is everything the function closes over (a jitted
function's static arguments and constants). On the CPU every one of these
runs eagerly; on the card a host sync inside one of them raises during the
capture or bakes in what it read.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Optional

from actor_critic_tpu_torch.analysis.core import ModuleInfo, target_names, terminal_name, walk

# Seam classes: an instance captures the callable passed in `CALLABLE_ARG`.
CAPTURE_CLASSES = {"CapturedStep": 0, "HostUpdate": 0, "BlockedEval": 1}
# Functions that capture their callable argument (the fused loop's warm-up).
CAPTURE_FUNCTIONS = {"warm_up": 0}
# Factories whose returned def is a program the caller captures (a train
# step, an update, an ingest). Acts and evals are left out: the port runs
# most of those eagerly, on the host's side.
CAPTURED_FACTORY_RE = re.compile(r"^make_\w*(update|step|train|ingest)\w*$")
# Factories whose result is dispatched per step, captured or not (the perf
# passes' program bindings; the JAX package's `_FACTORY_RE`).
PROGRAM_FACTORY_RE = re.compile(r"^make_\w*(update|step|train|ingest|enqueue|act|eval|rollout)\w*$")

_SCALAR_TYPES = {"int", "float", "bool", "str", "Optional[int]", "Optional[float]",
                 "Optional[bool]", "Optional[str]"}


def is_graph_ctor(mod: ModuleInfo, node: ast.AST) -> bool:
    """`torch.cuda.CUDAGraph()`."""
    return isinstance(node, ast.Call) and (
        mod.dotted(node.func) == "torch.cuda.CUDAGraph" or terminal_name(node.func) == "CUDAGraph")


def is_capture_context(mod: ModuleInfo, expr: ast.AST) -> bool:
    """A `with` item that captures its body: `torch.cuda.graph(g)` or the
    port's `loop.capture(g)` (every capture of the port goes through it)."""
    if not isinstance(expr, ast.Call):
        return False
    dotted = mod.dotted(expr.func) or ""
    if dotted == "torch.cuda.graph" or dotted.endswith("loop.capture"):
        return True
    return (isinstance(expr.func, ast.Name) and expr.func.id == "capture"
            and (mod.relpath.endswith("algos/loop.py")
                 or mod.aliases.get("capture", "").endswith("loop.capture")))


def seam_callable(mod: ModuleInfo, call: ast.Call) -> Optional[ast.AST]:
    """The callable a seam call captures (`CapturedStep(step, ...)` ->
    `step`), or None when `call` is no seam."""
    name = terminal_name(call.func)
    index = CAPTURE_CLASSES.get(name, CAPTURE_FUNCTIONS.get(name))
    if index is None:
        return None
    if name == "warm_up" and not (mod.dotted(call.func) or "").endswith("loop.warm_up") \
            and not mod.relpath.endswith("algos/loop.py"):
        return None
    if index < len(call.args):
        return call.args[index]
    keywords = {"CapturedStep": "step", "HostUpdate": "body", "BlockedEval": "act_fn",
                "warm_up": "step"}
    return next((k.value for k in call.keywords if k.arg == keywords[name]), None)


def is_seam_call(mod: ModuleInfo, node: ast.AST) -> bool:
    """A call that captures: a seam class or function, or a capture
    context manager."""
    return isinstance(node, ast.Call) and (
        terminal_name(node.func) in CAPTURE_CLASSES
        or seam_callable(mod, node) is not None
        or is_capture_context(mod, node))


def capture_withs(mod: ModuleInfo) -> list[ast.With]:
    """Every `with` block whose body is captured."""
    return [n for n in walk(mod.tree) if isinstance(n, ast.With)
            and any(is_capture_context(mod, item.context_expr) for item in n.items)]


def graph_of(with_node: ast.With, mod: ModuleInfo) -> Optional[ast.AST]:
    """The graph expression a capture `with` records into."""
    for item in with_node.items:
        if is_capture_context(mod, item.context_expr) and item.context_expr.args:
            return item.context_expr.args[0]
    return None


@dataclasses.dataclass
class CapturedDef:
    """A def (or lambda) whose body runs inside a capture on the card."""

    node: ast.AST
    how: str  # the seam, for messages ("CapturedStep", "make_train_step", ...)
    static: frozenset = frozenset()

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    def params(self) -> list[str]:
        a = self.node.args
        return [p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]]

    def traced_params(self) -> set[str]:
        return {p for p in self.params() if p not in self.static}


def _static_params(fn: ast.AST) -> frozenset:
    out = set()
    a = fn.args
    for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
        if p.arg in ("self", "cls"):
            out.add(p.arg)
        elif p.annotation is not None and ast.unparse(p.annotation) in _SCALAR_TYPES:
            out.add(p.arg)
    return frozenset(out)


def _resolve_def(mod: ModuleInfo, at: ast.AST, expr: ast.AST) -> Optional[ast.AST]:
    """The def a callable expression names: a lambda, a def of the
    enclosing scopes or the module (`step`), or a method of the enclosing
    class (`self._step`)."""
    if isinstance(expr, ast.Lambda):
        return expr
    if isinstance(expr, ast.Name):
        for anc in mod.ancestors(at):
            body = getattr(anc, "body", None)
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)) and body:
                for stmt in body:
                    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and stmt.name == expr.id:
                        return stmt
        return None
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        for anc in mod.ancestors(at):
            if isinstance(anc, ast.ClassDef):
                for stmt in anc.body:
                    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and stmt.name == expr.attr:
                        return stmt
                return None
    return None


def _returned_def(fn: ast.FunctionDef) -> Optional[ast.AST]:
    """The nested def (or lambda) a factory returns."""
    inner = {n.name: n for n in fn.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for node in walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            if isinstance(node.value, ast.Name) and node.value.id in inner:
                return inner[node.value.id]
            if isinstance(node.value, ast.Lambda):
                return node.value
    return None


def captured_defs(mod: ModuleInfo) -> list[CapturedDef]:
    """Every def of the module whose body a capture runs, each once."""
    out: dict[int, CapturedDef] = {}

    def add(fn: Optional[ast.AST], how: str) -> None:
        if fn is not None and id(fn) not in out:
            out[id(fn)] = CapturedDef(fn, how, _static_params(fn))

    for node in walk(mod.tree):
        if isinstance(node, ast.Call):
            target = seam_callable(mod, node)
            if target is not None:
                add(_resolve_def(mod, node, target), terminal_name(node.func))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and isinstance(mod.parent(node), ast.Module) \
                and CAPTURED_FACTORY_RE.match(node.name):
            add(_returned_def(node), node.name)
    for w in capture_withs(mod):
        for stmt in w.body:
            for sub in walk(stmt):
                if isinstance(sub, ast.Call):
                    add(_resolve_def(mod, sub, sub.func), "a capture block")
    return list(out.values())


def program_bindings(mod: ModuleInfo, scope: ast.AST) -> dict[str, str]:
    """name -> what it dispatches, for the names bound in `scope` (and at
    module level) from a program factory (`step = a2c.make_train_step(...)`)
    or a seam instance (`update = HostUpdate(...)`, `graph =
    CapturedStep(...)`): calling the name runs a program, captured on the
    card."""
    out: dict[str, str] = {}
    roots = [mod.tree] if isinstance(scope, ast.Module) else [scope]
    for root in roots + ([] if isinstance(scope, ast.Module) else [mod.tree]):
        stmts = walk(root) if root is scope else (
            s for s in root.body if isinstance(s, ast.Assign))
        for node in stmts:
            if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
                continue
            name = terminal_name(node.value.func) or ""
            if PROGRAM_FACTORY_RE.match(name) or name in CAPTURE_CLASSES:
                for tgt in node.targets:
                    for n in target_names(tgt):
                        out.setdefault(n, name)
    return out
