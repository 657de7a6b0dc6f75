"""recompile-hazard: call patterns that defeat capture-once (the port's
counterpart of JAX's jit built in a loop, and shape-derived scalars at
jitted call sites).

On the card every program of the port is captured once into a CUDA graph
and replayed from then on; a capture costs an eager warm-up, the capture
itself (milliseconds to seconds) and a `recompiles` event. Two patterns,
both visible from source:

1. **A capture inside a loop**: `torch.cuda.CUDAGraph()`,
   `loop.CapturedStep(...)`, `loop.capture(...)`/`torch.cuda.graph(...)`
   evaluated in a `for`/`while`/comprehension body captures afresh every
   iteration. Hoist it out of the loop. A capture stored under the loop's
   key (`captured[n] = CapturedStep(..., n)`, one graph per steps-per-replay
   as `loop.warm_up` keeps them) is a cache, not a storm, and stays clean.
2. **A shape-derived Python value fed to a captured program**: a
   `len(...)`/`.shape`-derived scalar (directly or through a local name), or
   a slice whose bound is a variable, passed to a program a factory made
   (`make_*_step`/`_update`/...) or to a seam instance. The graph bakes in
   the value (or the shape) of its capture: every other value needs a
   capture of its own, or silently replays the first. Pad to a bucket
   (`compile_cache.pad_to_bucket`) or pass the value in a device tensor
   (`torch.as_tensor(n)`, written by `copy_` before each replay).
"""

from __future__ import annotations

import ast
from typing import Optional

from actor_critic_tpu_torch.analysis.capture_info import (
    CAPTURE_CLASSES,
    is_capture_context,
    is_graph_ctor,
    program_bindings,
)
from actor_critic_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register_check,
    terminal_name,
    walk,
)

CHECK = "recompile-hazard"

_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)
_AS_TENSOR = {"torch.as_tensor", "torch.tensor", "torch.full", "torch.scalar_tensor"}


def _innermost_loop(mod: ModuleInfo, node: ast.AST) -> Optional[ast.AST]:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return None
        if isinstance(anc, _LOOPS):
            return anc
    return None


def _loop_keys(loop: ast.AST) -> set[str]:
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        targets = [loop.target]
    elif isinstance(loop, ast.While):
        return set()
    else:
        targets = [g.target for g in loop.generators]
    return {n.id for t in targets for n in walk(t) if isinstance(n, ast.Name)}


def _keyed_cache_store(mod: ModuleInfo, node: ast.AST, loop: ast.AST) -> bool:
    """`cache[key] = <capture>` with `key` a loop variable, or under an
    `if key not in cache:` guard: one capture per key, a cache."""
    parent = mod.parent(node)
    if not isinstance(parent, ast.Assign) or parent.value is not node:
        return False
    keys = _loop_keys(loop)
    for t in parent.targets:
        if not isinstance(t, ast.Subscript):
            continue
        if {n.id for n in walk(t.slice) if isinstance(n, ast.Name)} & keys:
            return True
        guard = (ast.unparse(t.slice), ast.unparse(t.value))
        for anc in mod.ancestors(node):
            if anc is loop:
                break
            test = getattr(anc, "test", None) if isinstance(anc, ast.If) else None
            if (isinstance(test, ast.Compare) and len(test.ops) == 1
                    and isinstance(test.ops[0], ast.NotIn)
                    and (ast.unparse(test.left), ast.unparse(test.comparators[0])) == guard):
                return True
    return False


def _is_shape_derived(mod: ModuleInfo, expr: ast.AST) -> Optional[str]:
    if isinstance(expr, ast.Call) and mod.dotted(expr.func) == "len":
        return "a len(...) value"
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in ("size", "numel", "dim"):
        return f"a .{expr.func.attr}() value"
    if isinstance(expr, ast.Attribute) and expr.attr == "shape":
        return "a .shape tuple"
    if isinstance(expr, ast.Subscript) and isinstance(expr.value, ast.Attribute) \
            and expr.value.attr == "shape":
        return "a .shape[i] value"
    if isinstance(expr, ast.BinOp):
        return _is_shape_derived(mod, expr.left) or _is_shape_derived(mod, expr.right)
    return None


def _variable_slice(expr: ast.AST) -> bool:
    """`x[:n]`, `x[a:b]` with a bound that is not a constant."""
    if not isinstance(expr, ast.Subscript):
        return False
    slices = expr.slice.elts if isinstance(expr.slice, ast.Tuple) else [expr.slice]
    return any(isinstance(s, ast.Slice) and any(
        b is not None and not isinstance(b, ast.Constant) for b in (s.lower, s.upper))
        for s in slices)


def _latest_assignment(scope: ast.AST, name: str, before: int) -> Optional[ast.AST]:
    best_line, best = -1, None
    for node in walk(scope):
        if isinstance(node, ast.Assign) and node.lineno < before:
            for tgt in node.targets:
                elts = [tgt] if isinstance(tgt, ast.Name) else (
                    tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [])
                if any(isinstance(t, ast.Name) and t.id == name for t in elts) \
                        and node.lineno > best_line:
                    best_line, best = node.lineno, node.value
    return best


def _describe(mod: ModuleInfo, scope: ast.AST, call: ast.Call, arg: ast.AST) -> Optional[str]:
    if isinstance(arg, ast.Call) and mod.dotted(arg.func) in _AS_TENSOR:
        return None  # a device tensor: the sanctioned dynamic form
    if _variable_slice(arg):
        return f"`{ast.unparse(arg)}` (a slice with a variable bound)"
    desc = _is_shape_derived(mod, arg)
    if desc is None and isinstance(arg, ast.Name):
        value = _latest_assignment(scope, arg.id, call.lineno)
        if value is not None:
            derived = _is_shape_derived(mod, value)
            if derived is not None:
                desc = f"`{arg.id}` ({derived})"
            elif _variable_slice(value):
                desc = f"`{arg.id}` (a slice with a variable bound)"
    return desc


@register_check(
    CHECK,
    "a CUDA-graph capture inside a loop, or a shape-/len()-derived value fed to a "
    "captured program (a capture per iteration / a value baked into the graph)",
)
def check_recompile_hazard(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for node in walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        what = None
        if is_graph_ctor(mod, node):
            what = "torch.cuda.CUDAGraph()"
        elif terminal_name(node.func) in ("CapturedStep",):
            what = "loop.CapturedStep(...)"
        elif is_capture_context(mod, node):
            what = f"{ast.unparse(node.func)}(...)"
        if what is None:
            continue
        loop = _innermost_loop(mod, node)
        if loop is None or _keyed_cache_store(mod, node, loop):
            continue
        findings.append(Finding(
            CHECK, mod.relpath, node.lineno, node.col_offset,
            f"{what} evaluated inside a loop — every iteration captures a fresh graph (a "
            "warm-up and a capture per iteration, each a recompile); hoist the capture out "
            "of the loop, or keep one graph per key (`graphs[n] = ...`)",
            mod.enclosing_function(node)))

    bindings_by_scope: dict[int, dict[str, str]] = {}
    for call in walk(mod.tree):
        if not isinstance(call, ast.Call) or not isinstance(call.func, ast.Name):
            continue
        scope = mod.scope_of(call)
        if id(scope) not in bindings_by_scope:
            bindings_by_scope[id(scope)] = program_bindings(mod, scope)
        made_by = bindings_by_scope[id(scope)].get(call.func.id)
        if made_by is None or made_by in CAPTURE_CLASSES and made_by != "HostUpdate":
            continue
        args = [a for a in call.args if not isinstance(a, ast.Starred)]
        args += [k.value for k in call.keywords if k.arg is not None]
        for arg in args:
            desc = _describe(mod, scope, call, arg)
            if desc is not None:
                findings.append(Finding(
                    CHECK, mod.relpath, arg.lineno, arg.col_offset,
                    f"captured program `{call.func.id}` (from `{made_by}`) is fed {desc} — a "
                    "CUDA graph bakes in the value and shape of its capture, so every other "
                    "value needs its own capture or replays the first; pad to a bucket "
                    "(compile_cache.pad_to_bucket) or pass it in a device tensor "
                    "(torch.as_tensor)",
                    mod.enclosing_function(call)))
    return findings
