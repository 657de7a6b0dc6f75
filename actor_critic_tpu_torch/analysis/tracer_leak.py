"""tracer-leak: a host sync on a captured tensor inside a CUDA-graph
capture (the port's counterpart of JAX's Python control flow on a tracer
inside jit).

Inside a captured function (`analysis/capture_info.py`) the parameters are
tensors on the card whose addresses the graph bakes in. `if x > 0:`,
`while total > 0:`, `assert x.all()`, `bool(x)`, `int(x)`, `float(x)` and
`x.item()` on a value that flows from a parameter copy it to the host. On
the card that sync happens DURING the capture: the capture raises
("operation not permitted when stream is capturing"), or, where the value
was read before the capture began, the graph bakes in the branch taken
then and replays it forever. On the CPU the same code runs eagerly and
right, which is why only this check (and the card) sees it. The fix is
`torch.where`, a mask multiply, or a Python value closed over.

What does NOT flag (the near misses that keep the check usable):

- `.shape` / `.size()` / `.dim()` / `.ndim` / `.numel()` / `.dtype` /
  `.device` / `.is_cuda` derivations: host metadata, no sync;
- `len(x)`, `isinstance`, `hasattr`, `type`, `callable`;
- `x is None`, `a is b`: identity, never a sync;
- parameters annotated `int`/`float`/`bool`/`str` and `self`, and every
  value closed over (the captured function's static inputs).

`.item()`, `.tolist()` and `.cpu()` on a traced value flag wherever they
stand in a captured body, since each is a sync by itself. Taint flows
through assignments in the captured def (nested defs included: a body
defined inside a captured def runs in its capture).
"""

from __future__ import annotations

import ast

from actor_critic_tpu_torch.analysis.capture_info import captured_defs
from actor_critic_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register_check,
    target_names,
    walk,
)

CHECK = "tracer-leak"

# Attributes whose value is host metadata of a tensor (no sync).
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad",
                 "is_leaf", "names"}
# Methods returning host metadata.
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size", "stride",
                   "is_contiguous", "get_device", "data_ptr", "is_floating_point",
                   "is_complex"}
# Builtins whose result is concrete whatever the argument.
_STATIC_CALLS = {"len", "isinstance", "hasattr", "type", "getattr", "callable", "id"}
# Methods that copy a tensor's values to the host.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_BUILTINS = {"bool", "int", "float"}


class _Tainter:
    """Taint = "flows from a captured parameter", assignment-ordered by
    line within one captured def (nested defs share it)."""

    def __init__(self, mod: ModuleInfo, fn: ast.AST, tainted: set[str]):
        self.mod = mod
        self.tainted = set(tainted)
        assigns = []
        for node in walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    assigns.append((node.lineno, tgt, node.value))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
                assigns.append((node.lineno, node.target, node.value))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                assigns.append((node.lineno, node.target, node.iter))
        for _, tgt, value in sorted(assigns, key=lambda a: a[0]):
            names = target_names(tgt)
            if self.expr_tainted(value):
                self.tainted.update(names)
            else:
                self.tainted.difference_update(names)

    def expr_tainted(self, expr: ast.AST) -> bool:
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            return self.expr_tainted(expr.value)
        if isinstance(expr, ast.Call):
            if self.mod.dotted(expr.func) in _STATIC_CALLS:
                return False
            if isinstance(expr.func, ast.Attribute) and expr.func.attr in _STATIC_METHODS:
                return False
            return any(self.expr_tainted(a) for a in [*expr.args, *[k.value for k in expr.keywords]]
                       ) or self.expr_tainted(expr.func)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return False  # identity: never a sync
            return self.expr_tainted(expr.left) or any(self.expr_tainted(c)
                                                       for c in expr.comparators)
        if isinstance(expr, ast.BoolOp):
            return any(self.expr_tainted(v) for v in expr.values)
        if isinstance(expr, ast.UnaryOp):
            return self.expr_tainted(expr.operand)
        if isinstance(expr, ast.BinOp):
            return self.expr_tainted(expr.left) or self.expr_tainted(expr.right)
        if isinstance(expr, ast.Subscript):
            return self.expr_tainted(expr.value)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr_tainted(e) for e in expr.elts)
        if isinstance(expr, ast.IfExp):
            return any(self.expr_tainted(e) for e in (expr.test, expr.body, expr.orelse))
        if isinstance(expr, ast.Starred):
            return self.expr_tainted(expr.value)
        return False


@register_check(
    CHECK,
    "a host sync (if/while/assert/bool()/int()/float()/.item()) on a tensor inside a "
    "CUDA-graph capture (the capture raises, or bakes in the branch it read)",
)
def check_tracer_leak(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for cap in captured_defs(mod):
        fn = cap.node
        t = _Tainter(mod, fn, cap.traced_params())
        context = mod.enclosing_function(fn)

        def flag(node: ast.AST, what: str) -> None:
            findings.append(Finding(
                CHECK, mod.relpath, node.lineno, node.col_offset,
                f"{what} on a tensor of `{cap.name}`, which is captured into a CUDA graph "
                f"({cap.how}) — on the card the host sync runs during the capture: it raises, "
                "or the graph replays the branch read then; use torch.where or a mask, or "
                "pass a Python value in",
                context))

        for node in walk(fn):
            if isinstance(node, ast.If) and t.expr_tainted(node.test):
                flag(node, "Python `if`")
            elif isinstance(node, ast.While) and t.expr_tainted(node.test):
                flag(node, "Python `while`")
            elif isinstance(node, ast.Assert) and t.expr_tainted(node.test):
                flag(node, "`assert`")
            elif isinstance(node, ast.IfExp) and t.expr_tainted(node.test):
                flag(node, "conditional expression")
            elif isinstance(node, ast.Call):
                name = mod.dotted(node.func)
                if name in _SYNC_BUILTINS and node.args and t.expr_tainted(node.args[0]):
                    flag(node, f"`{name}()`")
                elif (isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS
                      and not node.args and t.expr_tainted(node.func.value)):
                    flag(node, f"`.{node.func.attr}()`")
    findings.sort(key=lambda f: (f.line, f.col))
    # One finding a line: `if x.item() > 0` is one defect.
    seen: set[int] = set()
    return [f for f in findings if not (f.line in seen or seen.add(f.line))]
