"""Performance passes: transfer-discipline, donation-discipline,
dispatch-granularity (the port's counterpart of
`actor_critic_tpu/analysis/perf.py`).

The port's step is bounded by launches and crossings: a graph replay holds
the host for the whole launch, and one stray sync in a steady-state body
serializes the pipeline. Each pass names one way that contract rots:

- **transfer-discipline** (alias: `host-sync`): host↔device crossings paid
  per step: `.item()`, `.cpu()`, `.numpy()`, `.tolist()`, `float()`/
  `int()`/`bool()` of a tensor, `torch.cuda.synchronize()` and
  `.synchronize()` (the host waits on the card), and `.cuda()`,
  `.to(<device>)`, `torch.tensor/as_tensor(..., device=)` (bytes cross),
  inside any loop of a hot module and inside the step loops of every other
  module (`perf_model.py`). Captured bodies are left out: they run in one
  graph.
- **donation-discipline**: a recycled ring, replay or parameter buffer
  rebuilt OUT OF PLACE where the port writes in place. (a) `buf =
  torch.cat([buf[1:], new])`, `torch.stack`, `buf.clone()`, `torch.roll`,
  `torch.where(..., buf)` rebinding the name it reads, on a buffer-named
  value (`ring`, `replay`, `params`, `state`, ...) or an object's field in
  a loop: a fresh allocation each time, and a graph that
  captured the old buffer keeps reading it; write it in place (`copy_`,
  `index_copy_`, `out=`). (b) a view bound from the buffer BEFORE such a
  rebuild and read after it: it still points into the old storage.
- **dispatch-granularity**: work that belongs inside one captured program
  launched as many: a Python `sum`/`min`/`max` over device values in a
  step loop (a launch per element and a sync at the end), eager torch math
  in a step-loop body outside any capture (its own launches every
  iteration), and two or more distinct programs dispatched unconditionally
  in one loop body (the gather/update split one graph would absorb).

The runtime companion, `analysis/perfsan.py`, counts dispatches,
transfers and recompiles on the real programs against
`perf_budgets.json`.
"""

from __future__ import annotations

import ast
from typing import Optional

from actor_critic_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register_check,
    target_names,
    walk,
    walk_local,
)
from actor_critic_tpu_torch.analysis.perf_model import (
    BUFFER_NAME_RE,
    PerfModel,
    crossing_kind,
    dispatched_program,
    eager_device_call,
    in_loop,
    is_hot_module,
)

TRANSFER_DISCIPLINE = "transfer-discipline"
DONATION_DISCIPLINE = "donation-discipline"
DISPATCH_GRANULARITY = "dispatch-granularity"

_REBUILDERS = {"torch.cat", "torch.concat", "torch.concatenate", "torch.stack",
               "torch.clone", "torch.roll", "torch.where", "torch.index_put",
               "torch.scatter", "torch.masked_scatter"}
_REBUILD_METHODS = {"clone", "index_put", "scatter", "masked_scatter", "roll"}
_PY_REDUCERS = {"sum", "min", "max"}

_SHARED: dict = {}


def _model(mod: ModuleInfo) -> PerfModel:
    cache = _SHARED.setdefault("models", {})
    entry = cache.get(id(mod))
    if entry is None or entry[0] is not mod:
        if len(cache) > 1024:
            cache.clear()
        entry = (mod, PerfModel(mod))
        cache[id(mod)] = entry
    return entry[1]


# ---------------------------------------------------------------------------
# transfer-discipline
# ---------------------------------------------------------------------------


@register_check(
    TRANSFER_DISCIPLINE,
    "host<->device crossings (.item()/.cpu()/.numpy()/float()/synchronize() syncs; "
    ".cuda()/.to(device)/torch.tensor(device=) copies) inside steady-state loop bodies "
    "— absorbs host-sync",
)
def check_transfer_discipline(mod: ModuleInfo) -> list[Finding]:
    model = _model(mod)
    hot = is_hot_module(mod)
    findings: list[Finding] = []
    for node in walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if hot:
            if in_loop(mod, node) is None:
                continue
        elif not model.in_step_loop(node):
            continue
        if model.inside_capture(node):
            continue
        kind = crossing_kind(mod, node)
        if kind is None:
            continue
        desc, direction = kind
        if direction == "d2h":
            msg = (f"{desc} inside a steady-state loop blocks the host on the card every "
                   "iteration, serializing the launch pipeline — hoist it to the log cadence, "
                   "keep the value on the card, or suppress with the reason if the sync is "
                   "deliberate")
        else:
            msg = (f"{desc} inside a steady-state loop copies between host and card every "
                   "iteration — keep the buffer resident (write it in place, stage it once), "
                   "or suppress with the reason if this copy IS the data plane (and then it "
                   "carries a perfsan transfer budget)")
        findings.append(Finding(TRANSFER_DISCIPLINE, mod.relpath, node.lineno,
                                node.col_offset, msg, mod.enclosing_function(node)))
    return findings


# ---------------------------------------------------------------------------
# donation-discipline
# ---------------------------------------------------------------------------


def _path(node: ast.AST) -> Optional[str]:
    """"a.b.c" of a Name/Attribute chain, None otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _reads_path(expr: ast.AST, path: str) -> bool:
    for sub in walk(expr):
        p = _path(sub) if isinstance(sub, (ast.Name, ast.Attribute)) else None
        if p == path:
            return True
    return False


def _rebuild(mod: ModuleInfo, node: ast.Assign) -> Optional[tuple[str, ast.Call]]:
    """(buffer path, call) when `node` rebinds a buffer to an out-of-place
    rebuild of itself."""
    value = node.value
    if not isinstance(value, ast.Call) or len(node.targets) != 1:
        return None
    path = _path(node.targets[0])
    if path is None:
        return None
    if any(k.arg == "out" for k in value.keywords):
        return None
    if mod.dotted(value.func) in _REBUILDERS:
        if any(_reads_path(a, path) for a in value.args):
            return path, value
    elif (isinstance(value.func, ast.Attribute) and value.func.attr in _REBUILD_METHODS
          and _path(value.func.value) == path):
        return path, value
    return None


@register_check(
    DONATION_DISCIPLINE,
    "a recycled ring/replay/params buffer rebuilt out of place (torch.cat/stack/clone "
    "rebinding its own name) where the port writes in place, and views of it read after "
    "the rebuild",
)
def check_donation_discipline(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    scopes = [n for n in walk(mod.tree) if isinstance(n, (ast.FunctionDef,
                                                             ast.AsyncFunctionDef))]
    for scope in scopes:
        assigns = [n for n in walk_local(scope) if isinstance(n, ast.Assign)]
        for node in assigns:
            hit = _rebuild(mod, node)
            if hit is None:
                continue
            path, call = hit
            if BUFFER_NAME_RE.search(path.rsplit(".", 1)[-1]) or (
                    "." in path and in_loop(mod, node) is not None):
                findings.append(Finding(
                    DONATION_DISCIPLINE, mod.relpath, call.lineno, call.col_offset,
                    f"`{path}` is rebuilt out of place (`{ast.unparse(call.func)}` rebinding "
                    "the name it reads): a fresh buffer every time, and a CUDA graph that "
                    "captured the old one keeps reading it — write it in place (`copy_`, "
                    "`index_copy_`, `out=`), or suppress with the reason the copy is "
                    "load-bearing",
                    mod.enclosing_function(node)))
            # (b) views of the buffer bound before the rebuild, read after it.
            aliases: dict[str, int] = {}
            for other in assigns:
                if other.lineno >= node.lineno or isinstance(other.value, ast.Call):
                    continue
                root = other.value
                while isinstance(root, ast.Subscript):
                    root = root.value
                if _path(root) == path:
                    for tgt in other.targets:
                        for name in target_names(tgt):
                            if name != path:
                                aliases[name] = other.lineno
            if not aliases:
                continue
            rebinds: dict[str, list[int]] = {}
            for other in assigns:
                if other.lineno > node.lineno:
                    for tgt in other.targets:
                        for name in target_names(tgt):
                            rebinds.setdefault(name, []).append(other.lineno)
            for sub in walk_local(scope):
                if (isinstance(sub, ast.Name) and sub.id in aliases
                        and isinstance(sub.ctx, ast.Load) and sub.lineno > node.lineno
                        and not any(node.lineno < ln <= sub.lineno
                                    for ln in rebinds.get(sub.id, ()))
                        and not mod.exclusive_branches(node, sub)):
                    findings.append(Finding(
                        DONATION_DISCIPLINE, mod.relpath, sub.lineno, sub.col_offset,
                        f"`{sub.id}` is a view of `{path}` (bound at line {aliases[sub.id]}), "
                        f"which line {node.lineno} rebuilt out of place — the view still reads "
                        "the old storage; re-derive it after the rebuild, or write the buffer "
                        "in place",
                        mod.enclosing_function(sub)))
                    break
    findings.sort(key=lambda f: (f.line, f.col))
    return findings


# ---------------------------------------------------------------------------
# dispatch-granularity
# ---------------------------------------------------------------------------


def _gated_in_loop(mod: ModuleInfo, node: ast.AST, loop: ast.AST) -> bool:
    """Whether `node` sits under an `if`, or in a nested def or lambda,
    between itself and `loop` (cadence-gated work, not the per-iteration
    chain)."""
    for anc in mod.ancestors(node):
        if anc is loop:
            return False
        if isinstance(anc, (ast.If, ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return True
    return False


@register_check(
    DISPATCH_GRANULARITY,
    "Python reductions over device values, eager torch math, and multi-program dispatch "
    "chains inside per-step loops outside a capture — work that belongs in one graph",
)
def check_dispatch_granularity(mod: ModuleInfo) -> list[Finding]:
    model = _model(mod)
    if not model.loops:
        return []
    findings: list[Finding] = []
    for node in walk(mod.tree):
        if not isinstance(node, ast.Call) or not model.in_step_loop(node):
            continue
        if model.inside_capture(node):
            continue
        bindings = model.bindings(node)
        if (isinstance(node.func, ast.Name) and node.func.id in _PY_REDUCERS and node.args
                and any(isinstance(sub, ast.Call) and (
                    eager_device_call(mod, sub) or dispatched_program(mod, sub, bindings))
                        for sub in walk(node.args[0]))):
            findings.append(Finding(
                DISPATCH_GRANULARITY, mod.relpath, node.lineno, node.col_offset,
                f"Python `{node.func.id}()` over device values inside a step loop launches per "
                "element and syncs at the end, every iteration — reduce inside the captured "
                "program (torch.sum/amax in the step) or at the log cadence",
                mod.enclosing_function(node)))
            continue
        op = eager_device_call(mod, node)
        if op is not None and not any(
                isinstance(a, ast.Call) and isinstance(a.func, ast.Name)
                and a.func.id in _PY_REDUCERS for a in mod.ancestors(node)):
            findings.append(Finding(
                DISPATCH_GRANULARITY, mod.relpath, node.lineno, node.col_offset,
                f"eager `{op}` inside a step loop launches its own kernels every iteration, "
                "outside the captured program — move it into the step (one replay per "
                "iteration is the contract), or suppress with the reason this site is cold",
                mod.enclosing_function(node)))
    for loop in model.loops:
        bindings = model.bindings(loop)
        body_calls: dict[str, ast.Call] = {}
        for sub in walk(loop):
            if (isinstance(sub, ast.Call) and not model.inside_capture(sub)
                    and not _gated_in_loop(mod, sub, loop)):
                program = dispatched_program(mod, sub, bindings)
                if program is not None:
                    body_calls.setdefault(program, sub)
        chain = [c for c in body_calls.values()
                 if not any(mod.exclusive_branches(c, o) for o in body_calls.values() if o is not c)]
        if len(chain) >= 2:
            chain.sort(key=lambda c: (c.lineno, c.col_offset))
            names = sorted(k for k, c in body_calls.items() if c in chain)
            findings.append(Finding(
                DISPATCH_GRANULARITY, mod.relpath, chain[0].lineno, chain[0].col_offset,
                f"step loop dispatches {len(chain)} distinct programs per iteration "
                f"({', '.join(f'`{n}`' for n in names)}) — one captured program would hold "
                "them (the device plane's fused update is that shape); fuse them, or "
                "suppress with the reason the split is load-bearing",
                mod.enclosing_function(chain[0])))
    findings.sort(key=lambda f: (f.line, f.col))
    return findings
