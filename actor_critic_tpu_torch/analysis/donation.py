"""donation-aliasing: a captured graph's static tensors rebound where they
must be written in place, and a graph's outputs read after the next replay
(the port's counterpart of JAX's donated buffers fed restore-aliased or
still-live arrays).

A CUDA graph records the ADDRESSES of the tensors it reads and writes: the
state's tensors are its static inputs, and the tensors a replay returns
are its static outputs, rewritten by every replay. Two hazards follow:

1. **A restored tensor rebound into a captured state.** After a resume
   (`Checkpointer.restore`, `resume_or_init`, `host_resume`, `torch.load`),
   the restored values must be COPIED into the tensors the graph captured
   (`t.copy_(restored[k])`, as `loop.restored` and the loop's resume do). A
   rebinding (`state.params = restored["params"]`, `ring.storage =
   restored[...]`) leaves the graph reading the old tensor: the replay runs
   on the pre-restore values while eager code reads the new ones. Flagged
   where a restore-tainted value is stored into an attribute or subscript
   of an object the scope captures (an argument of a capture seam) or
   replays a graph over afterwards.
2. **An output read after the next replay.** `loop.CapturedStep.replay()`
   and a `HostUpdate` return the graph's output tensors, "valid until the
   next replay". A name (or a view: `out["loss"]`) bound from one replay
   and read after a later replay of the same graph reads the later
   replay's values; replay outputs collected in a loop or comprehension
   (`hist.append(step.replay())`) are all the same tensors. Snapshot them
   (`.clone()`, `float(...)`, `.item()` at the log cadence) first.

Dataflow is per top-level function, in statement order.
"""

from __future__ import annotations

import ast
from typing import Optional

from actor_critic_tpu_torch.analysis.capture_info import is_seam_call, program_bindings
from actor_critic_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register_check,
    target_names,
    terminal_name,
    walk,
)

CHECK = "donation-aliasing"

_RESTORE_FUNCS = {"resume_or_init", "host_resume", "restore"}
_RESTORE_DOTTED = {"torch.load"}
# Calls that snapshot a replay's output (a fresh tensor or a host value).
_SNAPSHOT_METHODS = {"clone", "item", "tolist", "cpu", "numpy", "copy"}
_SNAPSHOT_CALLS = {"float", "int", "bool", "dict", "copy.deepcopy", "torch.clone"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_restore(mod: ModuleInfo, value: ast.AST) -> bool:
    return isinstance(value, ast.Call) and (
        terminal_name(value.func) in _RESTORE_FUNCS or mod.dotted(value.func) in _RESTORE_DOTTED)


def _restored_names(mod: ModuleInfo, scope: ast.AST) -> dict[str, int]:
    """name -> line it was bound from a restore (aliases by name, subscript
    and attribute propagate; any other call is a fresh value)."""
    out: dict[str, int] = {}
    assigns = sorted((n for n in walk(scope) if isinstance(n, ast.Assign)),
                     key=lambda n: n.lineno)
    for node in assigns:
        value = node.value
        tainted = _is_restore(mod, value) or (
            not isinstance(value, ast.Call) and _root_name(value) in out)
        for tgt in node.targets:
            for name in target_names(tgt):
                if tainted:
                    out[name] = node.lineno
                else:
                    out.pop(name, None)
    return out


def _rebind_findings(mod: ModuleInfo, scope: ast.AST) -> list[Finding]:
    restored = _restored_names(mod, scope)
    if not restored:
        return []
    seam_args: dict[str, int] = {}
    replays: list[int] = []
    for node in walk(scope):
        if isinstance(node, ast.Call):
            if is_seam_call(mod, node):
                for a in [*node.args, *[k.value for k in node.keywords]]:
                    r = _root_name(a)
                    if r is not None:
                        seam_args.setdefault(r, node.lineno)
            if isinstance(node.func, ast.Attribute) and node.func.attr == "replay":
                replays.append(node.lineno)
    findings = []
    for node in walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        value_root = _root_name(node.value) if not isinstance(node.value, ast.Call) else None
        direct = _is_restore(mod, node.value)
        if not direct and value_root not in restored:
            continue
        for tgt in node.targets:
            if not isinstance(tgt, (ast.Attribute, ast.Subscript)):
                continue
            root = _root_name(tgt)
            if root is None or root in restored:
                continue
            captured = seam_args.get(root, node.lineno + 1) <= node.lineno or any(
                ln > node.lineno for ln in replays)
            if not captured:
                continue
            findings.append(Finding(
                CHECK, mod.relpath, node.value.lineno, node.value.col_offset,
                f"a restored tensor is rebound into `{ast.unparse(tgt)}`, which a CUDA graph "
                "captured — the graph keeps reading the old tensor's address, so its replays "
                "run on the pre-restore values; copy it in place "
                f"(`{ast.unparse(tgt)}.copy_(...)`)",
                mod.enclosing_function(node)))
    return findings


def _replay_source(mod: ModuleInfo, value: ast.AST, updates: set[str]) -> Optional[str]:
    """The graph a value is (a view of) the output of: `R.replay()` -> "R",
    `update()` of a HostUpdate binding -> "update", `R.replay()["k"]` too."""
    while isinstance(value, ast.Subscript):
        value = value.value
    if not isinstance(value, ast.Call):
        return None
    if isinstance(value.func, ast.Attribute) and value.func.attr == "replay" and not value.args:
        return ast.unparse(value.func.value)
    if isinstance(value.func, ast.Name) and value.func.id in updates and not value.args:
        return value.func.id
    return None


def _is_replay_of(mod: ModuleInfo, node: ast.AST, graph: str, updates: set[str]) -> bool:
    return isinstance(node, ast.Call) and _replay_source(mod, node, updates) == graph


def _snapshotted(mod: ModuleInfo, node: ast.AST, stop: ast.AST) -> bool:
    for anc in mod.ancestors(node):
        if anc is stop:
            return False
        if isinstance(anc, ast.Call):
            if isinstance(anc.func, ast.Attribute) and anc.func.attr in _SNAPSHOT_METHODS:
                return True
            if mod.dotted(anc.func) in _SNAPSHOT_CALLS:
                return True
        if isinstance(anc, (ast.DictComp, ast.ListComp)) and anc is not stop:
            # {k: v.clone() for k, v in out.items()} snapshots each entry
            elt = anc.value if isinstance(anc, ast.DictComp) else anc.elt
            if isinstance(elt, ast.Call) and (
                    (isinstance(elt.func, ast.Attribute) and elt.func.attr in _SNAPSHOT_METHODS)
                    or mod.dotted(elt.func) in _SNAPSHOT_CALLS):
                return True
    return False


def _output_findings(mod: ModuleInfo, scope: ast.AST) -> list[Finding]:
    updates = {n for n, made in program_bindings(mod, scope).items() if made == "HostUpdate"}
    findings = []
    calls = [n for n in walk(scope) if isinstance(n, ast.Call)]
    loads = [n for n in walk(scope) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]
    binds = [n for n in walk(scope) if isinstance(n, ast.Assign)]
    pos = lambda n: (n.lineno, n.col_offset)  # noqa: E731
    for node in binds:
        graph = _replay_source(mod, node.value, updates)
        if graph is None or _snapshotted(mod, node.value, node):
            continue
        names = {n for t in node.targets for n in target_names(t)}
        loop = next((a for a in mod.ancestors(node) if isinstance(a, _LOOPS)
                     or isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))), None)
        if isinstance(loop, _LOOPS) and any(
                isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and c.func.attr in ("append", "extend", "put")
                and any(isinstance(a, ast.Name) and a.id in names for a in c.args)
                for c in walk(loop)):
            findings.append(Finding(
                CHECK, mod.relpath, node.value.lineno, node.value.col_offset,
                f"`{sorted(names)[0]}` holds the output of `{graph}`'s replay and is "
                "collected in a loop — every replay returns the same tensors, rewritten in "
                "place, so every entry reads the last replay's values; clone it",
                mod.enclosing_function(node)))
            continue
        later = sorted((c for c in calls if _is_replay_of(mod, c, graph, updates)
                        and pos(c) > pos(node.value) and c is not node.value
                        and not mod.exclusive_branches(c, node)), key=pos)
        if not later:
            continue
        nxt = later[0]
        rebinds = [b.lineno for b in binds if b is not node
                   and {n for t in b.targets for n in target_names(t)} & names]
        stale = [n for n in loads if n.id in names and pos(n) > pos(nxt)
                 and not any(node.lineno < ln <= n.lineno for ln in rebinds)]
        if stale:
            findings.append(Finding(
                CHECK, mod.relpath, node.value.lineno, node.value.col_offset,
                f"`{sorted(names)[0]}` holds the output of `{graph}`'s replay, read at line "
                f"{stale[0].lineno} after the next replay (line {nxt.lineno}) rewrote it in "
                "place — a replay's outputs are valid until the next replay; clone them, or "
                "read them first",
                mod.enclosing_function(node)))
    # Outputs collected in a loop: every entry is the same tensors.
    for call in calls:
        graph = _replay_source(mod, call, updates)
        if graph is None:
            continue
        loop = next((a for a in mod.ancestors(call) if isinstance(a, _LOOPS)
                     or isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))), None)
        if loop is None or not isinstance(loop, _LOOPS) or _snapshotted(mod, call, loop):
            continue
        parent = mod.parent(call)
        collected = (isinstance(loop, (ast.ListComp, ast.SetComp, ast.GeneratorExp))
                     and loop.elt is call) or (isinstance(loop, ast.DictComp) and loop.value is call)
        if (isinstance(parent, ast.Call) and isinstance(parent.func, ast.Attribute)
                and parent.func.attr in ("append", "extend", "put") and call in parent.args):
            collected = True
        if collected:
            findings.append(Finding(
                CHECK, mod.relpath, call.lineno, call.col_offset,
                f"outputs of `{graph}`'s replays are collected in a loop — every replay "
                "returns the same tensors, rewritten in place, so every entry reads the last "
                "replay's values; clone each one",
                mod.enclosing_function(call)))
    return findings


@register_check(
    CHECK,
    "restored tensors rebound into a captured state (the graph reads the old addresses), "
    "and CUDA-graph outputs read after the next replay",
)
def check_donation_aliasing(mod: ModuleInfo) -> list[Finding]:
    scopes = [mod.tree] + [n for n in mod.tree.body
                           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    scopes += [m for c in mod.tree.body if isinstance(c, ast.ClassDef) for m in c.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
    findings = []
    for scope in scopes:
        if isinstance(scope, ast.Module):
            continue
        findings += _rebind_findings(mod, scope) + _output_findings(mod, scope)
    findings.sort(key=lambda f: (f.line, f.col))
    return findings
