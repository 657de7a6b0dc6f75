"""prng-reuse: a random stream drawn twice where it should be drawn once
(the port's counterpart of JAX's one PRNG key consumed twice).

The port's randomness is `torch.Generator`s: a trainer's (`state.generator`),
an eval's, a serving lane's. Three ways one stream repeats itself:

1. **An unregistered generator inside a capture.** A CUDA graph bakes a
   generator's seed and offset into its kernels unless the generator is
   registered with the graph (`graph.register_generator_state(gen)`, as
   `loop.CapturedStep` does for `state.generator`): then every replay
   reads the generator's current offset and advances it. A draw from a
   generator not registered with the capturing graph fails the capture on
   the card: torch raises "Attempt to increase offset for a CUDA generator
   not in capture mode" (torch 2.11 on an H100; it does not capture the
   draw and repeat it). Flagged: a call inside a capture block that
   passes a generator (`generator=g`, or a `generator`/`gen`/`rng` argument)
   not registered with that block's graph, and a capture of a callable
   passed in from outside (`step`, whose state carries a generator) on a
   graph with no generator registered at all.
2. **Two generators of one kind seeded from the same seed expression** in
   one scope, without an offset (`manual_seed(seed)` twice): two identical
   streams, correlated exploration, the same minibatch order. A CPU
   generator (the weights' draws) and a device one (the trainer's) seeded
   alike are two kinds and pass: on the card they are different streams.
3. **A generator re-seeded inside a loop** from a seed the loop never
   changes: every iteration restarts the same stream.

Seedings in exclusive `if` arms are alternatives and never pair.
"""

from __future__ import annotations

import ast
from typing import Optional

from actor_critic_tpu_torch.analysis.capture_info import capture_withs, graph_of
from actor_critic_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register_check,
    target_names,
    walk,
    walk_local,
)

CHECK = "prng-reuse"

_GENERATOR_NAMES = {"generator", "gen", "rng", "twin"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)


def _is_generator_expr(expr: ast.AST) -> bool:
    name = expr.attr if isinstance(expr, ast.Attribute) else (
        expr.id if isinstance(expr, ast.Name) else None)
    return name is not None and (name in _GENERATOR_NAMES or name.endswith("generator"))


def _enclosing_def(mod: ModuleInfo, node: ast.AST) -> ast.AST:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return mod.tree


def _registered(mod: ModuleInfo, scope: ast.AST, graph: str) -> Optional[set[str]]:
    """The generator expressions registered with `graph` in `scope` (None
    when none is)."""
    out = set()
    for node in walk(scope):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "register_generator_state" and node.args
                and ast.unparse(node.func.value) == graph):
            out.add(ast.unparse(node.args[0]))
    return out or None


def _capture_findings(mod: ModuleInfo) -> list[Finding]:
    findings = []
    for w in capture_withs(mod):
        graph = graph_of(w, mod)
        if graph is None:
            continue
        gtext = ast.unparse(graph)
        scope = _enclosing_def(mod, w)
        registered = _registered(mod, scope, gtext)
        params = set()
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = scope.args
            params = {p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]}
        for stmt in w.body:
            for call in walk_local(stmt):
                if not isinstance(call, ast.Call):
                    continue
                drawn = [k.value for k in call.keywords if k.arg == "generator"]
                drawn += [a for a in call.args if _is_generator_expr(a)]
                for g in drawn:
                    if registered is None or ast.unparse(g) not in registered:
                        findings.append(Finding(
                            CHECK, mod.relpath, call.lineno, call.col_offset,
                            f"`{ast.unparse(g)}` is drawn from inside the capture on `{gtext}` "
                            "but not registered with it — on the card the capture raises "
                            "(torch: \"Attempt to increase offset for a CUDA generator not in "
                            "capture mode\"); call "
                            f"`{gtext}.register_generator_state({ast.unparse(g)})` before the "
                            "capture",
                            mod.enclosing_function(call)))
                if (registered is None and not drawn and isinstance(call.func, ast.Name)
                        and call.func.id in params and call.args):
                    findings.append(Finding(
                        CHECK, mod.relpath, call.lineno, call.col_offset,
                        f"`{call.func.id}`, a callable passed in, is captured on `{gtext}` with "
                        "no generator registered — a step that draws from its state's "
                        "generator makes the capture raise on the card (\"Attempt to increase "
                        "offset for a CUDA generator not in capture mode\"); register it "
                        f"(`{gtext}.register_generator_state(state.generator)`, as "
                        "loop.CapturedStep does)",
                        mod.enclosing_function(call)))
    return findings


def _seed_call(call: ast.AST) -> Optional[ast.AST]:
    """The seed expression of `g.manual_seed(E)` / `torch.manual_seed(E)`."""
    if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr == "manual_seed" and len(call.args) == 1):
        return call.args[0]
    return None


def _generator_kind(mod: ModuleInfo, seed_call: ast.Call) -> Optional[str]:
    """What kind of generator `seed_call` seeds, where it says: the device
    arguments of `torch.Generator(...)` ("" for the CPU's), "torch" for the
    global one; None for a generator named elsewhere."""
    recv = seed_call.func.value
    if mod.dotted(recv) == "torch":
        return "torch"
    if isinstance(recv, ast.Call) and (mod.dotted(recv.func) or "").endswith("Generator"):
        return ast.dump(ast.Tuple(elts=[*recv.args, *[k.value for k in recv.keywords]],
                                  ctx=ast.Load()))
    return None


def _same_kind(mod: ModuleInfo, a: ast.Call, b: ast.Call) -> bool:
    """Whether two seedings may seed one kind of generator: a CPU generator
    and a device one run different algorithms (one stream each from one
    seed), so only a pair of one kind, or of an unknown kind, repeats."""
    ka, kb = _generator_kind(mod, a), _generator_kind(mod, b)
    return ka is None or kb is None or ka == kb


def _names_in(expr: ast.AST) -> set[str]:
    return {n.id for n in walk(expr) if isinstance(n, ast.Name)}


def _bound_lines(scope: ast.AST, names: set[str]) -> list[int]:
    out = []
    for node in walk(scope):
        if isinstance(node, ast.Assign):
            if any(set(target_names(t)) & names for t in node.targets):
                out.append(node.lineno)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if set(target_names(node.target)) & names:
                out.append(node.lineno)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            if set(target_names(node.target)) & names:
                out.append(getattr(node, "lineno", getattr(node.target, "lineno", 0)))
    return out


def _seed_findings(mod: ModuleInfo) -> list[Finding]:
    findings = []
    scopes = [mod.tree] + [n for n in walk(mod.tree)
                           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        seeds = [(c, _seed_call(c)) for c in walk_local(scope) if _seed_call(c) is not None]
        seeds.sort(key=lambda s: (s[0].lineno, s[0].col_offset))
        for i, (call, expr) in enumerate(seeds):
            names = _names_in(expr)
            # 3. re-seeded in a loop from a seed the loop never changes.
            loop = next((a for a in mod.ancestors(call) if isinstance(a, _LOOPS)), None)
            if loop is not None:
                if not _bound_lines(loop, names) and not any(isinstance(n, ast.Call)
                                                              for n in walk(expr)):
                    findings.append(Finding(
                        CHECK, mod.relpath, call.lineno, call.col_offset,
                        f"a generator is seeded inside a loop from `{ast.unparse(expr)}`, which "
                        "the loop never changes — every iteration restarts the same stream; "
                        "seed once before the loop, or fold the iteration into the seed",
                        mod.enclosing_function(call)))
                    continue
            # 2. the same seed expression seeded earlier in this scope.
            for prev, pexpr in seeds[:i]:
                if ast.dump(pexpr) != ast.dump(expr) or mod.exclusive_branches(prev, call):
                    continue
                if not _same_kind(mod, prev, call):
                    continue
                if any(prev.lineno < ln <= call.lineno for ln in _bound_lines(scope, names)):
                    continue
                findings.append(Finding(
                    CHECK, mod.relpath, call.lineno, call.col_offset,
                    f"a second generator is seeded from `{ast.unparse(expr)}` (first at line "
                    f"{prev.lineno}) with no offset — the two streams are identical; offset "
                    "the seed (`seed + 1`) or draw both from one generator",
                    mod.enclosing_function(call)))
                break
    return findings


@register_check(
    CHECK,
    "a generator drawn inside a CUDA-graph capture without being registered with it, or "
    "two generators seeded alike (repeated randomness)",
)
def check_prng_reuse(mod: ModuleInfo) -> list[Finding]:
    return _capture_findings(mod) + _seed_findings(mod)
