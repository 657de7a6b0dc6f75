"""Distributed-protocol passes: collective-discipline, mailbox-protocol,
rank-affinity (the port's counterpart of
`actor_critic_tpu/analysis/distributed.py`).

- **collective-discipline**, the fleet-desync class. (a) A wrapper
  collective over the group of an axis no mesh declares
  (`psum(x, mesh.group("dq"))`): axis names are bare strings, and a typo
  raises only on the rank that reaches it. (b) A collective inside a
  branch keyed on a PROCESS-LOCAL value (rank, wall clock, pid, queue
  depth, the `RANK` variable) runs on some ranks and not others: the ranks
  that entered sit in the all-reduce forever (the stop vote of
  `train_multihost` exists to avoid this: the deadline rides INTO the
  collective instead of gating it). (c) A collective inside a `try` whose
  handler swallows the error diverges the collective ORDER: the rank that
  caught skips an exchange the rest of the fleet runs, and the fleet
  deadlocks one collective later.
- **mailbox-protocol**, the gossip mailbox's file discipline
  (`parallel/multihost.py`'s `write_params`/`read_params`). Producers must
  write, fsync, then rename: a direct write to the consumed path is torn
  under SIGKILL; a rename without fsync can publish a zero-length file
  after a crash; a tmp name without a process-unique discriminator
  collides when two ranks share a mailbox directory. Consumers must
  tolerate torn files (for `.npz`, `zipfile.BadZipFile`/`EOFError`, which
  are not `OSError`s; for `torch.load`, `RuntimeError`/`EOFError`/
  `UnpicklingError`) and must keep peers' version clocks PER PEER (one
  newest-seen scalar mutes every peer slower than the fastest).
- **rank-affinity**: shared-artifact paths written from a per-rank scope
  (a `rank` parameter, `get_rank()`, the `RANK` variable, a
  `--distributed` flag read) must carry the process identity, or every
  rank clobbers the same file: telemetry sessions, metrics jsonl,
  checkpoints.

All three are repo-scope: they consult the whole-repo `ProcessModel`
(`analysis/process_model.py`). The runtime companion,
`analysis/fleetsan.py`, exercises the same protocol under seeded
multi-process chaos.
"""

from __future__ import annotations

import ast
from typing import Optional

from actor_critic_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    register_check,
    walk,
)
from actor_critic_tpu_torch.analysis.process_model import (
    TORN_EXC_JSON,
    TORN_EXC_NPZ,
    TORN_EXC_PT,
    ProcessModel,
    rank_parameterized,
)

COLLECTIVE_DISCIPLINE = "collective-discipline"
MAILBOX_PROTOCOL = "mailbox-protocol"
RANK_AFFINITY = "rank-affinity"

# Shared-artifact sinks for rank-affinity (terminal callable names):
# each takes a directory/path its process will WRITE under.
_PATH_SINKS = {"TelemetrySession", "JsonlLogger", "Checkpointer"}

# Single-entry cache (the concurrency passes' `_SHARED` idiom): three
# registered checks, one ProcessModel derivation per lint run. The
# modules list is held strongly so the id()-keyed entry can never alias
# a collected ModuleInfo.
_SHARED: dict = {}


def _shared_model(modules: list[ModuleInfo]) -> ProcessModel:
    key = tuple(id(m) for m in modules)
    entry = _SHARED.get("entry")
    if entry is not None and entry[0] == key:
        return entry[1]
    model = ProcessModel(modules)
    _SHARED["entry"] = (key, model, list(modules))
    return model


def _branch_ancestors(mod: ModuleInfo, node: ast.AST):
    """(if/while ancestor, child-on-path) pairs between `node` and its
    nearest enclosing function def — branches OUTSIDE the def gate the
    definition, not the collective's execution."""
    child = node
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(anc, (ast.If, ast.While)):
            yield anc, child
        child = anc


def _nearest_function(mod: ModuleInfo, node: ast.AST) -> Optional[ast.AST]:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


# ---------------------------------------------------------------------------
# collective-discipline
# ---------------------------------------------------------------------------


@register_check(
    COLLECTIVE_DISCIPLINE,
    "axis names no mesh declares; collectives gated on process-local "
    "values (rank/wall-clock/queue depth) or inside exception-swallowing "
    "try blocks — both desync the fleet into a deadlock",
    scope="repo",
)
def check_collective_discipline(
    modules: list[ModuleInfo],
) -> list[Finding]:
    model = _shared_model(modules)
    findings: list[Finding] = []
    declared = model.axes.declared
    for mod in modules:
        taint_cache: dict[int, set[str]] = {}
        for site in model.collective_sites[mod.relpath]:
            node = site.node
            # (a) axis-name consistency, prim sites with a resolvable
            # constant axis only (parameterized axes are checked where
            # a constant is bound).
            if site.kind == "prim" and site.axis_arg is not None and declared:
                resolved = model.axes.resolve(mod, site.axis_arg)
                names = (
                    (resolved,) if isinstance(resolved, str)
                    else resolved if isinstance(resolved, tuple) else ()
                )
                for name in names:
                    if name not in declared:
                        findings.append(
                            Finding(
                                COLLECTIVE_DISCIPLINE, mod.relpath,
                                node.lineno, node.col_offset,
                                f"`{site.desc}` reduces over axis "
                                f"{name!r}, but no mesh in the scanned "
                                "tree declares that axis (declared: "
                                f"{sorted(declared)}) — axis names are "
                                "bare strings, so a typo raises only on "
                                "the rank that reaches it, mid-run; use "
                                "the shared *_AXIS constant",
                                mod.enclosing_function(node),
                            )
                        )
            # (b) process-local gating.
            fn = _nearest_function(mod, node)
            for branch, _child in _branch_ancestors(mod, node):
                if fn is None:
                    break
                if id(fn) not in taint_cache:
                    taint_cache[id(fn)] = model.process_local_names(mod, fn)
                if model.expr_process_local(
                    mod, branch.test, taint_cache[id(fn)]
                ):
                    kw = "if" if isinstance(branch, ast.If) else "while"
                    findings.append(
                        Finding(
                            COLLECTIVE_DISCIPLINE, mod.relpath,
                            node.lineno, node.col_offset,
                            f"collective `{site.desc}` sits inside a "
                            f"`{kw}` (line {branch.lineno}) keyed on a "
                            "process-local value (rank / wall clock / "
                            "pid / queue depth) — hosts whose predicate "
                            "differs skip the exchange and the rest of "
                            "the fleet deadlocks in it; hoist the "
                            "collective out, or make the decision "
                            "fleet-uniform first (all-reduce a vote, "
                            "as train_multihost's stop path does)",
                            mod.enclosing_function(node),
                        )
                    )
                    break
            # (c) order divergence through a swallowed exception.
            if site.kind in ("prim", "derived"):
                swallowing = _swallowing_try(
                    mod, node, model.collective_sites[mod.relpath]
                )
                if swallowing is not None:
                    findings.append(
                        Finding(
                            COLLECTIVE_DISCIPLINE, mod.relpath,
                            node.lineno, node.col_offset,
                            f"collective `{site.desc}` runs inside a "
                            "`try` whose handler (line "
                            f"{swallowing.lineno}) swallows the error — "
                            "the host that catches skips this exchange "
                            "while the rest of the fleet executes it, "
                            "diverging the collective order into a "
                            "deadlock one exchange later; re-raise (a "
                            "dead host must take its whole fleet slot "
                            "down), or move the fallible work out of "
                            "the collective region",
                            mod.enclosing_function(node),
                        )
                    )
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


def _swallowing_try(
    mod: ModuleInfo, node: ast.AST, sites
) -> Optional[ast.excepthandler]:
    """The first exception handler that would swallow an error raised
    at `node`: no `raise` in its body AND no collective of its own (a
    handler performing the equivalent exchange — mesh.axis_size's
    psum-fallback compat shim — keeps the fleet's collective count in
    step). Only `try` bodies between the node and its enclosing def
    count."""
    site_nodes = [s.node for s in sites]
    child = node
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        if isinstance(anc, ast.Try) and any(
            child is stmt or _in(stmt, child) for stmt in anc.body
        ):
            for handler in anc.handlers:
                if any(
                    isinstance(sub, ast.Raise)
                    for sub in walk(handler)
                ):
                    continue
                if any(_in(handler, sn) for sn in site_nodes):
                    continue
                return handler
        child = anc
    return None


def _in(root: ast.AST, target: ast.AST) -> bool:
    return any(sub is target for sub in walk(root))


# ---------------------------------------------------------------------------
# mailbox-protocol
# ---------------------------------------------------------------------------


@register_check(
    MAILBOX_PROTOCOL,
    "file-mailbox discipline: write→fsync→rename at producers "
    "(process-unique tmp names), torn-read tolerance and per-peer "
    "version clocks at consumers (the gossip exchange's crash contract)",
    scope="repo",
)
def check_mailbox_protocol(modules: list[ModuleInfo]) -> list[Finding]:
    model = _shared_model(modules)
    findings: list[Finding] = []
    for mod in modules:
        for site in model.producers[mod.relpath]:
            node = site.open_call
            ctx = mod.enclosing_function(node)
            if site.replace_call is not None:
                if not site.has_fsync:
                    findings.append(
                        Finding(
                            MAILBOX_PROTOCOL, mod.relpath,
                            node.lineno, node.col_offset,
                            "atomic publish without fsync: this scope "
                            "renames a written file into place (line "
                            f"{site.replace_call.lineno}) but never "
                            "fsyncs it first — after a crash the "
                            "rename can be durable while the data "
                            "blocks are not, publishing a zero-length/"
                            "partial file; `f.flush(); "
                            "os.fsync(f.fileno())` before the replace",
                            ctx,
                        )
                    )
                tmp_expr = (
                    site.replace_call.args[0]
                    if site.replace_call.args
                    else None
                )
                if tmp_expr is not None and not rank_parameterized(
                    mod, site.scope, tmp_expr
                ):
                    findings.append(
                        Finding(
                            MAILBOX_PROTOCOL, mod.relpath,
                            site.replace_call.lineno,
                            site.replace_call.col_offset,
                            "tempfile name carries no process-unique "
                            "discriminator — two ranks publishing into "
                            "a shared directory interleave their "
                            "writes into the same tmp file and rename "
                            "each other's torn payloads into place; "
                            "suffix the tmp with `os.getpid()` (or "
                            "rank/uuid) the way "
                            "`multihost.write_params` does",
                            mod.enclosing_function(site.replace_call),
                        )
                    )
            elif site.writes_builder_path:
                findings.append(
                    Finding(
                        MAILBOX_PROTOCOL, mod.relpath,
                        node.lineno, node.col_offset,
                        "non-atomic publish: this writes the CONSUMED "
                        "protocol path directly (a shared path-builder "
                        "names it), so a concurrent reader — or a "
                        "reader after a mid-write SIGKILL — sees a "
                        "torn file instead of the previous complete "
                        "snapshot; write a same-directory tmp and "
                        "`os.replace` it into place",
                        ctx,
                    )
                )
        for site in model.consumers[mod.relpath]:
            node = site.call
            if not _consumes_builder_path(mod, model, node):
                continue
            torn = {"npz": TORN_EXC_NPZ, "json": TORN_EXC_JSON,
                    "pt": TORN_EXC_PT}[site.kind]
            if site.handler_names is None:
                findings.append(
                    Finding(
                        MAILBOX_PROTOCOL, mod.relpath,
                        node.lineno, node.col_offset,
                        "unguarded parse of a shared snapshot file — a "
                        "torn/partial/absent file (crash mid-publish, "
                        "fs hiccup) raises out of the consume loop and "
                        "takes the poller down; wrap in try/except "
                        "returning None (the mailbox contract: torn "
                        "reads are retried next poll)",
                        mod.enclosing_function(node),
                    )
                )
            elif not (site.handler_names & torn):
                need = {
                    "npz": "zipfile.BadZipFile/EOFError",
                    "json": "json.JSONDecodeError",
                    "pt": "RuntimeError/EOFError/pickle.UnpicklingError",
                }[site.kind]
                findings.append(
                    Finding(
                        MAILBOX_PROTOCOL, mod.relpath,
                        node.lineno, node.col_offset,
                        "torn-read intolerance: the enclosing handler "
                        f"catches {sorted(site.handler_names)} but a "
                        f"truncated file raises {need}, which is none "
                        "of those — the poller thread dies on the "
                        "first torn snapshot instead of retrying",
                        mod.enclosing_function(node),
                    )
                )
        findings.extend(_monotonicity_findings(mod))
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


def _consumes_builder_path(
    mod: ModuleInfo, model: ProcessModel, call: ast.Call
) -> bool:
    """Whether the parse call's source is a shared-builder path: its
    first arg is (or is a name last assigned from) a path-builder call.
    Keeps the rule off np.load/json.load of private files."""
    from actor_critic_tpu_torch.analysis.process_model import _expr_from_builder

    if not call.args:
        return False
    builders: set[str] = set()
    for names in model.path_builders.values():
        builders |= names
    if not builders:
        return False
    if _expr_from_builder(mod, mod.scope_of(call), call.args[0], builders):
        return True
    # One hop through a module-level helper: `_load_snapshot(path)` parses
    # its parameter, and its callers hand it `params_file(...)`.
    fn = mod.scope_of(call)
    arg = call.args[0]
    if not isinstance(fn, ast.FunctionDef) or not isinstance(arg, ast.Name):
        return False
    params = [p.arg for p in fn.args.args]
    if arg.id not in params:
        return False
    index = params.index(arg.id)
    for site in walk(mod.tree):
        if (isinstance(site, ast.Call) and isinstance(site.func, ast.Name)
                and site.func.id == fn.name and index < len(site.args)
                and _expr_from_builder(mod, mod.scope_of(site), site.args[index], builders)):
            return True
    return False


def _numeric_const(expr: ast.AST) -> bool:
    """A numeric literal, including the `-1` spelling (a UnaryOp over
    a Constant, not a Constant)."""
    if isinstance(expr, ast.UnaryOp) and isinstance(
        expr.op, (ast.USub, ast.UAdd)
    ):
        expr = expr.operand
    return (
        isinstance(expr, ast.Constant)
        and isinstance(expr.value, (int, float))
        and not isinstance(expr.value, bool)
    )


def _monotonicity_findings(mod: ModuleInfo) -> list[Finding]:
    """Per-peer version clocks: in a scope that distinguishes peers
    (reads a `peer`-named value or calls a `*_peer` schedule), a
    version comparison against a plain scalar initialized from a
    constant is a GLOBAL newest-seen clock — it permanently mutes every
    peer slower than the fastest ever seen; the clock must be a per-peer
    mapping (`seen.get(peer, -1)`)."""
    findings: list[Finding] = []
    for fn in walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        has_peer = any(
            (isinstance(n, ast.Name) and n.id == "peer")
            or (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name)
                and n.func.id.endswith("_peer")
            )
            for n in walk(fn)
        )
        if not has_peer:
            continue
        scalar_inits = {
            name
            for stmt in walk(fn)
            if isinstance(stmt, ast.Assign)
            and _numeric_const(stmt.value)
            for tgt in stmt.targets
            if isinstance(tgt, ast.Name)
            for name in [tgt.id]
        }
        if not scalar_inits:
            continue
        for node in walk(fn):
            if not isinstance(node, ast.Compare):
                continue
            sides = [node.left, *node.comparators]
            version_side = any(
                isinstance(s, ast.Name) and "version" in s.id
                for s in sides
            )
            clock = next(
                (
                    s
                    for s in sides
                    if isinstance(s, ast.Name) and s.id in scalar_inits
                ),
                None,
            )
            if version_side and clock is not None:
                findings.append(
                    Finding(
                        MAILBOX_PROTOCOL, mod.relpath,
                        node.lineno, node.col_offset,
                        f"`{clock.id}` is a single scalar version "
                        "clock in a scope that consumes from multiple "
                        "peers — versions are per-peer consumption "
                        "counters and are NOT comparable across peers, "
                        "so one fast peer permanently mutes every "
                        "slower one (ring diffusion broken at "
                        "world>=3); track the newest seen PER RANK "
                        "(`seen: dict`, `seen.get(peer, -1)`)",
                        mod.enclosing_function(node),
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# rank-affinity
# ---------------------------------------------------------------------------


@register_check(
    RANK_AFFINITY,
    "shared artifact paths (telemetry/metrics/checkpoint/file writes) "
    "not parameterized by process identity in per-rank scopes — every "
    "host clobbers the same file",
    scope="repo",
)
def check_rank_affinity(modules: list[ModuleInfo]) -> list[Finding]:
    model = _shared_model(modules)
    findings: list[Finding] = []
    for mod in modules:
        scope_cache: dict[int, bool] = {}

        def is_distributed(scope: ast.AST) -> bool:
            if id(scope) not in scope_cache:
                scope_cache[id(scope)] = model.distributed_scope(mod, scope)
            return scope_cache[id(scope)]

        for node in walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name not in _PATH_SINKS:
                continue
            scope = mod.scope_of(node)
            if isinstance(scope, ast.Module) or not is_distributed(scope):
                continue
            path_expr = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg in ("directory", "dir", "path"):
                    path_expr = kw.value
            if path_expr is None:
                continue
            if rank_parameterized(mod, scope, path_expr):
                continue
            findings.append(
                Finding(
                    RANK_AFFINITY, mod.relpath,
                    node.lineno, node.col_offset,
                    f"`{name}(...)` writes a shared artifact from a "
                    "per-rank scope, but its path is not parameterized "
                    "by the process identity — every host of the fleet "
                    "appends/clobbers the SAME file (interleaved jsonl "
                    "lines, racing checkpoint commits); suffix the "
                    "path with the rank (`host<rank>/`, the "
                    "parallel.launch convention)",
                    mod.enclosing_function(node),
                )
            )
        # open-for-write producers in per-rank scopes ride the same rule.
        for site in model.producers[mod.relpath]:
            scope = site.scope
            if isinstance(scope, ast.Module) or not is_distributed(scope):
                continue
            if rank_parameterized(mod, scope, site.path_expr):
                continue
            node = site.open_call
            findings.append(
                Finding(
                    RANK_AFFINITY, mod.relpath,
                    node.lineno, node.col_offset,
                    "file written from a per-rank scope at a path no "
                    "process identity reaches — ranks sharing a "
                    "filesystem overwrite each other's bytes; fold the "
                    "rank (or pid) into the path",
                    mod.enclosing_function(node),
                )
            )
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings
