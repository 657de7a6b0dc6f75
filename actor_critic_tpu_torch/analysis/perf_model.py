"""Whole-repo performance model for the perf passes (the port's
counterpart of `actor_critic_tpu/analysis/perf_model.py`).

The port's performance contracts live in a few source regions, and this
model names them from `ast` alone:

- **Hot regions.** A module is hot when its basename is in
  `HOT_BASENAMES` (the step-loop owners: the host loop, PPO's host and
  async learners, the warm-up registry) or it carries a
  `# torchlint: hot-module` pragma. Within ANY module, `step_loops`
  resolves the loops that dispatch a program each iteration: a call of a
  name bound from a program factory (`update = ppo.make_async_update_step(
  ...)`) or a seam instance (`update = HostUpdate(...)`), a graph's
  `.replay()`, or `loop.eager_step(...)`. Their bodies are the steady
  state, where a crossing or a stray launch is paid per step, not once.
- **Captured bodies** (`capture_info.captured_defs`): code that runs inside
  one CUDA graph on the card; a launch there is part of the one replay, not
  a dispatch of its own.
- **Crossings** (`crossing_kind`): host↔device copies and syncs:
  `.item()`, `.cpu()`, `.numpy()`, `.tolist()`, `float()`/`int()`/`bool()`
  of a tensor, `torch.cuda.synchronize()`, an event's or a stream's
  `.synchronize()` (device→host: the host waits on the card), and
  `.cuda()`, `.to(<device>)`, `torch.tensor(..., device=)`,
  `torch.as_tensor(..., device=)` (host→device: bytes cross every
  iteration).
- **Eager launches** (`eager_device_call`): a `torch.*` /
  `torch.nn.functional.*` / `torch.linalg.*` math call, one kernel (or
  more) launched from Python per evaluation.

The runtime companion, `analysis/perfsan.py`, counts the same quantities
(dispatches, transfers, recompiles) on the real programs against
`perf_budgets.json`.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from actor_critic_tpu_torch.analysis.capture_info import captured_defs, program_bindings
from actor_critic_tpu_torch.analysis.core import ModuleInfo, walk

HOT_BASENAMES = {"host_loop.py", "ppo.py", "compile_cache.py"}

_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_HOST_MATH = {"len", "round", "abs", "min", "max", "sum"}

# Names of large recycled state: the buffers written in place.
BUFFER_NAME_RE = re.compile(r"(state|ring|replay|buffer|storage|learner|params|opt)", re.I)

_DEVICE_NAMESPACES = ("torch", "torch.nn.functional", "torch.linalg", "torch.special")
# torch attributes that launch nothing (or that transfer-discipline owns).
_NOT_LAUNCHES = {
    "tensor", "as_tensor", "asarray", "from_numpy", "no_grad", "inference_mode", "enable_grad",
    "set_grad_enabled", "device", "Generator", "manual_seed", "is_tensor", "get_default_dtype",
    "set_default_dtype", "finfo", "iinfo", "Size", "dtype", "autocast", "compile",
    "use_deterministic_algorithms", "set_num_threads", "get_num_threads", "load", "save",
    "is_floating_point", "is_grad_enabled", "broadcast_shapes", "promote_types",
    "result_type", "get_rng_state", "set_rng_state", "initial_seed", "seed",
}


def is_hot_module(mod: ModuleInfo) -> bool:
    return mod.relpath.rsplit("/", 1)[-1] in HOT_BASENAMES or mod.hot_module


def in_loop(mod: ModuleInfo, node: ast.AST) -> Optional[ast.AST]:
    """The innermost real loop ancestor (a comprehension alone runs once
    per call, not per step), or None."""
    for anc in mod.ancestors(node):
        if isinstance(anc, _LOOPS):
            return anc
    return None


def dispatched_program(mod: ModuleInfo, call: ast.Call, bindings: dict[str, str]
                       ) -> Optional[str]:
    """The program a call dispatches (a bound name, a graph's receiver, or
    "eager_step"), or None."""
    if isinstance(call.func, ast.Name) and call.func.id in bindings:
        return call.func.id
    if isinstance(call.func, ast.Attribute) and call.func.attr == "replay" and not call.args:
        return f"{ast.unparse(call.func.value)}.replay"
    if (mod.dotted(call.func) or "").endswith("eager_step"):
        return "eager_step"
    return None


class PerfModel:
    """Per-module step loops, captured bodies and per-scope bindings,
    computed once."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self._bindings: dict[int, dict[str, str]] = {}
        self.captured = {id(c.node) for c in captured_defs(mod)}
        self.loops = []
        for node in walk(mod.tree):
            if isinstance(node, _LOOPS):
                bindings = self.bindings(node)
                if any(isinstance(sub, ast.Call) and dispatched_program(mod, sub, bindings)
                       for sub in walk(node)):
                    self.loops.append(node)
        self._loop_ids = {id(lp) for lp in self.loops}

    def bindings(self, node: ast.AST) -> dict[str, str]:
        scope = self.mod.scope_of(node)
        if id(scope) not in self._bindings:
            self._bindings[id(scope)] = program_bindings(self.mod, scope)
        return self._bindings[id(scope)]

    def in_step_loop(self, node: ast.AST) -> bool:
        return any(id(anc) in self._loop_ids for anc in self.mod.ancestors(node))

    def inside_capture(self, node: ast.AST) -> bool:
        return id(node) in self.captured or any(
            id(anc) in self.captured for anc in self.mod.ancestors(node))


def _device_like(mod: ModuleInfo, expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":")[0] in ("cuda", "cpu")
    if isinstance(expr, ast.Call):
        return mod.dotted(expr.func) == "torch.device"
    name = expr.attr if isinstance(expr, ast.Attribute) else (
        expr.id if isinstance(expr, ast.Name) else "")
    return "device" in name.lower() or name in ("dev", "cuda", "cpu")


def crossing_kind(mod: ModuleInfo, call: ast.Call) -> Optional[tuple[str, str]]:
    """(description, direction) of the host↔device crossing `call` makes,
    or None. "d2h": the host waits on the card; "h2d": bytes cross."""
    dotted = mod.dotted(call.func) or ""
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in ("item", "cpu", "numpy", "tolist") and not call.args:
            return f"`.{attr}()`", "d2h"
        if attr == "synchronize" and dotted != "torch.cuda.synchronize":
            return "`.synchronize()`", "d2h"
        if attr == "cuda":
            return "`.cuda()`", "h2d"
        if attr == "to" and (
                (call.args and _device_like(mod, call.args[0]))
                or any(k.arg == "device" for k in call.keywords)):
            return "`.to(<device>)`", "h2d"
    if dotted == "torch.cuda.synchronize":
        return "`torch.cuda.synchronize()`", "d2h"
    if dotted in ("torch.tensor", "torch.as_tensor", "torch.asarray") and any(
            k.arg == "device" for k in call.keywords):
        return f"`{dotted}(..., device=)`", "h2d"
    if dotted in ("float", "int", "bool") and call.args:
        arg = call.args[0]
        if isinstance(arg, (ast.Constant, ast.JoinedStr)):
            return None
        if isinstance(arg, ast.Call):
            inner = mod.dotted(arg.func) or ""
            if inner.startswith(("numpy.", "math.", "os.", "time.")) or inner in _HOST_MATH:
                return None
        return f"`{dotted}()`", "d2h"
    return None


def eager_device_call(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    """`torch.<op>` when `call` launches device math eagerly, else None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    base = mod.dotted(call.func.value)
    if base not in _DEVICE_NAMESPACES or call.func.attr in _NOT_LAUNCHES:
        return None
    if call.func.attr[:1].isupper():
        return None  # a class (torch.Generator, torch.Size, ...)
    return f"{base}.{call.func.attr}"
