"""Numerics guards: finite-tree gates and NaN-safe JSON (counterpart of
`actor_critic_tpu/utils/numguard.py`).

One non-finite value defeats every durability mechanism the port has: a
checkpoint commits poisoned parameters that every resume inherits, a
published snapshot hands NaN to every actor, a gateway swap serves it to
clients, and `json.dumps(..., allow_nan=False)` raises on a metrics row.
This module is the port's one home of the two counter-measures:

- **Finite-tree gates** (`check_finite`, `nonfinite_leaves`,
  `nonfinite_paths`): a sweep over a tree's inexact leaves (numpy arrays,
  torch tensors on any device, Python floats) that names where the poison
  sits. The sinks call it at their commit point (`Checkpointer.save`,
  `PolicyPublisher.publish`, `PolicyStore.swap`), so a poisoned tree is
  refused before it becomes durable or visible and the previous good one
  stays in place. Integer and bool leaves are skipped without conversion;
  denormals and merely huge values pass (only NaN and ±inf are refused).
- **NaN-safe JSON** (`safe_json_row`): strict-JSON serialization that
  writes a non-finite float as `null` instead of raising, and reports each
  offending key once per process on stderr.

`nonfinite_leaves`, `check_finite` and `safe_json_row` give the JAX
module's output on the same numpy trees. `check_finite` is the one seam
every commit gate goes through (the publisher, the mailbox, the policy
store, the checkpoint), as in JAX: `analysis/numsan.py`'s reverted-guard
modes no-op this one attribute and every gate opens. `nonfinite_paths`
lists the poisoned leaves by dotted path (`params.w`).
"""

from __future__ import annotations

import json
import math
import sys
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch


class NonFiniteError(ValueError):
    """A finite-tree gate refused a tree carrying nan/±inf leaves."""


def _classify(v: float) -> str:
    if math.isnan(v):
        return "nan"
    return "inf" if v > 0 else "-inf"


def _leaves(tree, path: str, dotted: bool) -> Iterator[tuple[str, Any]]:
    """(path, leaf) for every leaf of a dict/list/tuple tree that may hold
    a float: JAX's paths (`name['k'][0].field`), or dotted ones."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            sub = (f"{path}.{k}" if path else str(k)) if dotted else f"{path}[{k!r}]"
            yield from _leaves(v, sub, dotted)
        return
    if isinstance(tree, (list, tuple)):
        fields = getattr(type(tree), "_fields", None)
        for i, v in enumerate(tree):
            if fields:
                sub = f"{path}.{fields[i]}"
            else:
                sub = (f"{path}.{i}" if path else str(i)) if dotted else f"{path}[{i}]"
            yield from _leaves(v, sub, dotted)
        return
    if isinstance(tree, (bool, int, str, bytes)) or tree is None:
        return
    yield path, tree


def _nonfinite(leaf) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(the leaf's values, flat, and the indices of the non-finite ones), or
    None where the leaf holds no inexact values or all are finite. A torch
    tensor is tested where it lives and copied to the host only when it is
    poisoned."""
    if isinstance(leaf, float):
        return None if math.isfinite(leaf) else (np.array([leaf]), np.array([0]))
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return None
        finite = torch.isfinite(leaf)
        if bool(finite.all()):
            return None
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat = t.reshape(-1).numpy()
        return flat, np.flatnonzero(~finite.cpu().reshape(-1).numpy())
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return None
    # Integer/bool leaves cannot be non-finite: skip them before
    # np.asarray; unclassifiable dtypes are skipped rather than crash the
    # commit the gate protects.
    try:
        if not np.issubdtype(np.dtype(dtype), np.inexact):
            return None
        arr = np.asarray(leaf)
        finite = np.isfinite(arr)
    except TypeError:
        return None
    if bool(np.all(finite)):
        return None
    return arr.reshape(-1), np.flatnonzero(~finite.reshape(-1))


def nonfinite_leaves(tree, name: str = "tree") -> list[tuple[str, str]]:
    """[(path, 'nan'|'inf'|'-inf'), ...] for every non-finite element of the
    tree's float leaves (the first three positions per leaf, then one
    `... N more` entry), JAX's paths and order."""
    out: list[tuple[str, str]] = []
    for path, leaf in _leaves(tree, name, dotted=False):
        found = _nonfinite(leaf)
        if found is None:
            continue
        flat, bad = found
        if isinstance(leaf, float):
            out.append((path, _classify(leaf)))
            continue
        # The first few positions localize the poison; the full index list
        # of a poisoned replay ring would be spam.
        for idx in bad[:3]:
            out.append((f"{path}[{int(idx)}]", _classify(float(flat[idx]))))
        if bad.size > 3:
            out.append((path, f"... {int(bad.size) - 3} more"))
    return out


def nonfinite_paths(tree, name: str = "") -> list[str]:
    """The dotted paths (`params.w`, `members.1.theta`) of the leaves that
    hold a nan or an inf, in tree order; with `name=""` a flat dict's paths
    are its keys."""
    return [path for path, leaf in _leaves(tree, name, dotted=True)
            if _nonfinite(leaf) is not None]


def check_finite(tree, what: str, name: str = "tree") -> None:
    """The commit-point gate: raise `NonFiniteError` naming the poisoned
    leaves when `tree` carries nan/±inf, else return silently. `what` names
    the refusing sink ("policy swap", ...)."""
    bad = nonfinite_leaves(tree, name)
    if bad:
        detail = ", ".join(f"{p}: {k}" for p, k in bad[:6])
        raise NonFiniteError(
            f"{what} refused: non-finite values at {detail} — a "
            "nan/inf tree must never become durable or visible to "
            "peers/clients (fix the producer; see scripts/numsan.py "
            "for the guard contract)"
        )


# Keys already reported this process (once-per-key stderr contract),
# mutated under the lock: metrics writers may call from several threads.
_reported: set[str] = set()
_reported_lock = threading.Lock()


def _scrub(value, key: str, bad: list):
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, str)):
        return value
    if isinstance(value, float):
        if math.isfinite(value):
            return value
        bad.append(key)
        return None
    if isinstance(value, dict):
        return {k: _scrub(v, f"{key}.{k}" if key else str(k), bad)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_scrub(v, key, bad) for v in value]
    if isinstance(value, np.floating):
        f = float(value)
        if math.isfinite(f):
            return f
        bad.append(key)
        return None
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            return _scrub(value.item(), key, bad)
        return _scrub(value.tolist(), key, bad)
    if isinstance(value, torch.Tensor):
        return _scrub(value.detach().cpu().numpy(), key, bad)
    return value  # json.dumps's `default` (or the str fallback) handles it


def safe_json_row(row: dict, default=None) -> str:
    """One strict-JSON line for a metrics row: non-finite floats (Python,
    numpy or in a tensor, nested) become `null` and the offending key is
    reported once per process on stderr; the row itself always
    serializes."""
    bad: list[str] = []
    clean = _scrub(row, "", bad)
    if bad:
        with _reported_lock:
            fresh = [k for k in bad if k not in _reported]
            _reported.update(fresh)
        for k in fresh:
            print(
                f"[numguard] non-finite value under key {k!r} written as "
                "null (reported once per key; fix the producer)",
                file=sys.stderr,
            )
    try:
        return json.dumps(clean, allow_nan=False, default=default)
    except TypeError:
        # A foreign leaf (a set, a dataclass) with no `default` supplied:
        # stringify rather than crash the writer.
        return json.dumps(clean, allow_nan=False, default=str)
