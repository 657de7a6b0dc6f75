"""Multi-policy residency and hot swap for the serving gateway (counterpart
of `actor_critic_tpu/serving/policy_store.py`).

Several policies stay resident keyed by policy id; each is held as an
immutable `PolicyHandle` (id, version, prepared params, engine). A swap
builds a NEW handle and replaces the dict entry at once: in-flight
requests that already resolved the old handle act on the old params until
their flush completes, so a swap never drops or tears a request. Params
are prepared at install time by the engine (`prepare_params`: on the
device backend an upload into tensors of the version's own, which no
later swap writes).

Params-only checkpoints (`export_policy_params`, `restore_policy_params`)
go through the port's `utils/checkpoint.Checkpointer`: one tensor per
leaf of the flax-layout tree, by its dotted path.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from actor_critic_tpu_torch.utils import numguard


class UnknownPolicy(KeyError):
    """Request named a policy id that is not resident."""


@dataclasses.dataclass(frozen=True)
class PolicyHandle:
    """One resident policy version. Immutable: a swap installs a new handle;
    holders of the old one keep a consistent (params, version) pair for as
    long as they need it."""

    policy_id: str
    version: int
    params: Any
    engine: Any  # PolicyEngine (or a duck-typed stub in tests)
    # SLO class target (ms): requests answered slower count against the
    # policy's error budget in the burn-rate gauge. None = no SLO class.
    # Rides the handle, so a hot swap keeps the class.
    slo_ms: Optional[float] = None
    # Per-policy micro-batch window (µs): a latency-tier policy trades
    # occupancy for a shorter hold, a batch-tier one the reverse. None =
    # the batcher's global max_wait_us. Rides the handle like slo_ms.
    max_wait_us: Optional[float] = None


class PolicyStore:
    """Thread-safe policy_id -> PolicyHandle map with a default route."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handles: dict[str, PolicyHandle] = {}
        self._default: Optional[str] = None

    def register(
        self,
        policy_id: str,
        engine,
        params,
        version: int = 0,
        default: bool = False,
        prepare: bool = True,
        slo_ms: Optional[float] = None,
        max_wait_us: Optional[float] = None,
    ) -> PolicyHandle:
        """Install a new resident policy. The FIRST registration becomes the
        default route unless a later one claims `default=True`. `slo_ms`
        assigns the policy's SLO latency class; `max_wait_us` overrides the
        batcher's global window for this policy's flushes."""
        prepared = engine.prepare_params(params) if prepare else params
        handle = PolicyHandle(
            str(policy_id), int(version), prepared, engine,
            slo_ms=None if slo_ms is None else float(slo_ms),
            max_wait_us=None if max_wait_us is None else float(max_wait_us),
        )
        with self._lock:
            if handle.policy_id in self._handles:
                raise ValueError(f"policy {handle.policy_id!r} already registered — use swap() "
                                 "to replace its params")
            self._handles[handle.policy_id] = handle
            if default or self._default is None:
                self._default = handle.policy_id
        return handle

    def swap(
        self,
        policy_id: str,
        params,
        version: Optional[int] = None,
        prepare: bool = True,
    ) -> PolicyHandle:
        """Hot-swap a resident policy's params (default: bump its version by
        one). Preparation (the device upload) runs OUTSIDE the lock, then
        the handle is replaced at once.

        Non-finite params refuse to install (`NonFiniteError`): the previous
        handle stays resident, and requests keep acting on the last good
        version. The gate runs after the handle's resolution, so an unknown
        id still surfaces as UnknownPolicy (a 404)."""
        old = self.get(policy_id)
        numguard.check_finite(params, "policy swap", name="params")
        prepared = old.engine.prepare_params(params) if prepare else params
        with self._lock:
            # Re-read under the lock: concurrent swaps version off the
            # latest install, not this caller's possibly stale read.
            cur = self._handles[old.policy_id]
            new_version = cur.version + 1 if version is None else int(version)
            handle = PolicyHandle(
                cur.policy_id, new_version, prepared, cur.engine,
                slo_ms=cur.slo_ms, max_wait_us=cur.max_wait_us,
            )
            self._handles[cur.policy_id] = handle
        return handle

    def swap_from_checkpoint(
        self, policy_id: str, ckpt_dir: str, step: Optional[int] = None
    ) -> PolicyHandle:
        """Restore a params-only checkpoint and hot-swap it in, with the
        CURRENT resident params as the restore template (the same
        architecture by construction)."""
        cur = self.get(policy_id)
        params = restore_policy_params(ckpt_dir, cur.params, step)
        return self.swap(policy_id, params)

    def get(self, policy_id: Optional[str] = None) -> PolicyHandle:
        """Resolve a handle (None -> the default route)."""
        with self._lock:
            pid = self._default if policy_id is None else str(policy_id)
            if pid is None or pid not in self._handles:
                raise UnknownPolicy(
                    f"no resident policy {policy_id!r} (resident: {sorted(self._handles)})")
            return self._handles[pid]

    @property
    def default_id(self) -> Optional[str]:
        with self._lock:
            return self._default

    def ids(self) -> dict[str, int]:
        """{policy_id: current version} of every resident policy."""
        with self._lock:
            return {pid: h.version for pid, h in self._handles.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._handles)


# -- params-only checkpoints -------------------------------------------------


@dataclasses.dataclass
class _ParamsCheckpoint:
    """What a params-only checkpoint holds: every leaf of the tree as a
    tensor by dotted path (the checkpoint's `params.<path>` entries), and a
    generator, which a Checkpointer always saves and nothing here reads."""

    generator: torch.Generator
    params: dict[str, torch.Tensor]


def _flat_leaves(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        *parts, last = path.split(".")
        node = out
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def export_policy_params(ckpt_dir: str, params, step: int = 0) -> None:
    """Write a params-only checkpoint of a flax-layout tree that a serving
    process can load (`python -m actor_critic_tpu_torch.serve --policy
    id=DIR`, or the gateway's /v1/swap). A non-finite tree is refused."""
    from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    tensors = {k: torch.from_numpy(np.array(v)) for k, v in _flat_leaves(params).items()}
    Checkpointer(ckpt_dir, max_to_keep=2).save(
        step, _ParamsCheckpoint(torch.Generator(), tensors))


def restore_policy_params(ckpt_dir: str, template, step: Optional[int] = None) -> dict:
    """Restore a params-only checkpoint into `template`'s structure (its
    leaves' paths, shapes and dtypes), as a numpy tree. Raises
    FileNotFoundError when the directory holds no checkpoint."""
    from actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint directory {ckpt_dir!r}")
    flat = _flat_leaves(template)
    state = _ParamsCheckpoint(torch.Generator(),
                              {k: torch.from_numpy(np.array(v)) for k, v in flat.items()})
    Checkpointer(ckpt_dir).restore(state, step)
    return _unflatten({k: t.numpy() for k, t in state.params.items()})
