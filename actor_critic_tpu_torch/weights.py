"""Parameter conversion between the JAX package's flax trees and the port.

A flax `Dense` keeps `kernel [in, out]` and `bias [out]` under its module
path; the port's `nn.Linear` keeps `weight [out, in]` and `bias [out]`
under the same path with dots (`torso/dense_0` → `torso.dense_0`). Both
sides are plain numpy / torch here, so this module needs neither JAX nor
the JAX package: the caller hands it `jax.device_get(params)`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from actor_critic_tpu_torch.optim import AdamState


def _flat(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flat(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def from_flax(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax params (with or without the top-level "params" key) → a
    state_dict for `ActorCriticDiscrete`."""
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    state = {}
    for path, arr in _flat(params_np).items():
        module, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            state[f"{module}.weight"] = torch.from_numpy(np.array(arr.T, order="C"))
        elif leaf == "bias":
            state[f"{module}.bias"] = torch.from_numpy(np.array(arr))
        else:
            raise ValueError(f"unexpected flax leaf {path!r}")
    return state


def adam_state_from_optax(opt_state: Any) -> AdamState:
    """The Adam moments and count of an optax `chain(clip_by_global_norm,
    adam)` state (numpy leaves) as the port's `AdamState`."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu") and hasattr(node, "nu") and hasattr(node, "count"):
            return AdamState(
                count=int(np.asarray(node.count)),
                mu=from_flax(node.mu),
                nu=from_flax(node.nu),
            )
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("no Adam state (mu, nu, count) in the optax state")
