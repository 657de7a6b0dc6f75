"""Parameter conversion between the JAX package's flax trees and the port.

A flax `Dense` keeps `kernel [in, out]` and `bias [out]` under its module
path; the port's `nn.Linear` keeps `weight [out, in]` and `bias [out]`
under the same path with dots (`torso/dense_0` → `torso.dense_0`). A flax
`Conv` keeps `kernel [kh, kw, in, out]`; the port's `nn.Conv2d` keeps
`weight [out, in, kh, kw]`, which is `permute(3, 2, 0, 1)` of it (a plain
transpose would also swap kh and kw: invisible in the shapes of square
kernels, wrong in the values). A bare parameter such as
`ActorCriticGaussian`'s `log_std` keeps its name and values; the
off-policy nets map the same way (`torso`, `action`, `mean`, `log_std`, `q`,
`q1`/`q2`: SAC's `log_std` head is a Dense, so its leaves are `kernel` and
`bias`), and an optax `adam` state without a clip before it converts by
`adam_state_from_optax` as the clipped chain's does. Both sides are plain numpy / torch here,
so this module needs neither JAX nor the JAX package: the caller hands it
`jax.device_get(params)`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from actor_critic_tpu_torch.optim import AdamState, RMSPropState


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
    state_dict for `ActorCriticDiscrete` or `ActorCriticGaussian`."""
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    state = {}
    for path, arr in _flat(params_np).items():
        module, _, leaf = path.rpartition(".")
        if leaf == "kernel" and arr.ndim == 4:
            state[f"{module}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf == "kernel" and arr.ndim == 2:
            state[f"{module}.weight"] = torch.from_numpy(np.array(arr.T, order="C"))
        elif leaf in ("bias", "log_std"):
            state[path] = torch.from_numpy(np.array(arr))
        else:
            raise ValueError(f"unexpected flax leaf {path!r}")
    return state


def flax_tree(named: Mapping[str, Any]) -> dict[str, Any]:
    """Parameters by their port name (`named_parameters()` order and
    layout, numpy or tensors) as a flax tree of numpy arrays,
    `{"params": {<module path>: {"kernel", "bias"}, ...}}`: a Linear weight
    transposed to [in, out] and a Conv2d weight permuted to [kh, kw, in,
    out], C-contiguous float32, as flax stores them (the inverse of
    `from_flax`)."""
    tree: dict[str, Any] = {}
    for name, value in named.items():
        *path, leaf = name.split(".")
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if leaf == "weight":
            leaf = "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr, dtype=np.float32, order="C")
    return {"params": tree}


def to_flax(module: torch.nn.Module) -> dict[str, Any]:
    """`module`'s parameters as a flax tree (`flax_tree`)."""
    return flax_tree(dict(module.named_parameters()))


def _find_state(opt_state: Any, match) -> Any:
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if match(node):
            return node
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    return None


def adam_state_from_optax(opt_state: Any) -> AdamState:
    """The Adam moments and count of an optax `chain(clip_by_global_norm,
    adam)` state (numpy leaves) as the port's `AdamState`."""
    node = _find_state(opt_state, lambda n: all(hasattr(n, a) for a in ("mu", "nu", "count")))
    if node is None:
        raise ValueError("no Adam state (mu, nu, count) in the optax state")
    count = torch.tensor([int(np.asarray(node.count))], dtype=torch.int64)
    return AdamState(count=count, mu=from_flax(node.mu), nu=from_flax(node.nu))


def rmsprop_state_from_optax(opt_state: Any) -> RMSPropState:
    """The second-moment tree `nu` of an optax `chain(clip_by_global_norm,
    rmsprop)` state (numpy leaves) as the port's `RMSPropState`."""
    node = _find_state(opt_state, lambda n: hasattr(n, "nu") and not hasattr(n, "mu"))
    if node is None:
        raise ValueError("no RMSProp state (nu) in the optax state")
    return RMSPropState(nu=from_flax(node.nu))
