"""JAX env states → the port's, for the parity tests (`test_torch_envs.py`,
`test_torch_mixture.py`).

A JAX state is a batch (vmapped) NamedTuple of arrays with a PRNG key and
a scenario NamedTuple of P scalars per instance; the port's drops the key
and carries the scenario as one [E, P] tensor, columns in the scenario's
field order. Each leaf takes the dtype of the same leaf in a state the
port's env made itself."""

import numpy as np
import torch

from actor_critic_tpu_torch.envs.mixture import MixtureState


def to_port(js, like):
    """`js` (a JAX batch state) as a state of the type and dtypes of `like`
    (a state of the port's env of the same kind)."""
    if isinstance(like, MixtureState):
        return MixtureState(
            type_id=_leaf(js.type_id, like.type_id),
            members=tuple(to_port(j, p) for j, p in zip(js.members, like.members, strict=True)),
            weights=_leaf(js.weights, like.weights),
            stage=_leaf(js.stage, like.stage),
        )
    fields = {}
    for name, ref in zip(like._fields, like):
        value = getattr(js, name)
        if name == "scenario":
            value = np.stack([np.asarray(x) for x in value], axis=-1)
        fields[name] = _leaf(value, ref)
    return type(like)(**fields)


def _leaf(value, ref: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(ref.dtype)
