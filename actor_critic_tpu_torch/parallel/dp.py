"""Data parallelism of the fused trainers (counterpart of
`actor_critic_tpu/parallel/dp.py`).

The fused trainer keeps its env batch inside its state, so data
parallelism means laying the state out over the mesh's "dp" axis:

    net / optimizer state / counts / avg_return / schedule  → replicated  (P())
    rollout (env states + obs), ep_return / ep_length       → sharded     (P("dp"))
    the replay ring's storage                               → sharded     (P("dp"))
    generator                                               → per rank    (P("dp"))

JAX's one process holds every shard and `shard_map` runs the step on each;
here each rank holds its own shard (`distribute_state` cuts it from a state
built whole, from the same seed, on every rank) and runs the step built
with the dp group (`make_train_step(env, cfg, group=...)`), whose gradient,
metric and quantizer-stat collectives keep the replicated part equal on
every rank. The layouts (`train_state_specs`, ...) are dicts of the state's
fields, nested for the learner and the ring, with `PartitionSpec` leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from actor_critic_tpu_torch.parallel import mesh as mesh_lib
from actor_critic_tpu_torch.parallel.mesh import DP_AXIS, Mesh, PartitionSpec as P
from actor_critic_tpu_torch.tree import tree_leaves, tree_map


def train_state_specs() -> dict:
    """The layout of the on-policy `TrainState` under dp."""
    return {
        "net": P(),
        "opt_state": P(),
        "rollout": P(DP_AXIS),
        "generator": P(DP_AXIS),
        "ep_return": P(DP_AXIS),
        "ep_length": P(DP_AXIS),
        "avg_return": P(),
        "step_counter": P(),
        "schedule": P(),
    }


def impala_state_specs() -> dict:
    """The IMPALA state's layout: the on-policy one, with the actors' stale
    copy replicated beside the learner."""
    return dict(train_state_specs(), actor_net=P())


def replay_specs() -> dict:
    """The replay ring's layout under dp: the storage's leading (capacity)
    axis split over dp, so each rank owns a sub-ring of capacity/W fed by
    its own env shard and read by its own draws, with no collective on the
    ring. The cursor and count stay replicated (every rank inserts the same
    batch size against the same local capacity), and so do the
    quantizer's stats, which `replay.add_batch(..., group)` keeps equal by
    pmean-ing the batch mean and pmax-ing the absmax."""
    return {"storage": P(DP_AXIS), "insert_pos": P(), "size": P(), "quant": P()}


def _offpolicy_specs(learner: dict) -> dict:
    return {
        "learner": dict(learner, replay=replay_specs(), update_count=P()),
        "rollout": P(DP_AXIS),
        "generator": P(DP_AXIS),
        "env_steps": P(),
        "ep_return": P(DP_AXIS),
        "ep_length": P(DP_AXIS),
        "avg_return": P(),
        "step_counter": P(),
    }


def offpolicy_state_specs() -> dict:
    """The DDPG/TD3 fused state's layout under dp: nets, targets and
    optimizers replicated (gradients pmean'd each update), the ring per
    `replay_specs`, the env batch and episode accounting sharded, the
    generator per rank. `env_steps` counts a rank's own steps, so the
    warm-up gates each rank by its own collection; the update batch is
    W × batch_size in all."""
    return _offpolicy_specs({"actor": P(), "critic": P(), "target_actor": P(),
                             "target_critic": P(), "actor_opt": P(), "critic_opt": P()})


def sac_state_specs() -> dict:
    """The SAC fused state's layout (as `offpolicy_state_specs`; log α and
    its optimizer replicated)."""
    return _offpolicy_specs({"actor": P(), "critic": P(), "target_critic": P(),
                             "actor_opt": P(), "critic_opt": P(), "log_alpha": P(),
                             "alpha_opt": P()})


def _fields(obj: Any) -> list[str]:
    if dataclasses.is_dataclass(obj):
        return [f.name for f in dataclasses.fields(obj)]
    if hasattr(obj, "_fields"):
        return list(obj._fields)
    raise TypeError(f"a layout of fields given for a {type(obj).__name__}")


def _walk(specs: dict, state: Any, path: str = ""):
    """(path, spec, value) of every leaf of the layout over `state`, whose
    fields it must name, all of them."""
    names = _fields(state)
    if sorted(names) != sorted(specs):
        raise ValueError(f"layout {sorted(specs)} does not match {type(state).__name__}"
                         f"{' at ' + path if path else ''}: fields {sorted(names)}")
    for name in names:
        spec, value = specs[name], getattr(state, name)
        if isinstance(spec, dict):
            yield from _walk(spec, value, f"{path}.{name}" if path else name)
        else:
            yield f"{path}.{name}" if path else name, spec, value


def rank_seed(seed: int, index: int) -> int:
    """The seed of shard `index`'s generator, from the state's seed: the
    counterpart of `jax.random.split(key, W)[index]`."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def _replace(obj: Any, **changes: Any) -> Any:
    if not changes:
        return obj
    return dataclasses.replace(obj, **changes) if dataclasses.is_dataclass(obj) \
        else obj._replace(**changes)


def _place(specs: dict, state: Any, n: int, i: int) -> Any:
    changes = {}
    for name in _fields(state):
        spec, value = specs[name], getattr(state, name)
        if isinstance(spec, dict):
            new = _place(spec, value, n, i)
        elif spec == P():
            new = value
        elif isinstance(value, torch.Generator):
            value.manual_seed(rank_seed(value.initial_seed(), i))
            new = value
        else:
            new = tree_map(lambda x: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)].clone(),
                           value)
        if new is not value:
            changes[name] = new
    return _replace(state, **changes)


def distribute_state(state: Any, mesh: Mesh, specs: dict | None = None) -> Any:
    """This rank's share of a trainer state built whole (the same seed on
    every rank): each leaf under a `P("dp")` of `specs` cut to its slice of
    the leading axis (its own storage), which must divide by the dp size
    (the env batch, the episode accounting, the ring's capacity); the
    generator reseeded from its seed and this rank's dp index
    (`rank_seed`); the rest kept as it is. `specs` defaults to the
    on-policy layout; pass `impala_state_specs()` /
    `offpolicy_state_specs()` / `sac_state_specs()` for the others. The
    state given is consumed (its generator is reseeded in place)."""
    if specs is None:
        specs = train_state_specs()
    ndev = mesh.shape[DP_AXIS]
    for _, spec, value in _walk(specs, state):
        if spec == P(DP_AXIS) and not isinstance(value, torch.Generator):
            for leaf in tree_leaves(value):
                if leaf.dim() == 0 or leaf.shape[0] % ndev != 0:
                    raise ValueError(
                        f"dp-sharded leading axis {tuple(leaf.shape)[:1]} not divisible by "
                        f"dp={ndev} (num_envs and replay capacity must divide the mesh size)")
    return _place(specs, state, ndev, mesh.index(DP_AXIS))


def replicated_fingerprint(state: Any, specs: dict) -> torch.Tensor:
    """[2] float64: the sum and the sum of squares of every tensor the
    layout replicates (parameters, optimizer state, counts), on the
    state's device."""
    from actor_critic_tpu_torch.algos.common import named_carried

    total = None
    for path, spec, value in _walk(specs, state):
        if spec != P():
            continue
        for t in named_carried(value, path).values():
            x = t.detach().to(torch.float64)
            part = torch.stack([x.sum(), (x * x).sum()])
            total = part if total is None else total + part
    return total


def make_dp_train_step(
    train_step: Callable, mesh: Mesh, specs: dict | None = None
) -> Callable:
    """The dp step of a fused trainer: `train_step` must be built with the
    mesh's dp group (`make_train_step(env, cfg, group=mesh.group("dp"))`),
    which makes its gradient pmean the cross-rank all-reduce. Its first
    call checks that every rank holds the same replicated state (the
    layout's `P()` part: one all-reduce of a fingerprint's max and one of
    its min), so a rank built from another seed or restored from another
    checkpoint is refused before it trains; the calls after it are
    `train_step` itself, capturable as before. The step carries `group`
    and `mesh` (the fused loop captures a step with a group in
    "thread_local" mode)."""
    group = mesh.group(DP_AXIS)
    if getattr(train_step, "group", False) is not group:
        raise ValueError("make_dp_train_step: build the train step with group=mesh.group('dp')")
    if specs is None:
        specs = train_state_specs()
    checked = []

    def dp_step(state):
        if not checked:
            fp = replicated_fingerprint(state, specs)
            hi, lo = mesh_lib.pmax(fp, group), -mesh_lib.pmax(-fp, group)
            # torchlint: disable=tracer-leak (the first call only, which is always
            # eager: the fused loop's warm-up iterations run before any capture)
            if not torch.equal(hi, lo):
                # torchlint: disable=tracer-leak (the same first, eager call)
                raise ValueError("make_dp_train_step: the ranks' replicated state differs "
                                 f"(fingerprint max {hi.tolist()}, min {lo.tolist()})")
            checked.append(True)
        return train_step(state)

    dp_step.group = group
    dp_step.mesh = mesh
    return dp_step
