"""Multi-process training (counterpart of `actor_critic_tpu/parallel/`).

- `mesh.py`: process groups (`multihost_init`), the mesh of processes
  (`MeshConfig`, `make_mesh`, `make_process_mesh`, `PartitionSpec`) and the
  collective helpers the trainers take a `group` for (`pmean`, `psum`,
  `pmax`, `all_gather`, `pmean_tree`, the flat gradient all-reduce
  `FlatGradients`), each the identity without a group.
- `dp.py`: data parallelism of the fused trainers: the state layouts,
  `distribute_state` (this rank's shard) and `make_dp_train_step`.
- `seqpar.py`: sequence parallelism of the trajectory scans (GAE,
  discounted returns, V-trace) over a time-axis group, the local scans
  through the hand-written kernels; IMPALA's sp learner uses it.
- `multihost.py`: the multi-process actor-learner, sync (an all-reduce
  learner over NCCL, gloo on the CPU) or gossip (peer-to-peer parameter
  mixing through a filesystem mailbox), and the mailbox transport the
  serving fleet's policy syncer reads.
- `launch.py`: a local N-process launcher (`python -m
  actor_critic_tpu_torch.parallel.launch`).

On the card every group is NCCL's, on the CPU gloo's. The package imports
`mesh` and exports the names of `dp` and `seqpar` lazily (the ops and the
algorithms import `mesh`, and `seqpar` imports the ops); `multihost` is
imported by its users, since it imports the algorithms.
"""

import importlib

from actor_critic_tpu_torch.parallel.mesh import (
    DP_AXIS,
    MODEL_AXIS,
    FlatGradients,
    Mesh,
    MeshConfig,
    PartitionSpec,
    all_gather,
    make_mesh,
    make_process_mesh,
    multihost_init,
    pmax,
    pmean,
    pmean_tree,
    psum,
    world_group,
    world_size,
)

_LAZY = {
    **dict.fromkeys(("distribute_state", "impala_state_specs", "make_dp_train_step",
                     "offpolicy_state_specs", "replay_specs", "sac_state_specs",
                     "train_state_specs"), "dp"),
    **dict.fromkeys(("SP_AXIS", "make_seqpar_fn", "make_sp_mesh", "seqpar_discounted_returns",
                     "seqpar_gae", "seqpar_vtrace"), "seqpar"),
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "DP_AXIS",
    "MODEL_AXIS",
    "SP_AXIS",
    "FlatGradients",
    "Mesh",
    "MeshConfig",
    "PartitionSpec",
    "all_gather",
    "distribute_state",
    "impala_state_specs",
    "make_dp_train_step",
    "make_mesh",
    "make_process_mesh",
    "make_seqpar_fn",
    "make_sp_mesh",
    "multihost_init",
    "offpolicy_state_specs",
    "pmax",
    "pmean",
    "pmean_tree",
    "psum",
    "replay_specs",
    "sac_state_specs",
    "seqpar_discounted_returns",
    "seqpar_gae",
    "seqpar_vtrace",
    "train_state_specs",
    "world_group",
    "world_size",
]
